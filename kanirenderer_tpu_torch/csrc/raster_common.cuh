// Shared pieces of the tile raster kernels (raster_depth.cu,
// raster_pixels.cu, raster_visibility.cu).
//
// One CUDA block rasterizes one screen tile of tile_w x tile_h pixels with
// one thread per pixel.  The block walks the tile's chunk list (ascending
// chunk id, from ops/binning.bin_tiles); for each chunk it stages the 128
// triangles' edge and depth planes in shared memory and builds a 128-bit
// mask of the triangles whose pixel bbox overlaps the tile, so every thread
// of the block visits exactly the same triangles (no divergence).
//
// Floating-point order: a plane is evaluated as (a*X + c) + b*Y in round-to-
// nearest with no fused multiply-add, the order of the reference Pallas
// kernel (raster_pallas.py:488-506) and of the plain PyTorch versions in
// ops/raster_cuda.py, so kernel and plain version agree bit for bit.  The
// library is also built with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kani {

constexpr int kChunk = 128;        // triangles per chunk (CHUNK_SIZE)
constexpr int kMaskWords = kChunk / 32;

__device__ __forceinline__ float plane(float a, float b, float c, float X,
                                       float Y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, X), c), __fmul_rn(b, Y));
}

// Setup lanes 0:12 of one triangle as three float4:
//   p0 = (e0.a, e0.b, e0.c, e1.a)  p1 = (e1.b, e1.c, e2.a, e2.b)
//   p2 = (e2.c, z.a, z.b, z.c)
struct Planes {
  float4 p0, p1, p2;
};

// Coverage of pixel centre (X, Y): all three edges and the depth clip
// z in [0, 1], as in raster_xla.rasterize_xla.  Comparisons are false for
// NaN, so a NaN plane covers nothing.  Returns the depth through *z.
__device__ __forceinline__ bool covers(const Planes& t, float X, float Y,
                                       float* z) {
  const float l0 = plane(t.p0.x, t.p0.y, t.p0.z, X, Y);
  const float l1 = plane(t.p0.w, t.p1.x, t.p1.y, X, Y);
  const float l2 = plane(t.p1.z, t.p1.w, t.p2.x, X, Y);
  const float zz = plane(t.p2.y, t.p2.z, t.p2.w, X, Y);
  *z = zz;
  return l0 >= 0.f && l1 >= 0.f && l2 >= 0.f && zz >= 0.f &&
         __fsub_rn(1.f, zz) >= 0.f;
}

// Distance of pixel centre (X, Y) to edge (a, b, c) in pixels, in the
// order of the reference's wireframe coverage (raster_pallas.py:491-518):
// d = (a*X + c)*g + (b*Y)*g with g = 1/sqrt(a^2 + b^2 + 1e-30).  g is
// 1/sqrt in round-to-nearest (not the approximate rsqrtf), which is what
// 1.0 / torch.sqrt computes on the card, so kernel and plain version agree
// bit for bit.
__device__ __forceinline__ float edge_dist(float a, float b, float c,
                                           float X, float Y) {
  const float n2 =
      __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), 1e-30f);
  const float g = __fdiv_rn(1.f, __fsqrt_rn(n2));
  return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(a, X), c), g),
                   __fmul_rn(__fmul_rn(b, Y), g));
}

// Wireframe coverage: the five-plane coverage of `covers` and a pixel
// centre within `thresh` pixels of the nearest of the three edges.
__device__ __forceinline__ bool covers_wire(const Planes& t, float X,
                                            float Y, float thresh,
                                            float* z) {
  if (!covers(t, X, Y, z)) return false;
  const float d0 = edge_dist(t.p0.x, t.p0.y, t.p0.z, X, Y);
  const float d1 = edge_dist(t.p0.w, t.p1.x, t.p1.y, X, Y);
  const float d2 = edge_dist(t.p1.z, t.p1.w, t.p2.x, X, Y);
  return fminf(fminf(d0, d1), d2) <= thresh;
}

// Coverage in either mode, chosen at compile time.
template <bool kWire>
__device__ __forceinline__ bool covers_mode(const Planes& t, float X,
                                            float Y, float thresh,
                                            float* z) {
  return kWire ? covers_wire(t, X, Y, thresh, z) : covers(t, X, Y, z);
}

struct ChunkStage {
  Planes tri[kChunk];
  uint32_t mask[kMaskWords];
};

// Stage chunk `cid`: planes of its 128 rows (row stride `stride` floats,
// a multiple of 4) and the overlap mask of their bboxes with the tile
// [tx0, tx1) x [ty0, ty1).  Needs blockDim.x >= 128, a multiple of 32.
// The caller brackets it with __syncthreads().
__device__ __forceinline__ void stage_chunk(ChunkStage* s, const float* rows,
                                            int stride, const float4* bbox,
                                            int cid, float tx0, float tx1,
                                            float ty0, float ty1) {
  const size_t row0 = (size_t)cid * kChunk;
  for (int j = threadIdx.x; j < kChunk * 3; j += blockDim.x) {
    const int r = j / 3, q = j - 3 * (j / 3);
    const float4 v =
        reinterpret_cast<const float4*>(rows + (row0 + r) * stride)[q];
    float4* dst = q == 0 ? &s->tri[r].p0 : (q == 1 ? &s->tri[r].p1
                                                    : &s->tri[r].p2);
    *dst = v;
  }
  if (threadIdx.x < kChunk) {
    const float4 b = bbox[row0 + threadIdx.x];
    const bool hit = b.x < tx1 && b.z > tx0 && b.y < ty1 && b.w > ty0;
    const uint32_t m = __ballot_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0) s->mask[threadIdx.x >> 5] = m;
  }
}

}  // namespace kani
