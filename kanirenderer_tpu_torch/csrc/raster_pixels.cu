// K2: fused visibility raster + varying interpolation of the main view.
//
// Replaces kanirenderer_tpu/ops/raster_pallas.py:759-1121 (`_fused_kernel`,
// launched by `_run_fused`, :1124-1197, from `rasterize_pixels`,
// :1218-1301), both variants: kWire = false is K2, kWire = true is K2w,
// the wireframe variant (coverage :831-858), which also requires the
// pixel centre within wire_thresh pixels of an edge (raster_common.cuh
// covers_wire).  Phase 2 is the same for both.
//
// Phase 1, per pixel: a (z, global triangle id) tournament over the tile's
// chunks in ascending id with a strict `<`, so the lower id keeps a depth
// tie, starting from the cleared depth 1.0.  Phase 2, per covered pixel:
// one load of the winner's 76-lane record (ops/interpolate.py layout),
// barycentrics w1 = l1/lsum, w2 = l2/lsum from the record's edge rows
// (lsum 0 -> 1e-30, raster_pallas.py:1077-1082), the 17 varyings
// v0 + d1*w1 + d2*w2 and the material lanes (blk_base = hi*65536 + lo).
// Uncovered pixels take the reference's defaults (:922-929).
//
// What bounds it on this card: phase 1 as in raster_depth.cu (chunk
// staging latency on sparse tiles, FP32 edge evaluation on dense ones);
// phase 2 reads 304 bytes per covered pixel, mostly from L2 since
// neighbouring pixels share winners, and writes 96 bytes per pixel
// (~200 MB per 1920x1080 frame).  K2w evaluates three more planes and
// three correctly rounded 1/sqrt per triangle and pixel, and runs without
// back-face culling upstream, so about twice the triangles reach it.
//
// Design: one block per tile, one thread per pixel, the tournament state
// in two registers.  The TPU kernel's winner-run compaction and lane-LUT
// record resolve (:938-1121) exist because a TPU core cannot gather per
// pixel from HBM; here phase 2 is a plain global load.  Evaluation order
// as in raster_common.cuh for phase 1 and ((a*X) + (b*Y)) + c for the
// phase-2 planes, as the reference's phase 2 and the plain version.

#include "raster_common.cuh"

namespace {

constexpr int kRecLanes = 76;  // ops/interpolate.FAT_LANES
constexpr int kUsed = 17;      // varying planes
constexpr int kRec0 = 16, kPar0 = 67, kLsum0 = 73;

__device__ __forceinline__ float plane_abc(float a, float b, float c,
                                           float X, float Y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, X), __fmul_rn(b, Y)), c);
}

template <bool kWire>
__global__ void raster_pixels_kernel(
    const float* __restrict__ records, const float4* __restrict__ bbox,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const int* __restrict__ chunk, float* __restrict__ z_out,
    float* __restrict__ vary_out, int* __restrict__ int_out, int width,
    int height, int tiles_x, int tile_w, int tile_h, float wire_thresh) {
  __shared__ kani::ChunkStage s;
  const int tile = blockIdx.x;
  const int tx0 = (tile % tiles_x) * tile_w;
  const int ty0 = (tile / tiles_x) * tile_h;
  const int px = tx0 + threadIdx.x % tile_w;
  const int py = ty0 + threadIdx.x / tile_w;
  const float X = (float)px + 0.5f;
  const float Y = (float)py + 0.5f;

  // ---- phase 1: visibility tournament ----
  const int first = tile_start[tile];
  const int n = tile_count[tile];
  float best_z = 1.0f;
  int best = -1;
  for (int i = 0; i < n; ++i) {
    const int cid = chunk[first + i];
    __syncthreads();
    kani::stage_chunk(&s, records, kRecLanes, bbox, cid, (float)tx0,
                      (float)(tx0 + tile_w), (float)ty0,
                      (float)(ty0 + tile_h));
    __syncthreads();
    for (int w = 0; w < kani::kMaskWords; ++w) {
      uint32_t m = s.mask[w];
      while (m) {
        const int r = w * 32 + __ffs(m) - 1;
        m &= m - 1;
        float z;
        if (kani::covers_mode<kWire>(s.tri[r], X, Y, wire_thresh, &z) &&
            z < best_z) {
          best_z = z;
          best = cid * kani::kChunk + r;
        }
      }
    }
  }
  if (px >= width || py >= height) return;

  // ---- phase 2: interpolate the winner's record ----
  const size_t hw = (size_t)width * height;
  const size_t p = (size_t)py * width + px;
  z_out[p] = best_z;
  if (best < 0) {
    for (int c = 0; c < kUsed; ++c) vary_out[c * hw + p] = 0.f;
    int_out[0 * hw + p] = 0;   // mat_id
    int_out[1 * hw + p] = 1;   // tex_w
    int_out[2 * hw + p] = 1;   // tex_h
    int_out[3 * hw + p] = 0;   // blk_base
    int_out[4 * hw + p] = 1;   // blk_w
    int_out[5 * hw + p] = -1;  // tid
    return;
  }
  float rec[kRecLanes];
  const float4* src =
      reinterpret_cast<const float4*>(records + (size_t)best * kRecLanes);
#pragma unroll
  for (int q = 0; q < kRecLanes / 4; ++q) {
    const float4 v = src[q];
    rec[4 * q + 0] = v.x;
    rec[4 * q + 1] = v.y;
    rec[4 * q + 2] = v.z;
    rec[4 * q + 3] = v.w;
  }
  const float l1 = plane_abc(rec[3], rec[4], rec[5], X, Y);
  const float l2 = plane_abc(rec[6], rec[7], rec[8], X, Y);
  const float lsum =
      plane_abc(rec[kLsum0], rec[kLsum0 + 1], rec[kLsum0 + 2], X, Y);
  const float lsafe = lsum != 0.f ? lsum : 1e-30f;
  const float w1 = __fdiv_rn(l1, lsafe);
  const float w2 = __fdiv_rn(l2, lsafe);
#pragma unroll
  for (int c = 0; c < kUsed; ++c) {
    const float v0 = rec[kRec0 + c];
    const float d1 = rec[kRec0 + kUsed + c];
    const float d2 = rec[kRec0 + 2 * kUsed + c];
    vary_out[c * hw + p] =
        __fadd_rn(__fadd_rn(v0, __fmul_rn(d1, w1)), __fmul_rn(d2, w2));
  }
  int_out[0 * hw + p] = (int)rec[kPar0];
  int_out[1 * hw + p] = (int)rec[kPar0 + 1];
  int_out[2 * hw + p] = (int)rec[kPar0 + 2];
  int_out[3 * hw + p] = (int)rec[kPar0 + 3] * 65536 + (int)rec[kPar0 + 4];
  int_out[4 * hw + p] = (int)rec[kPar0 + 5];
  int_out[5 * hw + p] = best;
}

template <bool kWire>
int launch(const float* records, const float* bbox, const int* tile_start,
           const int* tile_count, const int* chunk, float* z_out,
           float* vary_out, int* int_out, int width, int height, int tiles_x,
           int num_tiles, int tile_w, int tile_h, float wire_thresh,
           void* stream) {
  if (num_tiles > 0) {
    raster_pixels_kernel<kWire><<<num_tiles, tile_w * tile_h, 0,
                                  (cudaStream_t)stream>>>(
        records, reinterpret_cast<const float4*>(bbox), tile_start,
        tile_count, chunk, z_out, vary_out, int_out, width, height, tiles_x,
        tile_w, tile_h, wire_thresh);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kani_rasterize_pixels(const float* records, const float* bbox,
                                     const int* tile_start,
                                     const int* tile_count, const int* chunk,
                                     float* z_out, float* vary_out,
                                     int* int_out, int width, int height,
                                     int tiles_x, int num_tiles, int tile_w,
                                     int tile_h, void* stream) {
  return launch<false>(records, bbox, tile_start, tile_count, chunk, z_out,
                       vary_out, int_out, width, height, tiles_x, num_tiles,
                       tile_w, tile_h, 0.f, stream);
}

extern "C" int kani_rasterize_pixels_wireframe(
    const float* records, const float* bbox, const int* tile_start,
    const int* tile_count, const int* chunk, float* z_out, float* vary_out,
    int* int_out, int width, int height, int tiles_x, int num_tiles,
    int tile_w, int tile_h, float wire_thresh, void* stream) {
  return launch<true>(records, bbox, tile_start, tile_count, chunk, z_out,
                      vary_out, int_out, width, height, tiles_x, num_tiles,
                      tile_w, tile_h, wire_thresh, stream);
}
