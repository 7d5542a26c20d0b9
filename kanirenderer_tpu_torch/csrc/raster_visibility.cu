// K3: visibility raster of the main view (triangle id, depth, barycentrics).
//
// Replaces kanirenderer_tpu/ops/raster_pallas.py:410-587 (`_raster_kernel`
// with depth_only=False, launched by `_run`, :603-699, from `rasterize`,
// :739-756), with and without its wireframe coverage (:491-518).  Per
// pixel it writes the winner of a (z, global triangle id) tournament over
// the tile's chunks in ascending id with a strict `<` (the lower id keeps
// a depth tie), starting from the cleared depth 1.0, and the winner's
// barycentrics (l1/lsum, l2/lsum) with l_t = (a*X + c) + b*Y, the phase-1
// plane values, and lsum = (l0 + l1) + l2, 0 -> 1e-30 (:557-566).
// Background: tri = -1, z = 1, bary = 0 (:432-436).
//
// What bounds it on this card: as K2's phase 1 (raster_pixels.cu) — chunk
// staging latency on sparse tiles, FP32 plane evaluation on dense ones;
// its output is 16 bytes per pixel (33 MB at 1920x1080).
//
// Design: K2's phase 1 unchanged, one block per 16x16 tile, one thread per
// pixel, planes staged in shared memory with a ballot mask of the
// triangles whose bbox meets the tile.  The tournament keeps only (z, id)
// in registers; the winner's three edge planes are evaluated once more at
// the end from its setup row, which gives the same bits as keeping them
// from the tournament and spares three live registers per pixel.

#include "raster_common.cuh"

namespace {

template <bool kWire>
__global__ void raster_visibility_kernel(
    const float* __restrict__ setup, const float4* __restrict__ bbox,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const int* __restrict__ chunk, int* __restrict__ tri_out,
    float* __restrict__ z_out, float2* __restrict__ bary_out, int width,
    int height, int tiles_x, int tile_w, int tile_h, float wire_thresh) {
  __shared__ kani::ChunkStage s;
  const int tile = blockIdx.x;
  const int tx0 = (tile % tiles_x) * tile_w;
  const int ty0 = (tile / tiles_x) * tile_h;
  const int px = tx0 + threadIdx.x % tile_w;
  const int py = ty0 + threadIdx.x / tile_w;
  const float X = (float)px + 0.5f;
  const float Y = (float)py + 0.5f;

  const int first = tile_start[tile];
  const int n = tile_count[tile];
  float best_z = 1.0f;
  int best = -1;
  for (int i = 0; i < n; ++i) {
    const int cid = chunk[first + i];
    __syncthreads();
    kani::stage_chunk(&s, setup, 16, bbox, cid, (float)tx0,
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

  const size_t p = (size_t)py * width + px;
  tri_out[p] = best;
  z_out[p] = best_z;
  if (best < 0) {
    bary_out[p] = make_float2(0.f, 0.f);
    return;
  }
  const float* r = setup + (size_t)best * 16;
  const float l0 = kani::plane(r[0], r[1], r[2], X, Y);
  const float l1 = kani::plane(r[3], r[4], r[5], X, Y);
  const float l2 = kani::plane(r[6], r[7], r[8], X, Y);
  const float lsum = __fadd_rn(__fadd_rn(l0, l1), l2);
  const float lsafe = lsum != 0.f ? lsum : 1e-30f;
  bary_out[p] = make_float2(__fdiv_rn(l1, lsafe), __fdiv_rn(l2, lsafe));
}

template <bool kWire>
int launch(const float* setup, const float* bbox, const int* tile_start,
           const int* tile_count, const int* chunk, int* tri_out,
           float* z_out, float* bary_out, int width, int height, int tiles_x,
           int num_tiles, int tile_w, int tile_h, float wire_thresh,
           void* stream) {
  if (num_tiles > 0) {
    raster_visibility_kernel<kWire><<<num_tiles, tile_w * tile_h, 0,
                                      (cudaStream_t)stream>>>(
        setup, reinterpret_cast<const float4*>(bbox), tile_start, tile_count,
        chunk, tri_out, z_out, reinterpret_cast<float2*>(bary_out), width,
        height, tiles_x, tile_w, tile_h, wire_thresh);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kani_rasterize_visibility(
    const float* setup, const float* bbox, const int* tile_start,
    const int* tile_count, const int* chunk, int* tri_out, float* z_out,
    float* bary_out, int width, int height, int tiles_x, int num_tiles,
    int tile_w, int tile_h, int wireframe, float wire_thresh, void* stream) {
  return wireframe
             ? launch<true>(setup, bbox, tile_start, tile_count, chunk,
                            tri_out, z_out, bary_out, width, height, tiles_x,
                            num_tiles, tile_w, tile_h, wire_thresh, stream)
             : launch<false>(setup, bbox, tile_start, tile_count, chunk,
                             tri_out, z_out, bary_out, width, height,
                             tiles_x, num_tiles, tile_w, tile_h, wire_thresh,
                             stream);
}
