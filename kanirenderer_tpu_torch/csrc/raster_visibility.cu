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
// What bounds it on this card: FP32 plane evaluation over the bbox hits
// behind a chain of dependent loads (tile -> chunk ids -> bboxes ->
// planes), as K2's phase 1 (raster_pixels.cu); its output is 16 bytes per
// pixel (33 MB at 1920x1080), a tenth of the time.
//
// Design: phase 1 is K2's, the same function (raster_common.cuh
// tile_tournament): one block per tile, one thread per pixel in 8 x 4
// patches per warp, bbox-first hit compaction, the hits' planes through the
// cp.async ring, the exact per-warp rejections, for wireframe the edge
// scales once per (warp, hit), and the occlusion skip (O1) where the bins
// carry bounds.  The tournament keeps only (z, id) in
// registers; the winner's three edge planes are evaluated once more at
// the end from its setup row (48 bytes per covered pixel, mostly from L2),
// which gives the same bits as keeping them from the tournament and spares
// three live registers per pixel.

#include "raster_common.cuh"

namespace {

// kMaxThreads and kMinBlocks set the register limit as in raster_pixels.cu:
// blocks of up to 256 threads run six to an SM, with or without wireframe
// and with or without the occlusion skip (kOcc) and its counters (kCount).
constexpr int kBlocks = 6;

template <bool kWire, bool kOcc, bool kCount, int kMaxThreads,
          int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    raster_visibility_kernel(
    const float* __restrict__ setup, const float4* __restrict__ bbox,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const int* __restrict__ chunk, int* __restrict__ tri_out,
    float* __restrict__ z_out, float2* __restrict__ bary_out, int width,
    int height, int tiles_x, int tile_w, int tile_h, float wire_thresh,
    const float* __restrict__ bound, int* __restrict__ counts) {
  __shared__ kani::TileStage<kOcc, kCount> s;
  const int tile = blockIdx.x;
  const int tx0 = (tile % tiles_x) * tile_w;
  const int ty0 = (tile / tiles_x) * tile_h;
  int lx, ly;
  kani::tile_pixel(tile_w, tile_h, &lx, &ly);
  const int px = tx0 + lx;
  const int py = ty0 + ly;
  const float X = (float)px + 0.5f;
  const float Y = (float)py + 0.5f;
  const kani::Rect rect = kani::warp_rect(px, py);

  float best_z = 1.0f;
  int best = -1;
  kani::tile_tournament<kWire, kOcc, kCount>(&s, setup, bbox,
                                     chunk + tile_start[tile],
                               tile_count[tile], tx0, ty0, tile_w, tile_h, X,
                               Y, rect, wire_thresh,
                               px < width && py < height, bound, counts,
                               &best_z, &best);
  if (px >= width || py >= height) return;

  const size_t p = (size_t)py * width + px;
  tri_out[p] = best;
  z_out[p] = best_z;
  if (best < 0) {
    bary_out[p] = make_float2(0.f, 0.f);
    return;
  }
  const float4* r = reinterpret_cast<const float4*>(setup + (size_t)best * 16);
  const float4 p0 = r[0], p1 = r[1], p2 = r[2];  // lanes 0:12
  const float l0 = kani::plane(p0.x, p0.y, p0.z, X, Y);
  const float l1 = kani::plane(p0.w, p1.x, p1.y, X, Y);
  const float l2 = kani::plane(p1.z, p1.w, p2.x, X, Y);
  const float lsum = __fadd_rn(__fadd_rn(l0, l1), l2);
  const float lsafe = lsum != 0.f ? lsum : 1e-30f;
  bary_out[p] = make_float2(__fdiv_rn(l1, lsafe), __fdiv_rn(l2, lsafe));
}

// The instantiation with (bound) or without the occlusion skip, with
// (counts) or without the counters.
template <bool kWire, int kMaxThreads, int kMinBlocks>
auto pick(const float* bound, const int* counts) {
  constexpr int T = kMaxThreads, B = kMinBlocks;
  return bound ? (counts ? raster_visibility_kernel<kWire, true, true, T, B>
                         : raster_visibility_kernel<kWire, true, false, T, B>)
               : (counts ? raster_visibility_kernel<kWire, false, true, T, B>
                         : raster_visibility_kernel<kWire, false, false, T, B>);
}

template <bool kWire>
int launch(const float* setup, const float* bbox, const int* tile_start,
           const int* tile_count, const int* chunk, int* tri_out,
           float* z_out, float* bary_out, int width, int height, int tiles_x,
           int num_tiles, int tile_w, int tile_h, float wire_thresh,
           const float* bound, int* counts, void* stream) {
  if (num_tiles > 0) {
    const int threads = tile_w * tile_h;
    auto kernel = threads <= 256 ? pick<kWire, 256, kBlocks>(bound, counts)
                                 : pick<kWire, 1024, 1>(bound, counts);
    kernel<<<num_tiles, threads, 0, (cudaStream_t)stream>>>(
        setup, reinterpret_cast<const float4*>(bbox), tile_start, tile_count,
        chunk, tri_out, z_out, reinterpret_cast<float2*>(bary_out), width,
        height, tiles_x, tile_w, tile_h, wire_thresh, bound, counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kani_rasterize_visibility(
    const float* setup, const float* bbox, const int* tile_start,
    const int* tile_count, const int* chunk, int* tri_out, float* z_out,
    float* bary_out, int width, int height, int tiles_x, int num_tiles,
    int tile_w, int tile_h, int wireframe, float wire_thresh,
    const float* bound, int* counts, void* stream) {
  return wireframe
             ? launch<true>(setup, bbox, tile_start, tile_count, chunk,
                            tri_out, z_out, bary_out, width, height, tiles_x,
                            num_tiles, tile_w, tile_h, wire_thresh, bound,
                            counts, stream)
             : launch<false>(setup, bbox, tile_start, tile_count, chunk,
                             tri_out, z_out, bary_out, width, height,
                             tiles_x, num_tiles, tile_w, tile_h, wire_thresh,
                             bound, counts, stream);
}
