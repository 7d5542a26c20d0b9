// K2: fused visibility raster + varying interpolation of the main view.
//
// Replaces kanirenderer_tpu/ops/raster_pallas.py:759-1121 (`_fused_kernel`,
// launched by `_run_fused`, :1124-1197, from `rasterize_pixels`,
// :1218-1301), both variants: kWire = false is K2, kWire = true is K2w,
// the wireframe variant (coverage :831-858), which also requires the
// pixel centre within wire_thresh pixels of an edge (raster_common.cuh
// covers_mode).  Phase 2 is the same for both.
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
// Row bands (B1: rasterize_pixels with band_h, y0 and y_stride,
// :1215-1301): the outputs hold band_h rows, and band row r is the global
// row y0 + (r / tile_h) * y_stride * tile_h + r % tile_h.  A contiguous band
// (y_stride 1) is binned on its own grid; an interleaved one (y_stride n,
// y0 = k * tile_h) takes tile rows k, k + n, ... of the full grid's bins.
// Planes, bbox cull and warp rectangles take global coordinates, only the
// stores take band rows, so a band's pixels are the full frame's bit for bit
// (the (z, id) tournament does not depend on the order of the chunks).  Band
// rows at or past `height` (the padding of an interleaved band) get the
// defaults.  The TPU kernel re-anchors the planes instead (c <- c + b*y0).
//
// What bounds it on this card: bytes.  The 23 planar outputs are 96 bytes
// per pixel (199 MB of the 281 MB a 1920x1080 frame has to move) and
// phase 2 reads 304 bytes of record per covered pixel, mostly from L2 since
// neighbouring pixels share winners.  Phase 1 is FP32 plane evaluation over
// the bbox hits (6 of a chunk's 128 triangles on average) behind a chain of
// dependent loads (tile -> chunk ids -> bboxes -> planes); it hides behind
// other blocks' phase 2 only if enough blocks are resident.  K2w evaluates
// three edge distances more per covered evaluation and runs without
// back-face culling upstream, so 1.75 times the bbox hits reach it.  Its
// winners are lines, so nearly every warp holds pixels with and without a
// winner: what the stores of such a warp cost decides K2w's phase 2.
//
// Design: one block per tile, one thread per pixel, the tournament state in
// two registers.  Phase 1 culls by bbox first: the warps test the bboxes of
// up to kRound chunks at a time and compact the hit ids into shared memory,
// then only the hits' planes are fetched, from the contiguous (T, 16) setup
// rows (not from the 304-byte records, where a 48-byte piece straddles
// sectors), with cp.async into a three-slot ring (raster_common.cuh), and
// each warp drops the hits whose edges exclude its 8 x 4 patch of the tile
// (an exact test, raster_common.cuh edge_max); K2w's warps also drop the
// hits whose three edges all stay farther than the threshold from the patch
// (exact too, edge_dist_min) and get each survivor's edge scales
// 1/sqrt(a^2 + b^2 + 1e-30) from the one lane that tested it, instead of
// three square roots and divisions per pixel.  The loop is
// raster_common.cuh tile_tournament, shared with K3, with the occlusion
// skip (O1, raster_pallas.py:178-276) where the bins carry bounds.
// Phase 2 consumes the record piecewise (edge rows, then four varyings at a
// time) under a register limit that keeps six blocks of 256 threads on an
// SM; held whole, the record's 76 lanes cost 80 registers and leave three.
// All lanes of a warp that holds a winner go through the same 24 stores,
// the lanes without one storing the defaults, so that a store fills whole
// sectors; with a path of its own for those lanes K2w took half as long
// again.
// The TPU kernel's winner-run compaction and lane-LUT record resolve
// (:938-1121) exist because a TPU core cannot gather per pixel
// from HBM; here phase 2 is a plain global load.  Evaluation order as in
// raster_common.cuh for phase 1 and ((a*X) + (b*Y)) + c for the phase-2
// planes, as the reference's phase 2 and the plain version; no FMA, hence
// no tensor cores (see raster_common.cuh).

#include "raster_common.cuh"

namespace {

constexpr int kRecLanes = 76;  // ops/interpolate.FAT_LANES
constexpr int kUsed = 17;      // varying planes
constexpr int kRec0 = 16, kPar0 = 67, kLsum0 = 73;

__device__ __forceinline__ float plane_abc(float a, float b, float c,
                                           float X, float Y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, X), __fmul_rn(b, Y)), c);
}

// kMaxThreads and kMinBlocks set the register limit: blocks of up to 256
// threads run kBlocks to an SM (six: 40 registers; five: 48, where K2w
// stops spilling), larger blocks take what they need.  kOcc: the
// occlusion skip, against `bound`; kCount: the occlusion counters, into
// `counts` (raster_common.cuh).  Each is a separate instantiation, so that
// the build with neither is the code without them.
constexpr int kBlocksK2 = 6, kBlocksK2w = 5;

template <bool kWire, bool kOcc, bool kCount, int kMaxThreads,
          int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    raster_pixels_kernel(
    const float* __restrict__ records, const float* __restrict__ setup,
    const float4* __restrict__ bbox, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const int* __restrict__ chunk,
    float* __restrict__ z_out, float* __restrict__ vary_out,
    int* __restrict__ int_out, int width, int height, int band_h, int y0,
    int y_stride, int tiles_x, int tile_w, int tile_h, float wire_thresh,
    const float* __restrict__ bound, int* __restrict__ counts) {
  __shared__ kani::TileStage<kOcc, kCount> s;
  const int tile = blockIdx.x;
  const int row = tile / tiles_x;  // the band's tile row
  const int tx0 = (tile % tiles_x) * tile_w;
  const int ty0 = y0 + row * y_stride * tile_h;  // its global first row
  int lx, ly;
  kani::tile_pixel(tile_w, tile_h, &lx, &ly);
  const int px = tx0 + lx;
  const int py = ty0 + ly;            // global row
  const int by = row * tile_h + ly;   // band row
  const float X = (float)px + 0.5f;
  const float Y = (float)py + 0.5f;
  const kani::Rect rect = kani::warp_rect(px, py);

  // ---- phase 1: visibility tournament over the bbox hits ----
  float best_z = 1.0f;
  int best = -1;
  const bool stored = px < width && py < height && by < band_h;
  kani::tile_tournament<kWire, kOcc, kCount>(&s, setup, bbox,
                                     chunk + tile_start[tile],
                               tile_count[tile], tx0, ty0, tile_w, tile_h, X,
                               Y, rect, wire_thresh, stored, bound, counts,
                               &best_z, &best);

  // ---- phase 2: interpolate the winner's record ----
  // A warp none of whose pixels has a winner writes the defaults.  In any
  // other warp every lane takes part in every store, so that each store
  // fills whole 32-byte sectors: a lane with no winner loads nothing and
  // stores the defaults.  (Two paths within a warp would write every sector
  // of the 23 planes twice, half filled each time.)
  if (py >= height) {  // padding rows of an interleaved band: empty
    best_z = 1.0f;
    best = -1;
  }
  const bool inside = px < width && by < band_h;
  const bool won = inside && best >= 0;
  const bool any_won = __any_sync(0xffffffffu, won);
  if (!inside) return;
  const size_t hw = (size_t)width * band_h;
  const size_t p = (size_t)by * width + px;
  z_out[p] = best_z;
  if (!any_won) {
    for (int c = 0; c < kUsed; ++c) vary_out[c * hw + p] = 0.f;
    int_out[0 * hw + p] = 0;   // mat_id
    int_out[1 * hw + p] = 1;   // tex_w
    int_out[2 * hw + p] = 1;   // tex_h
    int_out[3 * hw + p] = 0;   // blk_base
    int_out[4 * hw + p] = 1;   // blk_w
    int_out[5 * hw + p] = -1;  // tid
    return;
  }
  // The record as 19 float4: lanes 4q .. 4q+3 in rec(q).
  const float4* record = reinterpret_cast<const float4*>(
      records + (size_t)max(best, 0) * kRecLanes);
  auto rec = [&](int q) {
    return won ? record[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float w1, w2;
  {
    const float4 e0 = rec(0), e1 = rec(1), e2 = rec(2);  // lanes 0:12
    const float4 ls = rec(kLsum0 / 4);                   // lanes 72:76
    static_assert(kLsum0 % 4 == 1, "lsum row sits in lanes 73:76");
    const float l1 = plane_abc(e0.w, e1.x, e1.y, X, Y);
    const float l2 = plane_abc(e1.z, e1.w, e2.x, X, Y);
    const float lsum = plane_abc(ls.y, ls.z, ls.w, X, Y);
    const float lsafe = lsum != 0.f ? lsum : 1e-30f;
    w1 = __fdiv_rn(l1, lsafe);
    w2 = __fdiv_rn(l2, lsafe);
  }
  // Varying c: v0 in lane 16 + c, d1 in lane 33 + c, d2 in lane 50 + c.
  // Four at a time: v0 is one float4, d1 straddles two at offset 1, d2 two
  // at offset 2.
  static_assert(kRec0 == 16 && kUsed == 17, "the lane offsets below");
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    const float4 a = rec(4 + g);
    const float4 b0 = rec(8 + g), c0 = rec(12 + g);
    const float v0[4] = {a.x, a.y, a.z, a.w};
    float d1[4] = {b0.y, b0.z, b0.w, 0.f};
    float d2[4] = {c0.z, c0.w, 0.f, 0.f};
    if (g < 4) {
      const float4 b1 = rec(9 + g), c1 = rec(13 + g);
      d1[3] = b1.x;
      d2[2] = c1.x;
      d2[3] = c1.y;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * g + k;
      if (c < kUsed) {
        const float v = __fadd_rn(__fadd_rn(v0[k], __fmul_rn(d1[k], w1)),
                                  __fmul_rn(d2[k], w2));
        vary_out[c * hw + p] = won ? v : 0.f;
      }
    }
  }
  static_assert(kPar0 == 67, "the material lanes below");
  const float4 m0 = rec(16), m1 = rec(17), m2 = rec(18);  // lanes 64:76
  int_out[0 * hw + p] = won ? (int)m0.w : 0;               // lane 67
  int_out[1 * hw + p] = won ? (int)m1.x : 1;
  int_out[2 * hw + p] = won ? (int)m1.y : 1;
  int_out[3 * hw + p] = won ? (int)m1.z * 65536 + (int)m1.w : 0;
  int_out[4 * hw + p] = won ? (int)m2.x : 1;               // lane 72
  int_out[5 * hw + p] = best;
}

// The instantiation with (bound) or without the occlusion skip, with
// (counts) or without the counters.
template <bool kWire, int kMaxThreads, int kMinBlocks>
auto pick(const float* bound, const int* counts) {
  constexpr int T = kMaxThreads, B = kMinBlocks;
  return bound ? (counts ? raster_pixels_kernel<kWire, true, true, T, B>
                         : raster_pixels_kernel<kWire, true, false, T, B>)
               : (counts ? raster_pixels_kernel<kWire, false, true, T, B>
                         : raster_pixels_kernel<kWire, false, false, T, B>);
}

template <bool kWire>
int launch(const float* records, const float* setup, const float* bbox,
           const int* tile_start, const int* tile_count, const int* chunk,
           float* z_out, float* vary_out, int* int_out, int width, int height,
           int band_h, int y0, int y_stride, int tiles_x, int num_tiles,
           int tile_w, int tile_h, float wire_thresh, const float* bound,
           int* counts, void* stream) {
  if (num_tiles > 0) {
    const int threads = tile_w * tile_h;
    constexpr int kBlocks = kWire ? kBlocksK2w : kBlocksK2;
    auto kernel = threads <= 256 ? pick<kWire, 256, kBlocks>(bound, counts)
                                 : pick<kWire, 1024, 1>(bound, counts);
    kernel<<<num_tiles, threads, 0, (cudaStream_t)stream>>>(
        records, setup, reinterpret_cast<const float4*>(bbox), tile_start,
        tile_count, chunk, z_out, vary_out, int_out, width, height, band_h, y0,
        y_stride, tiles_x, tile_w, tile_h, wire_thresh, bound, counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The outputs hold band_h rows of the width x height frame (band_h = height,
// y0 = 0, y_stride = 1 for the whole frame).  `bound`: the chunks' depth
// bounds (the occlusion skip), or null; `counts`: room for kCounts ints
// per tile, or null.
extern "C" int kani_rasterize_pixels(const float* records, const float* setup,
                                     const float* bbox, const int* tile_start,
                                     const int* tile_count, const int* chunk,
                                     float* z_out, float* vary_out,
                                     int* int_out, int width, int height,
                                     int band_h, int y0, int y_stride,
                                     int tiles_x, int num_tiles, int tile_w,
                                     int tile_h, const float* bound,
                                     int* counts, void* stream) {
  return launch<false>(records, setup, bbox, tile_start, tile_count, chunk,
                       z_out, vary_out, int_out, width, height, band_h, y0,
                       y_stride, tiles_x, num_tiles, tile_w, tile_h, 0.f,
                       bound, counts, stream);
}

extern "C" int kani_rasterize_pixels_wireframe(
    const float* records, const float* setup, const float* bbox,
    const int* tile_start, const int* tile_count, const int* chunk,
    float* z_out, float* vary_out, int* int_out, int width, int height,
    int band_h, int y0, int y_stride, int tiles_x, int num_tiles, int tile_w,
    int tile_h, float wire_thresh, const float* bound, int* counts,
    void* stream) {
  return launch<true>(records, setup, bbox, tile_start, tile_count, chunk,
                      z_out, vary_out, int_out, width, height, band_h, y0,
                      y_stride, tiles_x, num_tiles, tile_w, tile_h,
                      wire_thresh, bound, counts, stream);
}
