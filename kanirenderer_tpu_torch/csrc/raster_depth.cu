// K1: depth-only tile raster of the shadow map.
//
// Replaces kanirenderer_tpu/ops/raster_pallas.py:410-587 (`_raster_kernel`
// with depth_only=True, launched by `_run`, :603-699, from
// `rasterize_depth`, :1305-1344).  For every map texel it computes the
// minimum, over the binned triangles that cover the texel centre, of the
// screen-affine depth; the caller clears the map to 1.0 first.
//
// What bounds it on this card: FP32 plane evaluation, badly balanced.  At
// the bench pose nine tenths of the 16,384 shadow tiles are empty and the
// rest hold 21 chunks on average and up to 117, with up to 2,400 bbox hits
// in one tile, so with one block per tile the launch ends on the serial
// walk of a few heavy tiles while most SMs idle.  Staging every chunk's 128
// planes (8 KB per (tile, chunk) pair, of which 9% are hit) comes second.
//
// Design: the work is cut by bin entries, not by tiles.  Block k takes
// entries [k*kSlice, (k+1)*kSlice) of the flat (tile, chunk) list that
// binning sorted by tile, so no block holds more than kSlice chunks and the
// heaviest tile is spread over a dozen blocks.  Consecutive entries of one
// tile form a run; for each run the block culls by bbox first (one warp per
// chunk, hit ids compacted into shared memory), fetches only the hits'
// planes with cp.async into a three-slot ring (raster_common.cuh), lets each
// warp drop the hits whose edges exclude its 8 x 4 patch of the tile (an exact
// test, raster_common.cuh edge_max), keeps a running minimum in a register
// and merges it into the map with atomicMin.
// A row band (the banded fresh shadow pass, raster_pallas.py:1304-1344 with
// band_h and y0) is the same launch on the band's slice of the entry list:
// entries are sorted by tile and tiles are numbered row-major, so the tile
// rows that meet the band are one run of entries.  Texels are evaluated at
// their global centres and stored at band row py - y0 of a (band_h, width)
// map, so a band's texels are the full map's bit for bit (the TPU kernel
// re-anchors the planes to the band instead, c <- c + b*y0, which rounds
// differently).
// Depths are in [-0.0, 1.0], where the order of the floats is the order of
// their bits as signed integers, so the merged minimum is exact and does
// not depend on the order of the blocks.  Entries dropped by the per-tile
// cap and the padding of the list carry tile -1 and are skipped.  Invalid
// triangles carry an empty bbox (never hit) and e0.c = -1 (never covered).
// The planes keep their (a*X + c) + b*Y order without FMA, which rules out
// the tensor cores (see raster_common.cuh).
//
// Occlusion skip (with the chunks' bounds; raster_common.cuh): the blocks
// share no table, so before culling its run every thread reads its texel
// from the map.  The map only falls, so whatever value the read finds
// (another block's atomicMin may land before or after it) bounds the
// texel's final depth from above; the chunk test takes the tile's
// greatest, the per-warp test before each batch the warp's greatest of
// the least of that value and the thread's own minimum.  A tile's chunks
// come nearest first, and the blocks of its nearer entries were launched
// earlier, so later blocks find the map already lowered.  A run is one
// round: rounds within it (1, 2, 4 chunks) made K1 20% slower at the
// bench pose for 3% more of the evaluations spared (PERF.md §6).

#include "raster_common.cuh"

namespace {

constexpr int kSlice = 8;  // bin entries per block: a chunk per warp

// Blocks of up to 1024 threads; no register limit below 64 pays here.
// kOcc: the occlusion skip, against `bound`; kCount: the occlusion
// counters, into `counts` (raster_common.cuh).  Each is a separate
// instantiation, so that the build with neither is the code without them.
template <bool kOcc, bool kCount>
__global__ void __launch_bounds__(1024, 1)
    raster_depth_kernel(const float* __restrict__ setup,
                        const float4* __restrict__ bbox,
                        const int* __restrict__ pair_tile,
                        const int* __restrict__ chunk, int entries,
                        float* __restrict__ out, int width, int height,
                        int y0, int band_h, int tiles_x, int tile_w,
                        int tile_h, const float* __restrict__ bound,
                        int* __restrict__ counts) {
  __shared__ kani::StageOf<kSlice * kani::kChunk, kOcc, kCount> s;
  __shared__ int s_tile[kSlice], s_chunk[kSlice];
  const int i0 = blockIdx.x * kSlice;
  if (threadIdx.x < kSlice) {
    const bool live = i0 + threadIdx.x < entries;
    s_tile[threadIdx.x] = live ? pair_tile[i0 + threadIdx.x] : -1;
    s_chunk[threadIdx.x] = live ? chunk[i0 + threadIdx.x] : 0;
  }
  if constexpr (kCount) kani::zero_counts(&s);
  __syncthreads();
  int lx, ly;
  kani::tile_pixel(tile_w, tile_h, &lx, &ly);

  for (int j0 = 0; j0 < kSlice;) {
    const int tile = s_tile[j0];
    int j1 = j0 + 1;
    while (j1 < kSlice && s_tile[j1] == tile) ++j1;
    if (tile >= 0) {
      const int tx0 = (tile % tiles_x) * tile_w;
      const int ty0 = (tile / tiles_x) * tile_h;
      const int px = tx0 + lx;
      const int py = ty0 + ly;
      const float X = (float)px + 0.5f;
      const float Y = (float)py + 0.5f;
      const kani::Rect rect = kani::warp_rect(px, py);
      float acc = 1.0f;
      auto visit = [&](const kani::Planes& t, int, const kani::Scales&) {
        float z;
        if (kani::covers(t, X, Y, &z)) acc = fminf(acc, z);
      };
      if constexpr (kOcc) {
        const bool stored =
            px < width && py < height && py >= y0 && py < y0 + band_h;
        // the map's texel now: an upper bound of its final depth
        const float seen =
            stored ? __ldcg(out + (size_t)(py - y0) * width + px) : 1.0f;
        const int wmax = kani::warp_zmax(seen, stored);
        __syncthreads();  // the previous run has left the list and the ring
        if ((threadIdx.x & 31) == 0) s.wmax[threadIdx.x >> 5] = wmax;
        kani::cull_chunks_ordered<kCount>(
            &s, bbox, s_chunk + j0, j1 - j0, (float)tx0,
            (float)(tx0 + tile_w), (float)ty0, (float)(ty0 + tile_h), bound);
        __syncthreads();
        kani::visit_hits<false, true, kCount>(
            &s, setup, s.count, rect, 0.f,
            [&] {
              return __int_as_float(
                  kani::warp_zmax(fminf(acc, seen), stored));
            },
            visit);
      } else {
        __syncthreads();  // the previous run has left the list and the ring
        if (threadIdx.x == 0) s.count = 0;
        __syncthreads();
        kani::cull_chunks(&s, bbox, s_chunk + j0, j1 - j0, (float)tx0,
                          (float)(tx0 + tile_w), (float)ty0,
                          (float)(ty0 + tile_h));
        __syncthreads();
        kani::visit_hits<false, false, kCount>(
            &s, setup, s.count, rect, 0.f, [] { return 1.0f; }, visit);
      }
      if (px < width && py < height && py >= y0 && py < y0 + band_h &&
          acc < 1.0f) {
        atomicMin(
            reinterpret_cast<int*>(out + (size_t)(py - y0) * width + px),
            __float_as_int(acc));
      }
    }
    j0 = j1;
  }
  if constexpr (kCount) kani::flush_counts(&s, counts);
}

}  // namespace

// `out` holds rows [y0, y0 + band_h) of the width x height map and must hold
// 1.0 everywhere; `entries` is the length of pair_tile and chunk (the whole
// list, or the run of the tile rows that meet the band).  `bound`: the
// chunks' depth bounds (the occlusion skip), or null; `counts`: room for
// kCounts ints per block (ceil(entries / 8) blocks), or null.
extern "C" int kani_rasterize_depth(const float* setup, const float* bbox,
                                    const int* pair_tile, const int* chunk,
                                    int entries, float* out, int width,
                                    int height, int y0, int band_h,
                                    int tiles_x, int tile_w, int tile_h,
                                    const float* bound, int* counts,
                                    void* stream) {
  if (entries > 0) {
    auto kernel = bound ? (counts ? raster_depth_kernel<true, true>
                                  : raster_depth_kernel<true, false>)
                        : (counts ? raster_depth_kernel<false, true>
                                  : raster_depth_kernel<false, false>);
    kernel<<<(entries + kSlice - 1) / kSlice, tile_w * tile_h, 0,
             (cudaStream_t)stream>>>(
        setup, reinterpret_cast<const float4*>(bbox), pair_tile, chunk,
        entries, out, width, height, y0, band_h, tiles_x, tile_w, tile_h,
        bound, counts);
  }
  return (int)cudaGetLastError();
}
