// K1: depth-only tile raster of the shadow map.
//
// Replaces kanirenderer_tpu/ops/raster_pallas.py:410-587 (`_raster_kernel`
// with depth_only=True, launched by `_run`, :603-699, from
// `rasterize_depth`, :1305-1344).  For every map texel it writes the minimum,
// over the binned triangles that cover the texel centre, of the
// screen-affine depth; the map is cleared to 1.0.
//
// What bounds it on this card: per (tile, chunk) pair the block stages
// 128 x 48 bytes of planes plus 2 KB of bboxes from device memory, then
// evaluates only the triangles whose bbox meets the tile (4 planes, ~16
// FP32 instructions per texel and triangle).  On the shadow grid most
// pairs hold few overlapping triangles, so the staging latency of each
// chunk, not arithmetic, is expected to dominate.
//
// Design: one block per tile, one thread per texel, a running minimum in a
// register; each block owns its output tile, so there are no atomics.
// Latency is hidden by occupancy (small blocks, 6 KB of shared memory),
// not yet by asynchronous copies: cp.async or TMA double-buffering and the
// reference's occlusion skip are later work.  Padding rows never reach the
// kernel as live triangles: invalid rows carry an empty bbox (masked out)
// and e0.c = -1 (never covered).

#include "raster_common.cuh"

namespace {

__global__ void raster_depth_kernel(const float* __restrict__ setup,
                                    const float4* __restrict__ bbox,
                                    const int* __restrict__ tile_start,
                                    const int* __restrict__ tile_count,
                                    const int* __restrict__ chunk,
                                    float* __restrict__ out, int width,
                                    int height, int tiles_x, int tile_w,
                                    int tile_h) {
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
  float acc = 1.0f;
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    kani::stage_chunk(&s, setup, 16, bbox, chunk[first + i], (float)tx0,
                      (float)(tx0 + tile_w), (float)ty0,
                      (float)(ty0 + tile_h));
    __syncthreads();
    for (int w = 0; w < kani::kMaskWords; ++w) {
      uint32_t m = s.mask[w];
      while (m) {
        const int r = w * 32 + __ffs(m) - 1;
        m &= m - 1;
        float z;
        if (kani::covers(s.tri[r], X, Y, &z)) acc = fminf(acc, z);
      }
    }
  }
  if (px < width && py < height) out[(size_t)py * width + px] = acc;
}

}  // namespace

extern "C" int kani_rasterize_depth(const float* setup, const float* bbox,
                                    const int* tile_start,
                                    const int* tile_count, const int* chunk,
                                    float* out, int width, int height,
                                    int tiles_x, int num_tiles, int tile_w,
                                    int tile_h, void* stream) {
  if (num_tiles > 0) {
    raster_depth_kernel<<<num_tiles, tile_w * tile_h, 0,
                          (cudaStream_t)stream>>>(
        setup, reinterpret_cast<const float4*>(bbox), tile_start, tile_count,
        chunk, out, width, height, tiles_x, tile_w, tile_h);
  }
  return (int)cudaGetLastError();
}
