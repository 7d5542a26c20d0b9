// Shared pieces of the tile raster kernels (raster_depth.cu,
// raster_pixels.cu, raster_visibility.cu).
//
// A CUDA block rasterizes a screen tile of tile_w x tile_h pixels with one
// thread per pixel, against chunks of 128 triangles from the tile's list
// (ascending chunk id, from ops/binning.bin_tiles; K1 gives a block a
// slice of a tile's list and merges the blocks).  Only the triangles
// whose pixel bbox overlaps the tile are evaluated, and every thread of a
// warp visits exactly the same triangles (no divergence).
//
// All kernels go bbox first (HitStage, cull_chunks, visit_hits).  The warps
// test the chunks' bboxes (2 KB per chunk) and append the global row ids
// of the hits to a list in shared memory; only the hits' planes (48 bytes
// each) are then fetched, with cp.async into a three-stage ring, so the
// next batches load while this one is evaluated.  Before a warp
// evaluates a batch, each lane takes one hit and asks whether any of its
// edge planes is negative over the whole rectangle of the warp's pixels
// (may_cover) and, for wireframe coverage, whether all of its edges are
// farther than the threshold from every pixel of the rectangle (may_pass);
// the warp then visits only the hits that survive.  Both tests are exact,
// not approximate: see edge_max and edge_dist_min.  In wireframe mode the
// lane also computes its hit's three edge scales g, once for the warp, and
// the visiting threads take them from it by shuffle.  K2, K2w and K3 share
// the whole loop (tile_tournament).
//
// Occlusion skip (the Pallas kernels' O1, raster_pallas.py:178-276), on
// when the wrapper passes the chunks' depth bounds (ops/binning
// depth_bound, ChunkBins.bound; the lists then come nearest first), built
// as separate instantiations (kOcc), as are the counters (kCount), so that
// a build with neither compiles to the code without the skip.  At the
// start of each round of chunks every warp takes the greatest depth its
// stored pixels have resolved (z only falls, so the value stays an upper
// bound), the block the greatest over its warps, and
// the cull skips a chunk, bbox test, fetch and evaluation, whose bound is
// greater than the tile's (cull_chunks_ordered; the masks of such a
// chunk are taken all the same, to save a barrier).  That cull lays the
// hits out in list order, nearest chunk first, and before each batch of 32
// hits a warp takes its resolved depth again; visit_hits drops, beside
// may_cover, a hit whose least depth over the warp's rectangle
// (depth_min, exact as edge_max) is greater.  So the skip fires within a
// tile's first round, with no round or barrier more.  Both tests are
// strict: a dropped triangle can neither win a pixel nor tie one, and the
// outputs are those without the skip bit for bit.  Pixels that are not
// stored (past the raster, outside a band) take no part in the maxima.
// A counting build (kCount) adds, per block, for ops/occ_replay to replay:
// chunks tested and skipped, warp visits of hits, hits dropped by the
// depth test (OccCount; without kOcc only the visits).
//
// Floating-point order: a plane is evaluated as (a*X + c) + b*Y in round-to-
// nearest with no fused multiply-add, the order of the reference Pallas
// kernel (raster_pallas.py:488-506) and of the plain PyTorch versions in
// ops/raster_cuda.py, so kernel and plain version agree bit for bit.  The
// library is also built with -fmad=false.  The same bits are why the tensor
// cores are not used: a TF32 or bf16 product rounds the plane terms
// differently, and the winner of near-coplanar surfaces turns on the last
// bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kani {

constexpr int kChunk = 128;  // triangles per chunk (CHUNK_SIZE)

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

// Wireframe coverage, in the order of the reference
// (raster_pallas.py:491-518): the distance of pixel centre (X, Y) to edge
// (a, b, c) in pixels is d = (a*X + c)*g + (b*Y)*g with the edge's scale
// g = 1/sqrt(a^2 + b^2 + 1e-30).  g is 1/sqrt in round-to-nearest (not the
// approximate rsqrtf), which is what 1.0 / torch.sqrt computes on the card,
// so kernel and plain version agree bit for bit.  g depends on the triangle
// only: visit_hits computes it once per (warp, hit).  It is +0 where
// a^2 + b^2 overflows, never negative, and NaN only for a NaN coefficient.
__device__ __forceinline__ float edge_scale(float a, float b) {
  const float n2 =
      __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), 1e-30f);
  return __fdiv_rn(1.f, __fsqrt_rn(n2));
}

__device__ __forceinline__ float edge_dist(float a, float b, float c, float g,
                                           float X, float Y) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(a, X), c), g),
                   __fmul_rn(__fmul_rn(b, Y), g));
}

// The scales of a triangle's three edges (unused without wireframe).
struct Scales {
  float g0, g1, g2;
};

__device__ __forceinline__ Scales edge_scales(const Planes& t) {
  return {edge_scale(t.p0.x, t.p0.y), edge_scale(t.p0.w, t.p1.x),
          edge_scale(t.p1.z, t.p1.w)};
}

// The lesser of x and y, NaN if either is NaN: the minimum of jnp.minimum
// and torch.minimum, which the reference and the plain version take (fminf
// would skip a NaN operand).
__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// Coverage in either mode, chosen at compile time: the five-plane coverage
// of `covers` and, for wireframe, a pixel centre within `thresh` pixels of
// the nearest of the three edges.  A NaN distance (an infinite plane value
// times g = 0) covers nothing.
template <bool kWire>
__device__ __forceinline__ bool covers_mode(const Planes& t, const Scales& g,
                                            float X, float Y, float thresh,
                                            float* z) {
  if (!covers(t, X, Y, z)) return false;
  if (!kWire) return true;
  const float d0 = edge_dist(t.p0.x, t.p0.y, t.p0.z, g.g0, X, Y);
  const float d1 = edge_dist(t.p0.w, t.p1.x, t.p1.y, g.g1, X, Y);
  const float d2 = edge_dist(t.p1.z, t.p1.w, t.p2.x, g.g2, X, Y);
  return min_nan(min_nan(d0, d1), d2) <= thresh;
}

// ---- bbox-first hit compaction and asynchronous plane staging ----

constexpr int kBatch = 32;   // hits staged per ring slot: one per lane
constexpr int kStages = 3;   // ring slots: two batches in flight, one in use

// The occlusion counters of a block: chunks tested against their bound,
// chunks skipped, warp visits of hits (a visit evaluates the hit at the
// warp's 32 pixels), hits dropped by the depth test.
enum OccCount { kTested, kSkipped, kVisits, kDropped, kCounts };

// Shared-memory state of one block: the hit list of up to kCap global
// triangle row ids (unordered), its length, and the ring of staged planes.
template <int kCap>
struct HitStage {
  int list[kCap];
  Planes ring[kStages][kBatch];
  int count;
};

// With the occlusion skip or the counters, besides: the warps' resolved
// depths (as int bits), the counters and the ordered cull's per-chunk
// masks.
template <int kCap>
struct OccStage : HitStage<kCap> {
  int wmax[32];
  int occ[kCounts];
  uint32_t cmask[kCap / kChunk][4];  // cull_chunks_ordered's hit masks
  int ctot[kCap / kChunk];           // and hit counts, per chunk
};

// The stage of a build: HitStage alone without the skip and the counters.
template <int kCap, bool kOcc, bool kCount>
using StageOf =
    std::conditional_t<kOcc || kCount, OccStage<kCap>, HitStage<kCap>>;

// Pixel (lx, ly) of this thread within its tile.  A warp takes an 8 x 4
// patch where the tile divides into such patches, else 32 pixels in raster
// order: the squarer the warp's rectangle, the more hits may_cover drops.
__device__ __forceinline__ void tile_pixel(int tile_w, int tile_h, int* lx,
                                           int* ly) {
  const int t = threadIdx.x;
  if ((tile_w & 7) == 0 && (tile_h & 3) == 0) {
    const int patch = t >> 5, lane = t & 31, across = tile_w >> 3;
    *lx = (patch % across) * 8 + (lane & 7);
    *ly = (patch / across) * 4 + (lane >> 3);
  } else {
    *lx = t % tile_w;
    *ly = t / tile_w;
  }
}

// The rectangle of pixel centres a warp covers: the least and greatest X
// and Y over its lanes (a superset of its pixels where they do not form a
// rectangle).
struct Rect {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ Rect warp_rect(int px, int py) {
  Rect r;
  r.x0 = (float)__reduce_min_sync(0xffffffffu, px) + 0.5f;
  r.x1 = (float)__reduce_max_sync(0xffffffffu, px) + 0.5f;
  r.y0 = (float)__reduce_min_sync(0xffffffffu, py) + 0.5f;
  r.y1 = (float)__reduce_max_sync(0xffffffffu, py) + 0.5f;
  return r;
}

// The greatest value plane (a, b, c) takes at a pixel centre of r, or NaN.
// Each step of (a*X + c) + b*Y is a monotone function followed by a
// monotone rounding, so the computed plane is monotone in X for fixed Y and
// in Y for fixed X, and its maximum over the rectangle lies at the corner
// the signs of a and b point to.  Hence a negative value here means the
// plane is negative (or NaN) at every pixel of r, bit for bit as `covers`
// will compute it; a NaN here decides nothing.
__device__ __forceinline__ float edge_max(float a, float b, float c,
                                          const Rect& r) {
  return plane(a, b, c, a >= 0.f ? r.x1 : r.x0, b >= 0.f ? r.y1 : r.y0);
}

// False only if triangle t covers no pixel centre of r.
__device__ __forceinline__ bool may_cover(const Planes& t, const Rect& r) {
  return !(edge_max(t.p0.x, t.p0.y, t.p0.z, r) < 0.f) &&
         !(edge_max(t.p0.w, t.p1.x, t.p1.y, r) < 0.f) &&
         !(edge_max(t.p1.z, t.p1.w, t.p2.x, r) < 0.f);
}

// The least distance edge (a, b, c) with scale g takes at a pixel centre of
// r, or NaN.  d = S(X) + T(Y) with S = (a*X + c)*g and T = (b*Y)*g.  g is
// never negative, so each step of S is a monotone function followed by a
// monotone rounding: where S is not NaN at two X it is ordered as a*X is,
// and T likewise in Y by the sign of b (an overflow meeting an opposite
// infinity, or an infinity meeting g = 0, gives NaN, never a value out of
// order).  If d is a number at the corner opposite to the one the signs of
// a and b point to, S and T are numbers there, no less elsewhere in r
// wherever they are numbers, and the rounded sum keeps that order.  Hence a
// value above the threshold here means the distance is above it or NaN at
// every pixel of r, bit for bit as `covers_mode` will compute it; a NaN
// here decides nothing.
__device__ __forceinline__ float edge_dist_min(float a, float b, float c,
                                               float g, const Rect& r) {
  return edge_dist(a, b, c, g, a >= 0.f ? r.x0 : r.x1,
                   b >= 0.f ? r.y0 : r.y1);
}

// False only if no pixel centre of r lies within `thresh` of an edge of t
// as `covers_mode` measures it: all three distances above the threshold
// or NaN everywhere, and the minimum of such values is never <= thresh.
__device__ __forceinline__ bool may_pass(const Planes& t, const Scales& g,
                                         const Rect& r, float thresh) {
  return !(edge_dist_min(t.p0.x, t.p0.y, t.p0.z, g.g0, r) > thresh &&
           edge_dist_min(t.p0.w, t.p1.x, t.p1.y, g.g1, r) > thresh &&
           edge_dist_min(t.p1.z, t.p1.w, t.p2.x, g.g2, r) > thresh);
}

// The least depth the plane (za, zb, zc) of t takes at a pixel centre of
// r, or NaN: the corner the signs of za and zb point away from (the
// argument of edge_max, turned round).  With zc finite and za, zb not NaN,
// a covered pixel of r has a depth no less than this; otherwise t covers
// nothing (ops/binning.depth_bound).  So a value greater than the depth a
// warp has resolved means t cannot win or tie any pixel of the warp.
__device__ __forceinline__ float depth_min(const Planes& t, const Rect& r) {
  return plane(t.p2.y, t.p2.z, t.p2.w, t.p2.y >= 0.f ? r.x0 : r.x1,
               t.p2.z >= 0.f ? r.y0 : r.y1);
}

// The greatest of z over the lanes of the warp where `stored`, as float
// bits (0 where no lane is stored).  Depths here are never NaN and lie in
// [-0.0, 1.0], where the order of non-negative floats is that of their
// bits; -0.0 reads as less than +0.0, which compares equal to it.
__device__ __forceinline__ int warp_zmax(float z, bool stored) {
  return __reduce_max_sync(0xffffffffu, stored ? __float_as_int(z) : 0);
}

// The tile's resolved depth: the greatest of the warps' (s->wmax), read by
// every thread after the barrier that follows their store.
template <int kCap>
__device__ __forceinline__ float tile_zmax(const OccStage<kCap>* s) {
  const int lane = threadIdx.x & 31;
  const int v = lane < (int)(blockDim.x >> 5) ? s->wmax[lane] : 0;
  return __int_as_float(__reduce_max_sync(0xffffffffu, v));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Cull: append to s->list the global row ids of the triangles of chunks
// ids[0..n) whose bbox meets the tile [tx0, tx1) x [ty0, ty1).  One warp
// takes a chunk: four bboxes per lane, one shared atomicAdd per chunk.  The
// list must have room for n * kChunk more ids; the order of the list is
// arbitrary.  The caller zeroes s->count before and brackets the call with
// __syncthreads().  `ids` may point to global or shared memory.
template <int kCap>
__device__ __forceinline__ void cull_chunks(HitStage<kCap>* s,
                                            const float4* __restrict__ bbox,
                                            const int* ids, int n, float tx0,
                                            float tx1, float ty0, float ty1) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  for (int i = threadIdx.x >> 5; i < n; i += blockDim.x >> 5) {
    const int row0 = ids[i] * kChunk;
    bool hit[4];
    uint32_t m[4];
    int total = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = bbox[row0 + q * 32 + lane];
      hit[q] = b.x < tx1 && b.z > tx0 && b.y < ty1 && b.w > ty0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m[q] = __ballot_sync(0xffffffffu, hit[q]);
      total += __popc(m[q]);
    }
    if (total == 0) continue;  // uniform over the warp
    int base = 0;
    if (lane == 0) base = atomicAdd(&s->count, total);
    base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (hit[q]) s->list[base + __popc(m[q] & below)] = row0 + q * 32 + lane;
      base += __popc(m[q]);
    }
  }
}

// The cull of the occlusion skip: as cull_chunks, but the hits are laid
// out in the order of ids[] (chunk by chunk, ascending row within a
// chunk), so that the nearest come first, and a chunk whose depth bound is
// greater than the tile's resolved depth (the greatest of s->wmax, which
// every warp stores before the call) is left out; it sets s->count itself.
// Two phases around one barrier: every warp takes the bbox masks of its
// chunks, then takes the skips and places the hits (no atomics, no barrier
// more than cull_chunks costs).  With kCount, the tests go into s->occ.
// n <= min(32, kCap / kChunk); the caller puts a __syncthreads() before
// (after the previous visit) and after the call.
template <bool kCount, int kCap>
__device__ __forceinline__ void cull_chunks_ordered(
    OccStage<kCap>* s, const float4* __restrict__ bbox, const int* ids,
    int n, float tx0, float tx1, float ty0, float ty1,
    const float* __restrict__ bound) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  // chunk `lane`'s bound, loaded while the masks are taken
  const float cbound = lane < n ? bound[ids[lane]] : 0.f;
  for (int i = threadIdx.x >> 5; i < n; i += warps) {
    const int row0 = ids[i] * kChunk;
    int total = 0;
    uint32_t mine = 0;   // lane q < 4 keeps mask q
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = bbox[row0 + q * 32 + lane];
      const uint32_t m = __ballot_sync(
          0xffffffffu, b.x < tx1 && b.z > tx0 && b.y < ty1 && b.w > ty0);
      total += __popc(m);
      if (lane == q) mine = m;
    }
    if (lane < 4) s->cmask[i][lane] = mine;
    if (lane == 0) s->ctot[i] = total;
  }
  __syncthreads();
  const float zmax = tile_zmax(s);
  const bool skip = lane < n && cbound > zmax;  // chunk `lane`
  const uint32_t skips = __ballot_sync(0xffffffffu, skip);
  const int kept = lane < n && !skip ? s->ctot[lane] : 0;
  const uint32_t below = (1u << lane) - 1u;
  for (int i = threadIdx.x >> 5; i < n; i += warps) {
    if (kCount && lane == 0) {
      atomicAdd(&s->occ[kTested], 1);
      if ((skips >> i) & 1u) atomicAdd(&s->occ[kSkipped], 1);
    }
    if ((skips >> i) & 1u) continue;  // uniform over the warp
    int base = __reduce_add_sync(0xffffffffu, lane < i ? kept : 0);
    const int row0 = ids[i] * kChunk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t m = s->cmask[i][q];
      if ((m >> lane) & 1u)
        s->list[base + __popc(m & below)] = row0 + q * 32 + lane;
      base += __popc(m);
    }
  }
  const int total = __reduce_add_sync(0xffffffffu, kept);
  if (threadIdx.x == 0) s->count = total;
}

// Evaluate: call visit(planes, row id, scales) for those of the first
// `hits` entries of s->list that may cover a pixel of the warp's rectangle
// `rect`, the same sequence in every thread of a warp.  With kWire, hits
// that cannot come within `thresh` of an edge anywhere in the rectangle
// are dropped too, and `scales` holds the hit's edge scales, computed by
// the one lane that tested it (without kWire they are zero and unused).
// The planes (lanes 0:12 of the (T, 16) setup rows) are fetched in batches
// of kBatch with cp.async into the ring; batch b + 2 is requested before
// batch b is evaluated, with one barrier per batch.  `hits` must be uniform
// over the block; the caller puts a __syncthreads() between the cull and
// this call, and another before the list or the ring is written again.
// With kZ (the occlusion skip), hits whose depth_min over the rectangle
// is greater than zcut(), the warp's resolved depth, taken by every lane
// before each batch, are dropped too; with kCount, the warp's visits and
// such drops go into s->occ (an OccStage).  Without kZ, zcut is not
// called; with neither, this is the loop without the skip.
template <bool kWire, bool kZ, bool kCount, typename Stage, typename Visit,
          typename Cut>
__device__ __forceinline__ void visit_hits(Stage* s,
                                           const float* __restrict__ setup,
                                           int hits, const Rect& rect,
                                           float thresh, Cut&& zcut,
                                           Visit&& visit) {
  static_assert(kStages == 3, "the waits below assume a three-slot ring");
  static_assert(kBatch == 32, "one hit per lane in the rectangle test");
  const int lane = threadIdx.x & 31;
  const int batches = (hits + kBatch - 1) / kBatch;
  auto fetch = [&](int b) {
    if (b < batches) {
      const int h0 = b * kBatch;
      const int items = 3 * min(kBatch, hits - h0);
      float4* dst = reinterpret_cast<float4*>(s->ring[b % kStages]);
      for (int j = threadIdx.x; j < items; j += blockDim.x) {
        const int r = j / 3;
        const float4* row = reinterpret_cast<const float4*>(
            setup + (size_t)s->list[h0 + r] * 16);
        cp_async16(dst + j, row + (j - 3 * r));
      }
    }
    cp_async_commit();  // one group per call, empty or not
  };
  fetch(0);
  fetch(1);
  for (int b = 0; b < batches; ++b) {
    cp_async_wait<1>();  // this thread's copies of batch b have landed
    __syncthreads();     // everyone's have, and batch b - 1 is evaluated
    fetch(b + 2);        // into the slot batch b - 1 has just left
    const Planes* tri = s->ring[b % kStages];
    const int* id = s->list + b * kBatch;
    const int n = min(kBatch, hits - b * kBatch);
    bool keep = lane < n && may_cover(tri[lane], rect);
    Scales g = {0.f, 0.f, 0.f};
    if constexpr (kWire) {
      if (keep) {
        g = edge_scales(tri[lane]);
        keep = may_pass(tri[lane], g, rect, thresh);
      }
    }
    uint32_t edges = 0;  // the hits before the depth test, if counted
    if constexpr (kCount) edges = __ballot_sync(0xffffffffu, keep);
    if constexpr (kZ) {
      const float cut = zcut();
      keep = keep && !(depth_min(tri[lane], rect) > cut);
    }
    uint32_t m = __ballot_sync(0xffffffffu, keep);
    if constexpr (kCount) {
      if (lane == 0) {
        atomicAdd(&s->occ[kVisits], __popc(m));
        atomicAdd(&s->occ[kDropped], __popc(edges & ~m));
      }
    }
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      if constexpr (kWire) {
        visit(tri[j], id[j],
              Scales{__shfl_sync(0xffffffffu, g.g0, j),
                     __shfl_sync(0xffffffffu, g.g1, j),
                     __shfl_sync(0xffffffffu, g.g2, j)});
      } else {
        visit(tri[j], id[j], g);
      }
    }
  }
}

// ---- phase 1 of K2, K2w and K3 ----

constexpr int kRound = 16;  // chunks culled per round

// The shared-memory stage of phase 1 in a build with (kOcc) or without the
// skip, with (kCount) or without the counters.
template <bool kOcc, bool kCount>
using TileStage = StageOf<kRound * kChunk, kOcc, kCount>;

// Write the block's occlusion counters to counts[blockIdx.x * kCounts ..].
// Every thread of the block must call it.
template <int kCap>
__device__ __forceinline__ void flush_counts(OccStage<kCap>* s,
                                             int* __restrict__ counts) {
  __syncthreads();
  if (threadIdx.x < kCounts)
    counts[blockIdx.x * kCounts + threadIdx.x] = s->occ[threadIdx.x];
}

// Zero the block's occlusion counters; the next barrier publishes it.
template <int kCap>
__device__ __forceinline__ void zero_counts(OccStage<kCap>* s) {
  if (threadIdx.x < kCounts) s->occ[threadIdx.x] = 0;
}

// The (z, global triangle id) tournament of one tile for the pixel centre
// (X, Y) of this thread: over the triangles of chunks ids[0..n) that cover
// it, the least depth below *best_z and, among equal depths, the least id
// (the hit list is unordered, so the compare is lexicographic, which is
// what a strict `<` over ascending ids gives).  The caller sets *best_z to
// the cleared depth and *best to -1.  Rounds of kRound chunks: cull by
// bbox, then visit the hits, so the list cannot overflow.  With kOcc the
// occlusion skip is on, against `bound` (the chunks' depth bounds), over
// the pixels where `stored`; with kCount, the block's occlusion counters
// go to `counts`; with neither, both are unused.  Every thread of the
// block must call it, with the tile's origin (tx0, ty0) and `rect` from
// warp_rect.
template <bool kWire, bool kOcc, bool kCount>
__device__ __forceinline__ void tile_tournament(
    TileStage<kOcc, kCount>* s, const float* __restrict__ setup,
    const float4* __restrict__ bbox, const int* __restrict__ ids, int n,
    int tx0, int ty0, int tile_w, int tile_h, float X, float Y,
    const Rect& rect, float thresh, bool stored,
    const float* __restrict__ bound, int* __restrict__ counts,
    float* best_z, int* best) {
  float bz = *best_z;
  int bi = *best;
  if constexpr (kCount) zero_counts(s);
  for (int i0 = 0; i0 < n; i0 += kRound) {
    if constexpr (kOcc) {
      const int wmax = warp_zmax(bz, stored);
      __syncthreads();  // the previous round has left the list and the ring
      if ((threadIdx.x & 31) == 0) s->wmax[threadIdx.x >> 5] = wmax;
      cull_chunks_ordered<kCount>(s, bbox, ids + i0, min(kRound, n - i0),
                                  (float)tx0, (float)(tx0 + tile_w),
                                  (float)ty0, (float)(ty0 + tile_h), bound);
    } else {
      __syncthreads();  // the previous round has left the list and the ring
      if (threadIdx.x == 0) s->count = 0;
      __syncthreads();
      cull_chunks(s, bbox, ids + i0, min(kRound, n - i0), (float)tx0,
                  (float)(tx0 + tile_w), (float)ty0, (float)(ty0 + tile_h));
    }
    __syncthreads();
    visit_hits<kWire, kOcc, kCount>(
        s, setup, s->count, rect, thresh,
        [&] { return __int_as_float(warp_zmax(bz, stored)); },
        [&](const Planes& t, int id, const Scales& g) {
          float z;
          if (covers_mode<kWire>(t, g, X, Y, thresh, &z) &&
              (z < bz || (z == bz && id < bi))) {
            bz = z;
            bi = id;
          }
        });
  }
  if constexpr (kCount) flush_counts(s, counts);
  *best_z = bz;
  *best = bi;
}

}  // namespace kani
