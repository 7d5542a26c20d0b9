"""Per-frame tile binning for the CUDA raster kernels.

Counterpart of ``bin_stream`` in ``kanirenderer_tpu/ops/binning.py`` with
its semantics and a layout of its own.  The screen is cut into
tile_w × tile_h tiles; each tile gets the ascending list of CHUNK_SIZE
triangle chunks (Morton-ordered at scene build) of which at least one
SUBBATCH bounding box overlaps the tile.

The lists are CSR-like: one sorted array of ``tile·C + chunk`` keys, built
with one ``torch.sort``, and per-tile ``start``/``count`` into it, found by
``searchsorted``.  A tile keeps at most ``cap`` chunks (the lowest ids);
the rest are dropped and counted in ``overflow``, never silently.

Occlusion (the counterpart of ``bin_stream(..., zmin=)``): given a
per-triangle depth bound (``depth_bound``), each tile's list is ordered
nearest first, still tile-major: the key becomes
``(tile·RANKS + rank)·C + chunk`` with ``rank`` the chunk's bound
quantised to RANKS levels, and the cap drops the farthest chunks.  The
bins then carry the chunks' bounds (``ChunkBins.bound``), and the kernels
skip a chunk whose bound lies behind every pixel its tile has resolved
so far (csrc/raster_common.cuh).
``pair_tile`` names the tile of every entry of the sorted array, −1 for the
entries that are not kept, so a kernel can cut the work by entries instead
of by tiles (csrc/raster_depth.cu).

Sizing the expansion needs the number of (tile, chunk) pairs on the host:
that is the one device-to-host synchronisation of a binning call.

Row bands (passes/frame.render_band): a contiguous band is binned on its
own grid, whose tile row j covers the global rows [y0 + j·tile_h, …)
(``bin_tiles(y0=…)``); an interleaved band takes its tile rows of the
full grid's bins (``interleave_bins``), sharing their ``chunk`` array.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kanirenderer_tpu_torch.core.types import (CHUNK_SIZE, SUBBATCH,
                                               SUBS_PER_CHUNK)

Tensor = torch.Tensor


class ChunkBins(NamedTuple):
    start: Tensor     # (num_tiles,) i32 first entry of the tile in ``chunk``
    count: Tensor     # (num_tiles,) i32 entries kept for the tile (≤ cap)
    chunk: Tensor     # (N,) i32 chunk ids grouped by tile, ascending
    #   (nearest first where ``bound`` is given)
    pair_tile: Tensor  # (N,) i32 tile of each entry, −1 where not kept
    overflow: Tensor  # () i32 entries dropped by the per-tile cap
    tiles_x: int
    tiles_y: int
    tile_w: int
    tile_h: int
    # (C,) f32 per-chunk depth lower bound the lists are ordered by, or
    # None: lists in ascending chunk id and no occlusion skip.
    bound: Tensor | None = None


# Front-to-back ranks per tile: the chunk bound quantised to 1/RANKS.
RANKS = 8192


def depth_bound(setup: Tensor, bbox: Tensor, tile_w: int,
                tile_h: int) -> Tensor:
    """(T,) f32: for each triangle a lower bound of the depth it gives any
    pixel it covers, as the kernels and plain rasters evaluate it, on any
    grid of tile_w × tile_h tiles (whatever its origin).

    A kernel evaluates a triangle at every pixel of the tiles its bbox
    meets, so at pixel centres X in [floor(x0) − tile_w + 1.5,
    ceil(x1) + tile_w − 1.5] and likewise in Y (a pixel outside the bbox
    but inside such a tile may be covered too, by rounding, on slivers).
    The depth there is the plane z = (za·X + zc) + zb·Y in round-to-
    nearest with no fused multiply-add.  With zc finite and za, zb not
    NaN, u = za·X + zc and v = zb·Y are each a monotone function followed
    by a monotone rounding, never NaN, so u is monotone in X, v in Y, and
    where the rounded sum is not NaN it is ordered as (u, v) are: the
    least value over the rectangle is the one at the corner the signs of
    za and zb point away from, bit for bit (the argument of
    raster_common.cuh ``edge_max``), and a covered pixel (0 ≤ z, not
    NaN) has z no less than it.  A NaN or infinite zc, or a NaN za or zb,
    makes z NaN or infinite everywhere: such a triangle covers nothing
    (z ≤ 1 fails), so any bound is exact.  The corner value is clamped
    at 0 and a NaN bound becomes 0 (never skipped); a triangle with an
    empty bbox is never evaluated and gets +inf."""
    x0 = torch.floor(bbox[:, 0]) - (tile_w - 1.5)
    x1 = torch.ceil(bbox[:, 2]) + (tile_w - 1.5)
    y0 = torch.floor(bbox[:, 1]) - (tile_h - 1.5)
    y1 = torch.ceil(bbox[:, 3]) + (tile_h - 1.5)
    za, zb, zc = setup[:, 9], setup[:, 10], setup[:, 11]
    X = torch.where(za >= 0, x0, x1)
    Y = torch.where(zb >= 0, y0, y1)
    z = (za * X + zc) + zb * Y            # the kernels' order, unfused
    z = torch.clamp(torch.nan_to_num(z, nan=0.0, posinf=torch.inf,
                                     neginf=0.0), min=0.0)
    empty = (bbox[:, 2] <= bbox[:, 0]) | (bbox[:, 3] <= bbox[:, 1])
    return torch.where(empty, torch.inf, z)


def bin_tiles(bbox: Tensor, width: int, height: int, tile_w: int,
              tile_h: int, cap: int, y0: int = 0,
              occ_bound: Tensor | None = None) -> ChunkBins:
    """Bin chunks to tiles from per-triangle (T, 4) pixel bboxes
    (ops/vertex.TriangleSetup.bbox; invalid triangles carry empty boxes).
    ``y0``: the global row of the grid's first row, for the grid of a
    contiguous row band of ``height`` rows (the bboxes are integers, so
    the shift is exact).  ``occ_bound``: the (T,) ``depth_bound`` of the
    triangles on this grid's tile size; each tile's list is then ordered
    nearest chunk first (ties by id), the cap drops the farthest, and the
    bins carry the chunks' bounds (their triangles' minimum)."""
    dev = bbox.device
    T = bbox.shape[0]
    C = T // CHUNK_SIZE
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    num_tiles = tiles_x * tiles_y

    bt = bbox.T.reshape(4, C, CHUNK_SIZE)
    cx0 = bt[0].amin(-1)
    cy0 = bt[1].amin(-1)
    cx1 = bt[2].amax(-1)
    cy1 = bt[3].amax(-1)
    nonempty = (cx1 > cx0) & (cy1 > cy0)
    sb = bt.reshape(4, C, SUBS_PER_CHUNK, SUBBATCH)
    sx0 = sb[0].amin(-1)                        # (C, SUBS_PER_CHUNK)
    sy0 = sb[1].amin(-1)
    sx1 = sb[2].amax(-1)
    sy1 = sb[3].amax(-1)

    def tile_of(v, size, n):
        return torch.clamp(torch.div(v, size, rounding_mode="floor")
                           .to(torch.int64), 0, n - 1)

    tx0 = tile_of(cx0, tile_w, tiles_x)
    ty0 = tile_of(cy0 - y0, tile_h, tiles_y)
    tx1 = tile_of(cx1 - 1.0, tile_w, tiles_x)
    ty1 = tile_of(cy1 - 1.0 - y0, tile_h, tiles_y)
    span_w = tx1 - tx0 + 1
    span = torch.where(nonempty, span_w * (ty1 - ty0 + 1), 0)

    # Expand every chunk over the tiles of its bbox.
    n_pairs = int(span.sum())
    cid = torch.repeat_interleave(torch.arange(C, device=dev), span,
                                  output_size=n_pairs)
    first = torch.cumsum(span, 0) - span
    j = torch.arange(n_pairs, device=dev) - first[cid]
    sw = span_w[cid]
    txi = tx0[cid] + j % sw
    tyi = ty0[cid] + torch.div(j, sw, rounding_mode="floor")

    # Keep a pair when a subbatch bbox of the chunk overlaps the tile
    # (global tile bounds).
    px0 = (txi * tile_w).to(torch.float32)[:, None]
    py0 = (tyi * tile_h + y0).to(torch.float32)[:, None]
    hit = ((sx0[cid] < px0 + tile_w) & (sx1[cid] > px0)
           & (sy0[cid] < py0 + tile_h) & (sy1[cid] > py0)).any(1)
    # One key per kept pair, tile-major; with a bound the tile's chunks
    # go nearest first: key (tile·RANKS + rank)·C + chunk, rank the bound
    # quantised (monotone, so ties keep id order).
    ranks = 1 if occ_bound is None else RANKS
    if num_tiles * ranks * C >= 2 ** 62:
        raise ValueError("binning key overflows int64")
    tkey = tyi * tiles_x + txi
    bound = None
    if occ_bound is not None:
        bound = occ_bound.reshape(C, CHUNK_SIZE).amin(-1)
        rank = torch.clamp(bound * RANKS, 0, RANKS - 1).to(torch.int64)
        tkey = tkey * RANKS + rank[cid]
    sentinel = num_tiles * ranks * C
    key = torch.where(hit, tkey * C + cid, sentinel)
    skey = torch.sort(key).values

    tids = torch.arange(num_tiles, device=dev, dtype=torch.int64)
    start = torch.searchsorted(skey, tids * (ranks * C))
    raw = torch.searchsorted(skey, (tids + 1) * (ranks * C)) - start
    chunk = torch.where(skey < sentinel, skey % C, -1).to(torch.int32)
    # num_tiles for the padding
    tile = torch.div(skey, ranks * C, rounding_mode="floor")
    pos = torch.arange(n_pairs, device=dev) \
        - start[torch.clamp(tile, max=num_tiles - 1)]
    kept = (skey < sentinel) & (pos < cap)
    return ChunkBins(
        start=start.to(torch.int32),
        count=torch.clamp(raw, max=cap).to(torch.int32),
        chunk=chunk,
        pair_tile=torch.where(kept, tile, -1).to(torch.int32),
        overflow=torch.clamp(raw - cap, min=0).sum().to(torch.int32),
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
        bound=bound)


def interleave_bins(bins: ChunkBins, k: int, n: int) -> ChunkBins:
    """Band k of n interleaved row bands of the full grid's ``bins``: its
    tile row j is the full grid's tile row j·n + k (the counterpart of
    ``_slice_stream_bins``, kanirenderer_tpu/ops/raster_pallas.py:1202).
    ``start``/``count`` are gathered; rows past the full grid (the padding
    of the last band) are empty.  ``chunk`` is shared and ``pair_tile``
    still names full-grid tiles.  ``overflow`` is this band's share, so
    the bands' overflows sum to the full grid's."""
    tx = bins.tiles_x
    J = -(-bins.tiles_y // n)
    rows = torch.arange(J, device=bins.start.device) * n + k
    live = rows < bins.tiles_y
    tiles = (torch.clamp(rows, max=bins.tiles_y - 1)[:, None] * tx
             + torch.arange(tx, device=rows.device)).reshape(-1)
    live = live.repeat_interleave(tx)
    # Entries per tile before the cap: the distance to the next tile's
    # start; the last tile's ends at the last entry with a chunk.
    end = torch.cat([bins.start[1:],
                     (bins.chunk >= 0).sum().to(torch.int32)[None]])
    dropped = end - bins.start - bins.count
    return bins._replace(
        start=torch.where(live, bins.start[tiles], 0),
        count=torch.where(live, bins.count[tiles], 0),
        overflow=torch.where(live, dropped[tiles], 0).sum().to(torch.int32),
        tiles_y=J)
