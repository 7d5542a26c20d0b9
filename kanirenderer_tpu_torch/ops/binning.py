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
    pair_tile: Tensor  # (N,) i32 tile of each entry, −1 where not kept
    overflow: Tensor  # () i32 entries dropped by the per-tile cap
    tiles_x: int
    tiles_y: int
    tile_w: int
    tile_h: int


def bin_tiles(bbox: Tensor, width: int, height: int, tile_w: int,
              tile_h: int, cap: int, y0: int = 0) -> ChunkBins:
    """Bin chunks to tiles from per-triangle (T, 4) pixel bboxes
    (ops/vertex.TriangleSetup.bbox; invalid triangles carry empty boxes).
    ``y0``: the global row of the grid's first row, for the grid of a
    contiguous row band of ``height`` rows (the bboxes are integers, so
    the shift is exact)."""
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
    sentinel = num_tiles * C
    key = torch.where(hit, (tyi * tiles_x + txi) * C + cid, sentinel)
    skey = torch.sort(key).values

    tids = torch.arange(num_tiles, device=dev, dtype=torch.int64)
    start = torch.searchsorted(skey, tids * C)
    raw = torch.searchsorted(skey, (tids + 1) * C) - start
    chunk = torch.where(skey < sentinel, skey % C, -1).to(torch.int32)
    tile = torch.div(skey, C, rounding_mode="floor")    # num_tiles: padding
    pos = torch.arange(n_pairs, device=dev) \
        - start[torch.clamp(tile, max=num_tiles - 1)]
    kept = (skey < sentinel) & (pos < cap)
    return ChunkBins(
        start=start.to(torch.int32),
        count=torch.clamp(raw, max=cap).to(torch.int32),
        chunk=chunk,
        pair_tile=torch.where(kept, tile, -1).to(torch.int32),
        overflow=torch.clamp(raw - cap, min=0).sum().to(torch.int32),
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)


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
