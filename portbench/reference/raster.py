"""Frozen copy of the plain PyTorch versions of the raster kernels K1, K2
and K2w in ``kanirenderer_tpu_torch/ops/raster_cuda.py`` (commit 1e399aa):
``rasterize_depth_plain`` and ``rasterize_pixels_plain`` and their helpers,
the benchmark's plain reference raster; only its imports were changed.
They compute, from the binned (tile, chunk) pairs, the same function as
the kernels with the same floating-point order: the kernels are bit-equal
to them on the card.
"""

from __future__ import annotations

import torch

from portbench.reference.binning import ChunkBins
from portbench.reference.interpolate import (LSUM0, PAR0, REC0,
                                             PixelBuffer)
from portbench.reference.types import CHUNK_SIZE
from portbench.reference.vertex import USED

Tensor = torch.Tensor


def _pixel_buffer(z, vary, ints, bins) -> PixelBuffer:
    return PixelBuffer(varyings=vary, mat_id=ints[0], tex_w=ints[1],
                       tex_h=ints[2], blk_base=ints[3], blk_w=ints[4],
                       mask=ints[5] >= 0, z=z, overflow=bins.overflow,
                       tid=ints[5])


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  They walk the binned (tile, chunk) pairs in
# batches: every triangle of the pair's chunk against every pixel of the
# pair's tile, the triangles whose bbox misses the tile masked out exactly
# as the kernels skip them.  They read the per-tile ``start``/``count`` of
# the bins and never ``pair_tile``.  Memory per batch ≈ 40 bytes ·
# PAIR_BATCH · CHUNK_SIZE · tile pixels (≈ 0.7 GB with 16×16 tiles).

PAIR_BATCH = 512


def _pairs(bins: ChunkBins):
    """(tile, chunk) int64 index pairs of every kept bin entry."""
    dev = bins.chunk.device
    count = bins.count.to(torch.int64)
    tile = torch.repeat_interleave(
        torch.arange(count.shape[0], device=dev), count)
    first = torch.cumsum(count, 0) - count
    pos = torch.arange(tile.shape[0], device=dev) - first[tile]
    chunk = bins.chunk.to(torch.int64)[bins.start.to(torch.int64)[tile] + pos]
    return tile, chunk


def _tile_origin(tile: Tensor, bins: ChunkBins, y0: int, y_stride: int):
    """Global (x, y) of each tile's first pixel: the bins' tile row j is
    global rows y0 + j·y_stride·tile_h onwards."""
    return (tile % bins.tiles_x * bins.tile_w,
            y0 + tile // bins.tiles_x * (y_stride * bins.tile_h))


def _bbox_hits(bbox: Tensor, tile: Tensor, chunk: Tensor, bins: ChunkBins,
               y0: int = 0, y_stride: int = 1):
    """(triangle ids (P, 128), hit (P, 128)): the triangles of each pair's
    chunk and whether their bbox meets the pair's tile, the kernels' cull."""
    tw, th = bins.tile_w, bins.tile_h
    tri = chunk[:, None] * CHUNK_SIZE \
        + torch.arange(CHUNK_SIZE, device=bbox.device)
    b = bbox[tri]
    tx0, ty0 = (o.to(torch.float32)[:, None]
                for o in _tile_origin(tile, bins, y0, y_stride))
    return tri, (b[..., 0] < tx0 + tw) & (b[..., 2] > tx0) \
        & (b[..., 1] < ty0 + th) & (b[..., 3] > ty0)


def _eval_pairs(rows: Tensor, bbox: Tensor, tile: Tensor, chunk: Tensor,
                bins: ChunkBins, width: int, height: int,
                wire_thresh: float | None = None, y0: int = 0,
                y_stride: int = 1, out_y0: int = 0,
                out_h: int | None = None):
    """Coverage and depth of every triangle of each pair's chunk at every
    pixel of its tile → (covered (P,128,px), z (P,128,px), pixel (P,px)),
    pixel = row-major index into the output of rows [out_y0, out_y0 +
    out_h) of the bins' grid (default: all ``height``), or width·out_h
    outside it or outside the width × height raster.  The grid's tile row
    j lies at global rows y0 + j·y_stride·tile_h (``_tile_origin``), where
    the planes are evaluated.  With ``wire_thresh``, coverage is the
    wireframe one."""
    dev = rows.device
    tw, th = bins.tile_w, bins.tile_h
    out_h = height if out_h is None else out_h
    lpix = torch.arange(tw * th, device=dev)
    tx0, ty0 = _tile_origin(tile, bins, y0, y_stride)
    x = tx0[:, None] + lpix % tw
    y = ty0[:, None] + lpix // tw
    row = (tile // bins.tiles_x * th - out_y0)[:, None] + lpix // tw
    X = (x.to(torch.float32) + 0.5)[:, None, :]
    Y = (y.to(torch.float32) + 0.5)[:, None, :]
    tri, hit = _bbox_hits(bbox, tile, chunk, bins, y0, y_stride)
    r = rows[:, :12][tri]                                 # (P, 128, 12)

    def plane(k):  # (a·X + c) + b·Y, the kernels' order
        return (r[..., k, None] * X + r[..., k + 2, None]) \
            + r[..., k + 1, None] * Y

    l0, l1, l2, z = plane(0), plane(3), plane(6), plane(9)
    covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0) \
        & (1.0 - z >= 0) & hit[..., None]
    if wire_thresh is not None:
        def dist(k):  # (a·X + c)·g + (b·Y)·g, raster_common.cuh edge_dist
            a, bb = r[..., k], r[..., k + 1]
            g = (1.0 / torch.sqrt(a * a + bb * bb + 1e-30))[..., None]
            return (a[..., None] * X + r[..., k + 2, None]) * g \
                + (bb[..., None] * Y) * g

        d = torch.minimum(torch.minimum(dist(0), dist(3)), dist(6))
        covered &= d <= wire_thresh
    inside = (x < width) & (y < height) & (row >= 0) & (row < out_h)
    pixel = torch.where(inside, row * width + x, width * out_h)
    return covered, z, pixel


def rasterize_depth_plain(setup: Tensor, bbox: Tensor, bins: ChunkBins,
                          dim: int, y0: int = 0,
                          band_h: int | None = None) -> Tensor:
    """Plain PyTorch K1 (same inputs and result as ``rasterize_depth``)."""
    band_h = dim if band_h is None else band_h
    out = torch.ones(band_h * dim + 1, dtype=torch.float32,
                     device=setup.device)
    tile, chunk = _pairs(bins)
    ty0 = tile // bins.tiles_x * bins.tile_h
    meets = (ty0 < y0 + band_h) & (ty0 + bins.tile_h > y0)
    tile, chunk = tile[meets], chunk[meets]
    for s in range(0, tile.shape[0], PAIR_BATCH):
        cov, z, pix = _eval_pairs(setup, bbox, tile[s:s + PAIR_BATCH],
                                  chunk[s:s + PAIR_BATCH], bins, dim, dim,
                                  out_y0=y0, out_h=band_h)
        zc = torch.where(cov, z, 1.0).amin(1)
        out.scatter_reduce_(0, pix.reshape(-1), zc.reshape(-1), "amin")
    return out[:-1].reshape(band_h, dim)


def _tournament(rows: Tensor, bbox: Tensor, bins: ChunkBins, width: int,
                height: int, wire_thresh: float | None, y0: int = 0,
                y_stride: int = 1, band_h: int | None = None):
    """Phase 1 of K2/K3: per pixel the lexicographic min of (z, triangle
    id) over candidates with z < 1 → (tid, z), each (band_h·W,), −1 and
    1.0 where nothing wins.  Each pair reduces its chunk to (z, lowest id
    at that z), then the pixel minimum of z is scattered and the lowest id
    among the pairs that reach it — the strict-< ascending tournament of
    the kernels."""
    dev = rows.device
    band_h = height if band_h is None else band_h
    hw = width * band_h
    tile, chunk = _pairs(bins)
    zbuf = torch.ones(hw + 1, dtype=torch.float32, device=dev)
    kept = []
    lane = torch.arange(CHUNK_SIZE, device=dev)[None, :, None]
    for s in range(0, tile.shape[0], PAIR_BATCH):
        ch = chunk[s:s + PAIR_BATCH]
        cov, z, pix = _eval_pairs(rows, bbox, tile[s:s + PAIR_BATCH], ch,
                                  bins, width, height, wire_thresh, y0,
                                  y_stride, out_h=band_h)
        zc = torch.where(cov & (z < 1.0), z, 2.0)
        pz = zc.amin(1)
        k = torch.where(zc == pz[:, None], lane, CHUNK_SIZE).amin(1)
        pid = (ch[:, None] * CHUNK_SIZE + k).to(torch.int32)
        zbuf.scatter_reduce_(0, pix.reshape(-1), pz.reshape(-1), "amin")
        kept.append((pz, pid, pix))
    big = torch.iinfo(torch.int32).max
    tbuf = torch.full((hw + 1,), big, dtype=torch.int32, device=dev)
    for pz, pid, pix in kept:
        cand = torch.where((pz < 1.0) & (pz == zbuf[pix]), pid, big)
        tbuf.scatter_reduce_(0, pix.reshape(-1), cand.reshape(-1), "amin")
    tid = torch.where(tbuf[:-1] == big, -1, tbuf[:-1])
    return tid, zbuf[:-1]


def _pixel_centres(width: int, height: int, device, y0: int = 0,
                   y_stride: int = 1, tile_h: int = 1):
    """Global pixel centres of the rows of a band: row r is global row
    y0 + (r // tile_h)·y_stride·tile_h + r % tile_h."""
    p = torch.arange(width * height, device=device)
    X = (p % width).to(torch.float32) + 0.5
    r = torch.div(p, width, rounding_mode="floor")
    y = y0 + r // tile_h * (y_stride * tile_h) + r % tile_h
    return X, y.to(torch.float32) + 0.5


def rasterize_pixels_plain(records: Tensor, setup: Tensor, bbox: Tensor,
                           bins: ChunkBins, width: int, height: int,
                           wireframe: bool = False, wire_thresh: float = 0.7,
                           y0: int = 0, y_stride: int = 1,
                           band_h: int | None = None) -> PixelBuffer:
    """Plain PyTorch K2/K2w (same inputs and result as
    ``rasterize_pixels``): the phase-1 tournament on the setup rows, then
    phase 2 on the records."""
    dev = records.device
    band_h = height if band_h is None else band_h
    tid, z_out = _tournament(setup, bbox, bins, width, height,
                             wire_thresh if wireframe else None, y0,
                             y_stride, band_h)

    # Phase 2: interpolate the winner's record at the pixel centre.
    covered = tid >= 0
    rec = records[tid.clamp(min=0).to(torch.int64)]        # (HW, 76)
    X, Y = _pixel_centres(width, band_h, dev, y0, y_stride, bins.tile_h)

    def plane(k):  # ((a·X) + (b·Y)) + c, the reference's phase-2 order
        return (rec[:, k] * X + rec[:, k + 1] * Y) + rec[:, k + 2]

    l1, l2, lsum = plane(3), plane(6), plane(LSUM0)
    lsafe = torch.where(lsum != 0.0, lsum, 1e-30)
    w1 = (l1 / lsafe)[:, None]
    w2 = (l2 / lsafe)[:, None]
    vary = (rec[:, REC0:REC0 + USED] + rec[:, REC0 + USED:REC0 + 2 * USED]
            * w1) + rec[:, REC0 + 2 * USED:REC0 + 3 * USED] * w2
    vary = torch.where(covered[:, None], vary, 0.0)
    par = rec[:, PAR0:PAR0 + 6].to(torch.int32)
    ints = torch.stack([par[:, 0], par[:, 1], par[:, 2],
                        par[:, 3] * 65536 + par[:, 4], par[:, 5]])
    default = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32,
                           device=dev)[:, None]
    ints = torch.cat([torch.where(covered, ints, default), tid[None]])
    return _pixel_buffer(z_out.reshape(band_h, width),
                         vary.T.reshape(USED, band_h, width),
                         ints.reshape(6, band_h, width), bins)
