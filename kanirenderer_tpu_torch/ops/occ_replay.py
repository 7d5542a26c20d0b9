"""Replay of the CUDA kernels' occlusion skip, and the gate built on it.

Counterpart of ``kanirenderer_tpu/ops/occ_replay.py``, replaying the
port's rule (csrc/raster_common.cuh), not the Pallas one.  A tile's
chunks, in the order of its bin list (nearest first where the bins carry
bounds), are culled in rounds of 16 (K2, K2w, K3: a tile's whole list;
K1: each run of one tile within a block's 8 bin entries is one round).  At the start
of a round the tile takes the greatest resolved depth of its stored
pixels, and a chunk whose bound (``ChunkBins.bound``) is greater is
skipped.  The round's hits are laid out chunk by chunk, ascending row
within a chunk, and visited in batches of 32; before each batch a warp
takes the greatest resolved depth of its stored pixels, and a hit whose
least depth over the warp's pixel rectangle is greater is dropped,
beside the exact per-warp edge rejections.

``replay`` counts what the kernels count (ops/raster_cuda.OCC_COUNTS)
and rasterizes only the warp visits the rule keeps, so its depth (and
winner) buffers are a raster with the rule's skips, which must equal the
plain raster without them.  For K2, K2w and K3 the counts are the
kernel's exactly (each decision depends on the tile's own state only).
K1's blocks also start from the map that other blocks have lowered, so
its kernel's state is never above the replay's: it skips and drops at
least what the replay says.  Every plane is evaluated in the kernels'
order with no fused multiply-add, in float32, on any device.

``estimate_main_grid_occlusion`` runs the port's geometry and binning at
a pose on the scene's device and replays a sample of the main grid's
tiles on the host; ``choose_occ_scope`` turns the estimate into the
load-time gate of ``KANI_OCC=auto`` (api.run).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kanirenderer_tpu_torch.core.types import CHUNK_SIZE, RenderConfig
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops.binning import ChunkBins

Tensor = torch.Tensor

K_ROUND = 16       # csrc/raster_common.cuh kRound
K_BATCH = 32       # csrc/raster_common.cuh kBatch
K1_SLICE = 8       # csrc/raster_depth.cu kSlice
VISIT_BATCH = 65536  # warp visits evaluated at a time (~8 KB each)


class Replay(NamedTuple):
    counts: dict      # OCC_COUNTS → int
    z: Tensor | None  # (band_h, width) resolved depth, 1.0 where none
    tid: Tensor | None  # (band_h, width) i32 winner, −1 (K2/K3 only)


def _lanes(tile_w: int, tile_h: int, device):
    """(lx, ly), each (warps, 32): the pixel of every thread of a tile's
    block, as csrc/raster_common.cuh tile_pixel lays them out."""
    t = torch.arange(tile_w * tile_h, device=device)
    if tile_w % 8 == 0 and tile_h % 4 == 0:
        patch, lane, across = t // 32, t % 32, tile_w // 8
        lx = patch % across * 8 + lane % 8
        ly = patch // across * 4 + lane // 8
    else:
        lx, ly = t % tile_w, t // tile_w
    return lx.reshape(-1, 32), ly.reshape(-1, 32)


def _plane(a, b, c, X, Y):
    return (a * X + c) + b * Y      # the kernels' order, unfused


def _items(bins: ChunkBins, depth_only: bool, tiles, entries):
    """The work items (one state each): (tile of each item, chunk of each
    (item, position) pair, its item, its position)."""
    dev = bins.chunk.device
    if depth_only:   # K1: runs of one tile within each block's 8 entries
        e0, e1 = entries if entries is not None else (0,
                                                      bins.chunk.shape[0])
        tile = bins.pair_tile[e0:e1].to(torch.int64)
        chunk = bins.chunk[e0:e1].to(torch.int64)
        idx = torch.arange(tile.shape[0], device=dev)
        new = torch.ones_like(tile, dtype=torch.bool)
        new[1:] = (tile[1:] != tile[:-1]) | (idx[1:] % K1_SLICE == 0)
        item = torch.cumsum(new.to(torch.int64), 0) - 1
        first = torch.nonzero(new).reshape(-1)
        pos = idx - first[item]
        live = tile >= 0
        item_tile = tile[first]
        # renumber the items that hold chunks
        keep = item_tile >= 0
        remap = torch.cumsum(keep.to(torch.int64), 0) - 1
        return (item_tile[keep], chunk[live], remap[item[live]], pos[live])
    nt = bins.tiles_x * bins.tiles_y
    sel = torch.arange(nt, device=dev) if tiles is None \
        else torch.as_tensor(tiles, dtype=torch.int64, device=dev)
    count = bins.count.to(torch.int64)[sel]
    item = torch.repeat_interleave(torch.arange(sel.shape[0], device=dev),
                                   count)
    first = torch.cumsum(count, 0) - count
    pos = torch.arange(item.shape[0], device=dev) - first[item]
    chunk = bins.chunk.to(torch.int64)[
        bins.start.to(torch.int64)[sel][item] + pos]
    return sel, chunk, item, pos


def _resolve(setup, ht, hi, visit, X, Y, zst, tid, wire_thresh,
             depth_only):
    """Evaluate the kept (hit, warp) visits at their warps' 32 pixels and
    fold them into the state: the least depth (K1), or the (z, id)
    lexicographic least (K2, K3), as the kernels' tournament keeps it."""
    dev = setup.device
    n_warps = X.shape[1]
    big = torch.iinfo(torch.int32).max
    vh_all, vw_all = torch.nonzero(visit, as_tuple=True)
    for s in range(0, vh_all.shape[0], VISIT_BATCH):
        vh, vw = vh_all[s:s + VISIT_BATCH], vw_all[s:s + VISIT_BATCH]
        vi = hi[vh]
        q = setup[ht[vh]][:, :12, None]                 # (V, 12, 1)
        Xv, Yv = X[vi, vw], Y[vi, vw]                   # (V, 32)
        l0 = _plane(q[:, 0], q[:, 1], q[:, 2], Xv, Yv)
        l1 = _plane(q[:, 3], q[:, 4], q[:, 5], Xv, Yv)
        l2 = _plane(q[:, 6], q[:, 7], q[:, 8], Xv, Yv)
        z = _plane(q[:, 9], q[:, 10], q[:, 11], Xv, Yv)
        cov = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0) & (1.0 - z >= 0)
        if wire_thresh is not None:
            def dist(k):          # raster_common.cuh edge_dist
                a, b_ = q[:, k], q[:, k + 1]
                gk = 1.0 / torch.sqrt(a * a + b_ * b_ + 1e-30)
                return (a * Xv + q[:, k + 2]) * gk + (b_ * Yv) * gk
            d = torch.minimum(torch.minimum(dist(0), dist(3)), dist(6))
            cov &= d <= wire_thresh
        flat = ((vi * n_warps + vw)[:, None] * 32
                + torch.arange(32, device=dev)).reshape(-1)
        zc = torch.where(cov, z, 2.0).reshape(-1)
        zf = zst.reshape(-1)
        newz = zf.clone().scatter_reduce_(0, flat, zc, "amin")
        if not depth_only:
            cid = torch.where(cov, ht[vh][:, None].to(torch.int32),
                              big).reshape(-1)
            cid = torch.where(zc == newz[flat], cid, big)
            keep_id = torch.where(zf == newz, tid.reshape(-1), big)
            tid = keep_id.scatter_reduce_(0, flat, cid,
                                          "amin").reshape(tid.shape)
        zst = newz.reshape(zst.shape)
    return zst, tid


def replay(setup: Tensor, bbox: Tensor, bins: ChunkBins, width: int,
           height: int, wire_thresh: float | None = None, *,
           depth_only: bool = False, y0: int = 0, y_stride: int = 1,
           band_h: int | None = None, entries: tuple | None = None,
           tiles=None, raster: bool = True) -> Replay:
    """Replay a kernel's occlusion rule on its inputs.  ``depth_only``:
    K1 on map rows [y0, y0 + band_h) from ``entries`` (raster_cuda
    ``band_entries``; default all), else K2/K3 (``wire_thresh``: the
    wireframe coverage) on a band's bins as ``rasterize_pixels`` takes
    them (``y0``, ``y_stride``, ``band_h``); ``tiles``: replay only those
    tiles (K2/K3).  Without ``raster`` and without bounds only the counts
    are made (nothing to resolve)."""
    dev = setup.device
    band_h = height if band_h is None else band_h
    tw, th = bins.tile_w, bins.tile_h
    occ = bins.bound is not None
    item_tile, chunk, item, pos = _items(bins, depth_only, tiles, entries)
    n_items = item_tile.shape[0]
    rnd = torch.div(pos, K1_SLICE if depth_only else K_ROUND,
                    rounding_mode="floor")   # K1: one round per run

    # Per item: its tile's origin, its threads' pixels and which are stored.
    lx, ly = _lanes(tw, th, dev)                        # (Wp, 32)
    n_warps = lx.shape[0]
    if depth_only:
        tx0, ty0 = rc._tile_origin(item_tile, bins, 0, 1)
    else:
        tx0, ty0 = rc._tile_origin(item_tile, bins, y0, y_stride)
    px = tx0[:, None, None] + lx                        # (I, Wp, 32)
    py = ty0[:, None, None] + ly
    if depth_only:
        stored = (px < width) & (py < height) & (py >= y0) \
            & (py < y0 + band_h)
        out_row = py - y0
    else:
        by = (item_tile // bins.tiles_x * th)[:, None, None] + ly
        stored = (px < width) & (py < height) & (by < band_h)
        out_row = by
    X = px.to(torch.float32) + 0.5
    Y = py.to(torch.float32) + 0.5
    rx0, rx1 = X.amin(-1), X.amax(-1)                   # (I, Wp)
    ry0, ry1 = Y.amin(-1), Y.amax(-1)
    zst = torch.ones((n_items, n_warps, 32), dtype=torch.float32,
                     device=dev)
    tid = torch.full((n_items, n_warps, 32), -1, dtype=torch.int32,
                     device=dev)
    resolve = raster or occ
    counts = dict.fromkeys(rc.OCC_COUNTS, 0)

    def warp_max():
        return torch.where(stored, zst, 0.0).amax(-1)   # (I, Wp)

    for r in range(int(rnd.max()) + 1 if rnd.numel() else 0):
        sel = rnd == r
        it, ch = item[sel], chunk[sel]         # item-major, list order
        if occ:
            skip = bins.bound[ch] > warp_max().amax(-1)[it]
            counts["chunks_tested"] += int(ch.shape[0])
            counts["chunks_skipped"] += int(skip.sum())
            it, ch = it[~skip], ch[~skip]
        tri = ch[:, None] * CHUNK_SIZE + torch.arange(CHUNK_SIZE,
                                                      device=dev)
        b = bbox[tri]
        ftx0 = tx0[it].to(torch.float32)[:, None]
        fty0 = ty0[it].to(torch.float32)[:, None]
        hit = (b[..., 0] < ftx0 + tw) & (b[..., 2] > ftx0) \
            & (b[..., 1] < fty0 + th) & (b[..., 3] > fty0)
        h_item = it[:, None].expand_as(tri)[hit]       # the hit list, in
        h_tri = tri[hit]                               # the kernels' order
        if h_tri.numel() == 0:
            continue
        first = torch.searchsorted(h_item, h_item, right=False)
        batch = torch.div(torch.arange(h_item.shape[0], device=dev) - first,
                          K_BATCH, rounding_mode="floor")
        for bt in range(int(batch.max()) + 1 if occ else 1):
            sel_b = batch == bt if occ else slice(None)
            hi, ht = h_item[sel_b], h_tri[sel_b]
            p = setup[ht][:, :12, None]                 # (H, 12, 1)
            x0, x1 = rx0[hi], rx1[hi]                   # (H, Wp)
            y0r, y1r = ry0[hi], ry1[hi]

            def corner(a, b_, c, low):
                # the plane's greatest (least with ``low``) value over
                # the warp rectangle: raster_common.cuh edge_max/depth_min
                pos_a, pos_b = (a >= 0), (b_ >= 0)
                if low:
                    pos_a, pos_b = ~pos_a, ~pos_b
                return _plane(a, b_, c, torch.where(pos_a, x1, x0),
                              torch.where(pos_b, y1r, y0r))

            keep = ~(corner(p[:, 0], p[:, 1], p[:, 2], False) < 0) \
                & ~(corner(p[:, 3], p[:, 4], p[:, 5], False) < 0) \
                & ~(corner(p[:, 6], p[:, 7], p[:, 8], False) < 0)
            if wire_thresh is not None:
                g = [1.0 / torch.sqrt(p[:, k] * p[:, k]
                                      + p[:, k + 1] * p[:, k + 1] + 1e-30)
                     for k in (0, 3, 6)]

                def dist_min(k, gk):   # raster_common.cuh edge_dist_min
                    a, b_, c = p[:, k], p[:, k + 1], p[:, k + 2]
                    Xc = torch.where(a >= 0, x0, x1)
                    Yc = torch.where(b_ >= 0, y0r, y1r)
                    return (a * Xc + c) * gk + (b_ * Yc) * gk

                far = (dist_min(0, g[0]) > wire_thresh) \
                    & (dist_min(3, g[1]) > wire_thresh) \
                    & (dist_min(6, g[2]) > wire_thresh)
                keep &= ~far
            visit = keep
            if occ:
                visit = keep & ~(corner(p[:, 9], p[:, 10], p[:, 11], True)
                                 > warp_max()[hi])
                counts["hits_dropped"] += int((keep & ~visit).sum())
            counts["visits"] += int(visit.sum())
            if resolve:
                zst, tid = _resolve(setup, ht, hi, visit, X, Y, zst, tid,
                                    wire_thresh, depth_only)

    if not raster:
        return Replay(counts, None, None)
    # Assemble the stored pixels of every item: K1 the least over items.
    flat = (out_row * width + px)[stored]
    zmap = torch.ones(band_h * width, dtype=torch.float32, device=dev)
    zmap.scatter_reduce_(0, flat, zst[stored], "amin")
    if depth_only:
        return Replay(counts, zmap.reshape(band_h, width), None)
    tmap = torch.full((band_h * width,), -1, dtype=torch.int32, device=dev)
    tmap[flat] = tid[stored]
    return Replay(counts, zmap.reshape(band_h, width),
                  tmap.reshape(band_h, width))


def simulate_tile(setup: Tensor, bbox: Tensor, bins: ChunkBins, tile: int,
                  width: int, height: int,
                  wire_thresh: float | None = None) -> dict:
    """The counts of one tile of K2/K3's rule (``replay``)."""
    return replay(setup, bbox, bins, width, height, wire_thresh,
                  tiles=[tile], raster=False).counts


def skipped_share(on: dict, off: dict) -> float:
    """The share of the evaluations (warp visits) without the skip that
    the skip spares."""
    return 1.0 - on["visits"] / off["visits"] if off["visits"] else 0.0


def estimate_main_grid_occlusion(scene, state, cfg: RenderConfig,
                                 tile_stride: int = 4) -> dict:
    """Estimated main-grid skip at ``state``'s pose: the port's geometry
    and binning (nearest first) on the scene's device, then the rule
    replayed on the host over every ``tile_stride``-th tile (tiles are
    independent, so the sample is unbiased), with and without the skip.
    Returns ``eval_drop`` (the share of warp visits spared), ``run_skip``
    (the share of chunks skipped), the sampled counts and the stride."""
    from kanirenderer_tpu_torch.ops.binning import bin_tiles, depth_bound
    from kanirenderer_tpu_torch.passes.frame import frame_geometry

    g = frame_geometry(scene, state, cfg, light_space=False,
                       main_bins=False)
    st = g.setup
    bound = depth_bound(st.setup, st.bbox, cfg.tile_w, cfg.tile_h)
    cpu = torch.device("cpu")
    setup, bbox = st.setup.to(cpu), st.bbox.to(cpu)
    bins = bin_tiles(bbox, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile, occ_bound=bound.to(cpu))
    tiles = range(0, bins.tiles_x * bins.tiles_y, tile_stride)
    wire = cfg.wire_thresh_px if cfg.mode.name == "WIREFRAME" else None
    on = replay(setup, bbox, bins, cfg.width, cfg.height, wire,
                tiles=tiles, raster=False).counts
    off = replay(setup, bbox, bins._replace(bound=None), cfg.width,
                 cfg.height, wire, tiles=tiles, raster=False).counts
    return {"eval_drop": skipped_share(on, off),
            "run_skip": (on["chunks_skipped"] / on["chunks_tested"]
                         if on["chunks_tested"] else 0.0),
            "evals_sampled": off["visits"],
            "runs_sampled": on["chunks_tested"],
            "tile_stride": tile_stride}


# The break-even share of spared evaluations on the card, from
# ``python -m kanirenderer_tpu_torch.ops.raster_ablation break-even`` on
# one NVIDIA H100 80GB HBM3 at 700.00 W: K2 at 1920x1080 with the skip
# against without, at four measured points.  The sponza stand-in at the
# bench pose (0.315 of the evaluations spared) and layered_scene() with
# 4 walls (0.403) were 4.2% and 5.7% slower with the skip; 8 walls
# (0.573) 2.3% and 16 walls (0.724) 18.0% faster.  Net time crosses zero
# between the 4- and 8-wall points, at 0.524 on the line through them
# (the least-squares line through all four crosses at 0.457); a second
# run read 0.530 (0.458).  The machinery alone, its tests made never to
# fire, costs K2 8-19%; so the skip pays only where it spares over about
# half of the evaluations.
EVAL_DROP_THRESHOLD = 0.52


def choose_occ_scope(scene, state, cfg: RenderConfig, tile_stride: int = 4,
                     threshold: float = EVAL_DROP_THRESHOLD):
    """Load-time scope: "1" (every raster skips) when the estimated share
    of main-grid evaluations spared clears the break-even ``threshold``,
    else "shadow" (the depth-only raster only).  Returns (scope,
    estimate)."""
    est = estimate_main_grid_occlusion(scene, state, cfg, tile_stride)
    return ("1" if est["eval_drop"] >= threshold else "shadow"), est
