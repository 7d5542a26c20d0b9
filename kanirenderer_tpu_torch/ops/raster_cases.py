"""Adversarial inputs for the tile raster kernels K1, K2, K2w and K3.

Small synthetic triangle sets that drive the paths a real frame seldom
reaches: a hit list that overflows its shared-memory room (more bbox hits
in one tile than the list holds, so the kernel evaluates and refills), a
tile at its chunk cap with a counted overflow, tiles with no chunk, equal
depths across chunks (the lower triangle id must win), a raster that is no
multiple of the tile, NaN planes, wireframe interiors (triangles that
cover whole tiles, whole 8×4 patches and single pixels with no edge
within the threshold), and infinite and float32-overflowing plane
coefficients; for the occlusion skip, two layers of quads, the far one
first in id order (``two_layer_case``), and steep slivers whose depth at a
covered pixel centre lies below their lowest vertex depth, each behind an
occluder that sits between the two (``bound_case``).
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
kernels against their plain versions on them,
``tests/test_torch_raster.py`` and ``tests/test_torch_visibility.py`` the
plain versions against the JAX package's brute-force rasters.

The triangles of the first two cases are bands: one covers x ∈ [x0, x1),
y ≥ 4 at a constant depth.  All plane coefficients are small integers,
multiples of 2⁻¹² or powers of two, so every evaluation order gives the
same bits and any two correct rasters agree exactly; with wireframe
coverage they do so at a threshold that no edge distance comes near
(``WIRE_THRESH``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kanirenderer_tpu_torch.core.types import (CHUNK_SIZE, SUBBATCH,
                                               SUBS_PER_CHUNK)
from kanirenderer_tpu_torch.ops.binning import (ChunkBins, bin_tiles,
                                                depth_bound)
from kanirenderer_tpu_torch.ops.interpolate import (FAT_LANES, LSUM0, PAR0,
                                                    REC0)
from kanirenderer_tpu_torch.ops.vertex import NS, triangle_setup

Tensor = torch.Tensor

TILE = 16
# The wireframe threshold for the cases, in pixels.  Plane values at pixel
# centres are multiples of 1/2 here, and no edge of the cases has a length
# that brings a multiple of 1/2 divided by it within 1e-4 of this value
# (the float32 distances are within 1e-5 of the true ones).
WIRE_THRESH = 0.75


class RasterCase(NamedTuple):
    name: str
    setup: Tensor    # (T, 16) f32 setup rows
    bbox: Tensor     # (T, 4) f32 pixel bboxes
    records: Tensor  # (T, 76) f32 triangle records, lanes 0:16 = setup
    bins: ChunkBins
    width: int
    height: int
    kept: Tensor     # (T,) bool: triangles of chunks the binning kept


def _finish(name: str, setup: np.ndarray, bbox: np.ndarray, width: int,
            height: int, cap: int, device) -> RasterCase:
    """Records for the (T, 16) setup rows (random varyings and material
    lanes, made from a seed) and the bins of the bboxes."""
    T = setup.shape[0]
    assert T % CHUNK_SIZE == 0
    setup, bbox = setup.astype(np.float32), bbox.astype(np.float32)
    rng = np.random.RandomState(T + width)
    records = np.zeros((T, FAT_LANES), np.float32)
    records[:, :NS] = setup
    records[:, REC0:PAR0] = rng.standard_normal((T, PAR0 - REC0))
    records[:, PAR0:LSUM0] = rng.randint(0, 30000, (T, LSUM0 - PAR0))
    with np.errstate(invalid="ignore"):                # inf − inf
        records[:, LSUM0:] = setup[:, 0:3] + setup[:, 3:6] + setup[:, 6:9]
    setup_t, bbox_t, records_t = (torch.from_numpy(a).to(device)
                                  for a in (setup, bbox, records))
    bins = bin_tiles(bbox_t, width, height, TILE, TILE, cap)
    # Every triangle of a case with a cap meets the same tiles, so a chunk
    # is kept everywhere or nowhere: the first ``cap`` chunks are kept.
    kept = torch.arange(T, device=device) < cap * CHUNK_SIZE
    return RasterCase(name, setup_t, bbox_t, records_t, bins, width, height,
                      kept)


def _band_rows(x0, x1, z, height: int):
    """Setup rows and bboxes of bands x ∈ [x0[i], x1[i]), y ≥ 4 at depth
    z[i]."""
    T = len(x0)
    setup = np.zeros((T, NS), np.float32)
    setup[:, 0], setup[:, 2] = 1.0, -x0           # x − x0 ≥ 0
    setup[:, 3], setup[:, 5] = -1.0, x1           # x1 − x ≥ 0
    setup[:, 7], setup[:, 8] = 1.0, -4.0          # y − 4 ≥ 0
    setup[:, 11] = z
    setup[:, 15] = 1.0
    bbox = np.stack([x0, np.full(T, 4.0), x1, np.full(T, float(height))],
                    1).astype(np.float32)
    return setup, bbox


def _case(name: str, x0, x1, z, nan_rows, width: int, height: int,
          cap: int, device) -> RasterCase:
    """Bands x ∈ [x0[i], x1[i]), y ≥ 4 at depth z[i]; ``nan_rows`` get a
    NaN edge or depth coefficient and keep their bbox."""
    setup, bbox = _band_rows(np.asarray(x0, np.float64),
                             np.asarray(x1, np.float64), z, height)
    for k, i in enumerate(nan_rows):              # edge a, edge c, depth c
        setup[i, (3, 8, 11)[k % 3]] = np.nan
    return _finish(name, setup, bbox, width, height, cap, device)


def list_overflow_case(width: int, height: int, device,
                       chunks: int = 24) -> RasterCase:
    """24 chunks whose every triangle meets the left tiles (3,072 bbox
    hits in a tile), depths on a 1,024-step ladder so that each value
    recurs in three chunks, bands of varying width, one subbatch of every
    chunk reaching into the ragged right-hand tile column, tiles in
    between with no chunk, and a NaN plane in every 97th triangle.
    ``width`` must be at least 84."""
    i = np.arange(chunks * CHUNK_SIZE)
    x0 = 2.0 + (i % 13) * 2.0
    x1 = x0 + 6.0 + (i % 5)
    far = (i // SUBBATCH) % SUBS_PER_CHUNK == 3
    x0[far], x1[far] = width - 20.0 + (i[far] % 3), float(width)
    z = 0.25 + ((i * 7919) % 1024) / 4096.0
    return _case("hit list overflow, ties, ragged edge, NaN planes", x0, x1,
                 z, i[::97], width, height, 640, device)


def chunk_cap_case(cap: int, device, extra: int = 10,
                   dim: int = 32) -> RasterCase:
    """Every triangle of ``cap + extra`` chunks in the two tiles of the
    left column: binning keeps the ``cap`` lowest chunks of each tile and
    counts ``extra`` dropped per tile.  Every bbox meets its tile, so the
    hit list is full in every round.  The dropped chunks hold the nearest
    triangles, so a raster that walks them shows it."""
    i = np.arange((cap + extra) * CHUNK_SIZE)
    x0 = 1.0 + (i % 7)
    x1 = x0 + 3.0 + (i % 4)
    z = np.where(i < cap * CHUNK_SIZE, 0.5 + (i % 512) / 4096.0, 0.125)
    return _case(f"tiles at the {cap}-chunk cap, {extra} chunks dropped "
                 "in each", x0, x1, z, i[5::211], dim, dim, cap, device)


def _triangle_row(v, z: float):
    """Setup row and bbox of the triangle with integer pixel vertices
    ``v`` (3 × (x, y)) at constant depth ``z``: edge i is the plane through
    the two vertices other than i, positive inside, with integer
    coefficients (not normalised)."""
    v = np.asarray(v, np.float64)
    row = np.zeros(NS)
    for i in range(3):
        (xa, ya), (xb, yb) = v[(i + 1) % 3], v[(i + 2) % 3]
        a, b, c = ya - yb, xb - xa, xa * yb - xb * ya
        if a * v[i, 0] + b * v[i, 1] + c < 0:
            a, b, c = -a, -b, -c
        row[3 * i:3 * i + 3] = a, b, c
    row[11], row[15] = z, 1.0
    return row, np.array([v[:, 0].min(), v[:, 1].min(), v[:, 0].max(),
                          v[:, 1].max()])


def _pad_rows(rows, boxes, width: int, height: int):
    """Stack rows and bboxes and pad to a whole chunk with invalid
    triangles (e0.c = −1, empty bbox)."""
    T = -(-len(rows) // CHUNK_SIZE) * CHUNK_SIZE
    setup = np.zeros((T, NS), np.float32)
    setup[:, 2] = -1.0
    bbox = np.tile(np.array([width, height, 0, 0], np.float32), (T, 1))
    setup[:len(rows)] = np.stack(rows)
    bbox[:len(rows)] = np.stack(boxes)
    return setup, bbox


def wire_interior_case(device, width: int = 120, height: int = 72,
                       scale: int = 1) -> RasterCase:
    """Wireframe interiors: three triangles that span most of the raster,
    whose insides hold whole tiles and whole 8×4 patches farther than the
    threshold from every edge; slivers one or two pixels thin, whose every
    pixel is near an edge; and small triangles on a grid in between, so
    that single pixels of a patch pass.  The raster is ragged (120×72 on
    16×16 tiles).  ``scale`` multiplies every vertex: 16 spreads the same
    75 triangles over a 1920×1080 raster."""
    rows, boxes = [], []

    def add(v, z):
        row, box = _triangle_row(np.asarray(v) * scale, z)
        rows.append(row)
        boxes.append(box)

    add([(2, 2), (118, 8), (10, 70)], 0.5)       # spans 8 × 5 tiles
    add([(117, 70), (118, 12), (14, 71)], 0.625)
    add([(0, 0), (120, 0), (60, 72)], 0.75)      # cut by the raster's edge
    for k in range(6):                            # slivers across the tiles
        add([(3 + 7 * k, 5 * k + 3), (110 - 3 * k, 9 * k + 6),
             (3 + 7 * k, 5 * k + 4 + k % 2)], 0.25 + k / 64.0)
        add([(20 * k + 4, 2), (20 * k + 6, 70), (20 * k + 5 + k % 2, 2)],
            0.375 + k / 64.0)
    for k in range(60):                           # small ones, 12 × 12 grid
        x, y, e = 5 + 12 * (k % 10), 4 + 12 * (k // 10), 1 + k % 4
        add([(x, y), (x + e, y + k % 3), (x + k % 2, y + e)],
            0.125 + (k % 7) / 128.0)
    setup, bbox = _pad_rows(rows, boxes, width, height)
    return _finish("wireframe interiors: large triangles, slivers, small "
                   "triangles", setup, bbox, width, height, 640, device)


def nonfinite_case(device, width: int = 48, height: int = 40) -> RasterCase:
    """Bands with infinite and float32-overflowing coefficients in front of
    finite ones: a² + b² overflowing to g = 0 with finite plane values (the
    whole band is within the threshold), a·X overflowing from some column
    on (an infinite plane value, a NaN edge distance there: not covered
    with wireframe), infinite a or c of either sign, an overflowing b·Y,
    an overflowing depth plane, and inf − inf = NaN in an edge.  Only a
    row's first edge is ever infinite, and the barycentrics are those of
    the other two over the sum, so every output is a number."""
    big, inf = 2.0 ** 67, np.inf
    n = 12
    x0 = 2.0 + 3.0 * np.arange(n)
    setup, bbox = _band_rows(x0, x0 + 9.0, 0.25 + np.arange(n) / 64.0,
                             height)
    back, bbox_back = _band_rows(np.array([1.0, 20.0]),
                                 np.array([30.0, 47.0]),
                                 np.array([0.75, 0.875]), height)
    e = setup[:, 0:9]                              # view: three edge rows
    e[0, 0], e[0, 2] = big, -big * x0[0]           # g = 0, finite values
    e[1, 0], e[1, 2] = 2.0 ** 125, -2.0 ** 125 * x0[1]  # a·X = inf, X ≥ 8
    e[2, 0] = inf                                  # l0 = inf, d0 = NaN
    e[3, 2] = inf                                  # l0 = inf, d0 = inf
    e[4, 2] = -inf                                 # covers nothing
    e[5, 3] = -inf                                 # covers nothing
    e[6, 0:3] = 0.0, 2.0 ** 124, -2.0 ** 126       # b·Y = inf for Y ≥ 16
    e[6, 6:9] = 1.0, 0.0, -x0[6]                   # (the y edge comes first)
    e[7, 6:9] = big, big, -big * (x0[7] + 13.0)    # diagonal with g = 0
    e[8, 0], e[8, 2] = inf, -inf                   # inf − inf: NaN edge
    setup[9, 9], setup[9, 11] = 2.0 ** 125, 0.0    # depth overflows
    e[10, 3], e[10, 5] = -big, big * (x0[10] + 9.0)  # g = 0 on the far edge
    setup = np.concatenate([setup, back])
    bbox = np.concatenate([bbox, bbox_back])
    setup, bbox = _pad_rows(list(setup), list(bbox), width, height)
    return _finish("infinite and overflowing plane coefficients", setup,
                   bbox, width, height, 640, device)


def _clip_of(xy, z, width: int, height: int) -> np.ndarray:
    """(N, 4) clip rows (w = 1) of screen points ``xy`` at NDC depth z,
    for ops/vertex.triangle_setup's viewport."""
    xy = np.asarray(xy, np.float64)
    return np.stack([xy[:, 0] / width * 2.0 - 1.0,
                     1.0 - xy[:, 1] / height * 2.0,
                     np.broadcast_to(z, len(xy)), np.ones(len(xy))],
                    1).astype(np.float32)


def _setup_rows(clip: np.ndarray, width: int, height: int):
    """Setup rows, bboxes and vertex depth bounds (zmin) of consecutive
    vertex triples, through ops/vertex.triangle_setup."""
    T = clip.shape[0] // 3
    st, _ = triangle_setup(torch.from_numpy(clip),
                           torch.arange(3 * T).reshape(T, 3),
                           torch.ones(T, dtype=torch.bool), width, height,
                           False)
    return st.setup.numpy(), st.bbox.numpy(), st.zmin.numpy()


def two_layer_case(device, width: int = 128, height: int = 64, nx: int = 16,
                   ny: int = 16) -> RasterCase:
    """The counterpart of tests/test_binning_pallas.py:371-405
    (``_two_layer_setup``): two screen-covering grids of nx × ny quads at
    constant NDC depth, a far layer (z = 0.8) first in id order and a near
    one (z = 0.2), so that every tile holds several chunks of each and
    the far layer is hidden everywhere."""
    verts, tris = [], []
    for z in (0.8, 0.2):
        gx, gy = np.meshgrid(np.linspace(0, width, nx + 1),
                             np.linspace(0, height, ny + 1))
        base = len(verts)
        verts += list(_clip_of(np.stack([gx.ravel(), gy.ravel()], 1), z,
                               width, height))
        for j in range(ny):
            for i in range(nx):
                v0 = base + j * (nx + 1) + i
                tris += [(v0, v0 + 1, v0 + nx + 1),
                         (v0 + 1, v0 + nx + 2, v0 + nx + 1)]
    clip = np.stack(verts)[np.asarray(tris).reshape(-1)]
    setup, bbox, _ = _setup_rows(clip, width, height)
    setup, bbox = _pad_rows(list(setup), list(bbox), width, height)
    return _finish("two layers, the far one first", setup, bbox, width,
                   height, 640, device)


def steep_triangles(slots: int = 8, seed: int = 3):
    """Steep slivers, one per 32 × 32 slot of a 128 × 64 raster, each with
    a covered pixel centre where its depth plane (as the kernels evaluate
    it) lies more than 2⁻²¹ below its lowest vertex depth (the vertex
    bound ``TriangleSetup.zmin``, which the JAX binner quantises by 2⁻²²).
    Drawn from ``seed`` until found; a vertex sits on a pixel centre.
    Returns (setup rows (slots, 16), bboxes, zmin, pixel (slots, 2), depth
    there)."""
    rng = np.random.RandomState(seed)
    width, height = 128, 64
    X = np.arange(width, dtype=np.float32) + 0.5
    Y = np.arange(height, dtype=np.float32) + 0.5
    rows, boxes, zmins, pix, zs = [], [], [], [], []
    while len(rows) < slots:
        k = len(rows)
        c = np.array([k % 4 * 32 + 12 + rng.randint(8),
                      k // 4 * 32 + 12 + rng.randint(8)]) + 0.5
        a, L, th = rng.uniform(0, 2 * np.pi), rng.uniform(3, 12),             rng.uniform(0.002, 0.05)
        v = np.stack([c, c + L * np.array([np.cos(a), np.sin(a)]),
                      c + L * np.array([np.cos(a + th), np.sin(a + th)])])
        z0 = rng.uniform(0.1, 0.5)
        z = np.array([z0, z0 + rng.uniform(0.2, 0.4),
                      z0 + rng.uniform(0.2, 0.4)])
        setup, bbox, zmin = _setup_rows(
            np.concatenate([_clip_of(v[i:i + 1], z[i], width, height)
                            for i in range(3)]), width, height)
        t = setup[0]

        def plane(k):   # (a·X + c) + b·Y in float32
            return (t[k] * X[None, :] + t[k + 2]) + t[k + 1] * Y[:, None]

        zz = plane(9)
        cov = (plane(0) >= 0) & (plane(3) >= 0) & (plane(6) >= 0) \
            & (zz >= 0) & (np.float32(1.0) - zz >= 0)
        low = cov & (zz < zmin[0] - 2.0 ** -21)
        if not low.any():
            continue
        py, px = np.argwhere(low)[0]
        rows.append(t)
        boxes.append(bbox[0])
        zmins.append(zmin[0])
        pix.append((px, py))
        zs.append(zz[py, px])
    return (np.stack(rows), np.stack(boxes), np.array(zmins, np.float32),
            np.array(pix), np.array(zs, np.float32))


def bound_case(device, height: int = 64) -> RasterCase:
    """``steep_triangles`` in the second chunk, and in the first, over
    each one's 32 × 32 slot, an occluder at a constant depth halfway
    between the sliver's depth at its low pixel and its vertex bound: a
    skip resting on the vertex bound would drop the sliver there, where it
    is the nearest.  ``height``: the raster's (64, or 128 for a square
    map; the triangles stay in the top 64 rows)."""
    rows, boxes, zmin, pix, zs = steep_triangles()
    occ_rows, occ_boxes = [], []
    for k in range(len(rows)):
        x0, y0 = k % 4 * 32, k // 4 * 32
        d = float(np.float32((np.float64(zs[k]) + zmin[k]) / 2.0))
        for v in ([(x0, y0), (x0 + 32, y0), (x0, y0 + 32)],
                  [(x0 + 32, y0), (x0 + 32, y0 + 32), (x0, y0 + 32)]):
            r, b = _triangle_row(v, d)
            occ_rows.append(r)
            occ_boxes.append(b)
    setup, bbox = _pad_rows(occ_rows, occ_boxes, 128, height)
    steep, steep_box = _pad_rows(list(rows), list(boxes), 128, height)
    return _finish("steep slivers below their vertex bound, behind "
                   "occluders", np.concatenate([setup, steep]),
                   np.concatenate([bbox, steep_box]), 128, height, 640,
                   device)


def occlusion_case(case: RasterCase, cap: int = 640) -> RasterCase:
    """The case binned for the occlusion skip: lists nearest first by the
    triangles' ``depth_bound``, the bins carrying the chunks' bounds;
    ``kept`` the triangles of the chunks the cap kept."""
    bins = bin_tiles(case.bbox, case.width, case.height, TILE, TILE, cap,
                     occ_bound=depth_bound(case.setup, case.bbox, TILE,
                                           TILE))
    kept_chunks = torch.zeros(case.setup.shape[0] // CHUNK_SIZE,
                              dtype=torch.bool, device=case.setup.device)
    kept_chunks[bins.chunk[bins.pair_tile >= 0].to(torch.int64)] = True
    return case._replace(bins=bins,
                         kept=kept_chunks.repeat_interleave(CHUNK_SIZE))


def adversarial_cases(device, cap: int = 640, square: bool = False):
    """The cases for K2, K2w and K3 (104×40, 32×32, 120×72, 48×40, 128×64,
    128×64) or, with ``square``, for K1 (104×104, 32×32, 120×120, 48×48,
    128×128, 128×128).  ``cap`` sizes the capped tile:
    640, the frame's cap, on the card; a few chunks where the plain
    version runs on the CPU."""
    return [list_overflow_case(104, 104 if square else 40, device),
            chunk_cap_case(cap, device),
            wire_interior_case(device, height=120 if square else 72),
            nonfinite_case(device, height=48 if square else 40),
            two_layer_case(device, height=128 if square else 64),
            bound_case(device, height=128 if square else 64)]
