"""Adversarial inputs for the tile raster kernels K1 and K2.

Small synthetic triangle sets that drive the paths a real frame seldom
reaches: a hit list that overflows its shared-memory room (more bbox hits
in one tile than the list holds, so the kernel evaluates and refills), a
tile at its chunk cap with a counted overflow, tiles with no chunk, equal
depths across chunks (the lower triangle id must win), a raster that is no
multiple of the tile, and NaN planes.  ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels against their plain versions
on them, ``tests/test_torch_raster.py`` the plain versions against the JAX
package's brute-force rasters.

Every triangle is a band: it covers x ∈ [x0, x1), y ≥ 4 at a constant
depth.  All plane coefficients are small integers or multiples of 2⁻¹², so
every evaluation order gives the same bits and any two correct rasters
agree exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kanirenderer_tpu_torch.core.types import (CHUNK_SIZE, SUBBATCH,
                                               SUBS_PER_CHUNK)
from kanirenderer_tpu_torch.ops.binning import ChunkBins, bin_tiles
from kanirenderer_tpu_torch.ops.interpolate import (FAT_LANES, LSUM0, PAR0,
                                                    REC0)
from kanirenderer_tpu_torch.ops.vertex import NS

Tensor = torch.Tensor

TILE = 16


class RasterCase(NamedTuple):
    name: str
    setup: Tensor    # (T, 16) f32 setup rows
    bbox: Tensor     # (T, 4) f32 pixel bboxes
    records: Tensor  # (T, 76) f32 triangle records, lanes 0:16 = setup
    bins: ChunkBins
    width: int
    height: int
    kept: Tensor     # (T,) bool: triangles of chunks the binning kept


def _case(name: str, x0, x1, z, nan_rows, width: int, height: int,
          cap: int, device) -> RasterCase:
    """Bands x ∈ [x0[i], x1[i]), y ≥ 4 at depth z[i]; ``nan_rows`` get a
    NaN edge or depth coefficient and keep their bbox."""
    T = len(x0)
    assert T % CHUNK_SIZE == 0
    setup = np.zeros((T, NS), np.float32)
    setup[:, 0], setup[:, 2] = 1.0, -x0           # x − x0 ≥ 0
    setup[:, 3], setup[:, 5] = -1.0, x1           # x1 − x ≥ 0
    setup[:, 7], setup[:, 8] = 1.0, -4.0          # y − 4 ≥ 0
    setup[:, 11] = z
    setup[:, 15] = 1.0
    for k, i in enumerate(nan_rows):              # edge a, edge c, depth c
        setup[i, (3, 8, 11)[k % 3]] = np.nan
    bbox = np.stack([x0, np.full(T, 4.0), x1, np.full(T, float(height))],
                    1).astype(np.float32)
    rng = np.random.RandomState(T + width)
    records = np.zeros((T, FAT_LANES), np.float32)
    records[:, :NS] = setup
    records[:, REC0:PAR0] = rng.standard_normal((T, PAR0 - REC0))
    records[:, PAR0:LSUM0] = rng.randint(0, 30000, (T, LSUM0 - PAR0))
    records[:, LSUM0:] = setup[:, 0:3] + setup[:, 3:6] + setup[:, 6:9]
    setup_t, bbox_t, records_t = (torch.from_numpy(a).to(device)
                                  for a in (setup, bbox, records))
    bins = bin_tiles(bbox_t, width, height, TILE, TILE, cap)
    # Every band of a case with a cap meets the same tiles, so a chunk is
    # kept everywhere or nowhere: the first ``cap`` chunks are kept.
    kept = torch.arange(T, device=device) < cap * CHUNK_SIZE
    return RasterCase(name, setup_t, bbox_t, records_t, bins, width, height,
                      kept)


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


def adversarial_cases(device, cap: int = 640, square: bool = False):
    """The cases for K2 (104×40 and 32×32) or, with ``square``, for K1
    (104×104 and 32×32).
    ``cap`` sizes the capped tile: 640, the frame's cap, on the card; a
    few chunks where the plain version runs on the CPU."""
    return [list_overflow_case(104, 104 if square else 40, device),
            chunk_cap_case(cap, device)]
