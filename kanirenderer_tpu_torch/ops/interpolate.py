"""Per-pixel fragment inputs and the per-triangle records that feed them
(PyTorch counterpart of ``kanirenderer_tpu/ops/interpolate.py``).

A triangle record is one row of FAT_LANES = 76 float32 lanes, the layout
of ``raster_pallas.py:283-304`` without its 128-lane DMA pad:

  0:16   triangle_setup row (edges, depth plane, valid flag)
  16:33  corner-0 varyings v0
  33:50  v1 − v0
  50:67  v2 − v0
  67:73  mat, tex_w, tex_h, blk_base_hi, blk_base_lo, blk_w
  73:76  lsum edge row (Σ of the three edge rows), so the raster kernel
         normalizes barycentrics without evaluating l0

The fused raster kernel (ops/raster_cuda.rasterize_pixels) reads one
record per covered pixel and writes a ``PixelBuffer``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kanirenderer_tpu_torch.ops.vertex import NS, USED

Tensor = torch.Tensor

REC0 = NS                 # 16: varyings v0
PAR0 = REC0 + 3 * USED    # 67: material lanes
LSUM0 = PAR0 + 6          # 73: lsum edge row
FAT_LANES = LSUM0 + 3     # 76


class PixelBuffer(NamedTuple):
    varyings: Tensor  # (USED, H, W) f32 interpolated varyings, planar
    mat_id: Tensor    # (H, W) i32
    tex_w: Tensor     # (H, W) i32
    tex_h: Tensor     # (H, W) i32
    blk_base: Tensor  # (H, W) i32 first combined-table row of the texture
    blk_w: Tensor     # (H, W) i32 blocks per texture row
    mask: Tensor      # (H, W) bool, True where geometry covers the pixel
    z: Tensor         # (H, W) f32 depth, 1.0 where uncovered
    overflow: Tensor | None = None  # () i32 chunks dropped by binning caps
    tid: Tensor | None = None       # (H, W) i32 winning triangle, −1 = none


def build_tri_records_corners(varyings_c: Tensor, setup_planes: Tensor,
                              tri_extra: Tensor) -> Tensor:
    """(T, FAT_LANES) records from corner-major varyings (3, USED, T), the
    (16, T) setup planes and the static (6, T) material lanes."""
    v0, v1, v2 = varyings_c[0], varyings_c[1], varyings_c[2]
    sp = setup_planes
    lsum = sp[0:3] + sp[3:6] + sp[6:9]
    cols = torch.cat([sp, v0, v1 - v0, v2 - v0, tri_extra, lsum])
    return cols.T.contiguous()
