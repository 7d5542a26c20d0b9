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
record per covered pixel and writes a ``PixelBuffer``.  ``interpolate``
builds the same buffer from a visibility buffer (triangle id and
barycentrics per pixel) with one record gather per pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kanirenderer_tpu_torch.ops.raster_xla import VisBuffer
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


def _material_lanes(tri_mat: Tensor, mat_blk_base: Tensor, mat_blk_w: Tensor,
                    mat_tex_size: Tensor) -> Tensor:
    """The (6, T) material lanes of ``Scene.tri_extra``, for a scene built
    without them."""
    tm = tri_mat.to(torch.int64)
    base = mat_blk_base[tm]
    hi = torch.div(base, 65536, rounding_mode="floor")
    return torch.stack([tri_mat, mat_tex_size[tm, 0], mat_tex_size[tm, 1],
                        hi, base - hi * 65536, mat_blk_w[tm]]) \
        .to(torch.float32)


def build_tri_records(tri_idx: Tensor, tri_mat: Tensor, varyings: Tensor,
                      mat_blk_base: Tensor, mat_blk_w: Tensor,
                      mat_tex_size: Tensor, setup: Tensor | None = None,
                      extra: Tensor | None = None) -> Tensor:
    """Per-triangle records from vertex-major varyings (V, USED): three row
    gathers by ``tri_idx``.  With ``setup`` (the (T, 16) setup rows) the
    (T, FAT_LANES) layout of ``build_tri_records_corners``; without it
    (T, 3·USED + 6): the three corners' varyings and the material lanes,
    what ``interpolate`` gathers per pixel.  ``extra``: the scene's static
    (6, T) material lanes; None or empty computes them here."""
    ti = tri_idx.to(torch.int64)
    v = varyings[:, :USED]
    r0, r1, r2 = v[ti[:, 0]], v[ti[:, 1]], v[ti[:, 2]]
    if extra is None or extra.numel() == 0:
        extra = _material_lanes(tri_mat, mat_blk_base, mat_blk_w,
                                mat_tex_size)
    if setup is None:
        return torch.cat([r0, r1, r2, extra.T], dim=1)
    lsum = setup[:, 0:3] + setup[:, 3:6] + setup[:, 6:9]
    return torch.cat([setup, r0, r1 - r0, r2 - r0, extra.T, lsum], dim=1)


def interpolate(vis: VisBuffer, tri_idx: Tensor, tri_mat: Tensor,
                varyings: Tensor, mat_blk_base: Tensor, mat_blk_w: Tensor,
                mat_tex_size: Tensor) -> PixelBuffer:
    """Visibility buffer → PixelBuffer: the winner's record gathered per
    pixel and its varyings interpolated as v0 + (v1 − v0)·λ1 + (v2 − v0)·λ2."""
    records = build_tri_records(tri_idx, tri_mat, varyings, mat_blk_base,
                                mat_blk_w, mat_tex_size)
    H, W = vis.tri.shape
    rec = records[vis.tri.clamp(min=0).to(torch.int64).reshape(-1)]
    l1 = vis.bary[..., 0].reshape(-1, 1)
    l2 = vis.bary[..., 1].reshape(-1, 1)
    v0, v1, v2 = (rec[:, k * USED:(k + 1) * USED] for k in range(3))
    planar = (v0 + (v1 - v0) * l1 + (v2 - v0) * l2).T.reshape(USED, H, W)
    par = rec[:, 3 * USED:].to(torch.int32).T.reshape(6, H, W)
    return PixelBuffer(varyings=planar, mat_id=par[0], tex_w=par[1],
                       tex_h=par[2], blk_base=par[3] * 65536 + par[4],
                       blk_w=par[5], mask=vis.tri >= 0, z=vis.z,
                       tid=vis.tri)
