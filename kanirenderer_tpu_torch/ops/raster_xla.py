"""Brute-force visibility and depth rasters (PyTorch counterpart of
``kanirenderer_tpu/ops/raster_xla.py``).

Every triangle is evaluated against every pixel in batches — O(T·H·W), an
oracle for small sizes that needs no binning.  Tests hold the tile kernels'
plain versions (ops/raster_cuda) against it.  Coverage: the three edge
functions ≥ 0 and the screen-affine depth in [0, 1]; the depth test is
Less against a buffer cleared to 1.0, so the lowest triangle id wins a
tie.  Planes are evaluated as a·X + b·Y + c, the reference oracle's order.
Wireframe coverage uses the reference oracle's edge distance
l / max(sqrt(a² + b²), 1e-20) (raster_xla.py:98-105), not the kernels'.
Row bands as in the reference oracle: ``y_offset`` (and, interleaved,
``y_stride`` with ``tile_h``) place the rows at their global centres.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class VisBuffer(NamedTuple):
    tri: Tensor   # (H, W) i32 triangle id, −1 = background
    z: Tensor     # (H, W) f32 depth, 1.0 = clear
    bary: Tensor  # (H, W, 2) f32 (λ1, λ2)


def _planes(chunk: Tensor, X: Tensor, Y: Tensor):
    """Edge and depth planes of a (B, 16) setup batch over the pixel grid
    → l0, l1, l2, z, each (B, H, W), and the coverage mask."""
    def lin(k):
        return (chunk[:, k, None, None] * X + chunk[:, k + 1, None, None] * Y
                + chunk[:, k + 2, None, None])

    l0, l1, l2, z = lin(0), lin(3), lin(6), lin(9)
    covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0.0) & (z <= 1.0) \
        & (chunk[:, 15] > 0.0)[:, None, None]
    return l0, l1, l2, z, covered


def _grid(width: int, height: int, device, y0: float = 0.0,
          y_stride: int = 1, tile_h: int = 0):
    """Pixel centres (1, W) and (H, 1); row r of an interleaved band is
    global row (r // tile_h)·y_stride·tile_h + r % tile_h + y0 (the
    reference's ``_pixel_grid``)."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    r = torch.arange(height, dtype=torch.float32, device=device)
    if y_stride > 1:
        r = torch.div(r, tile_h, rounding_mode="floor") \
            * (y_stride * tile_h) + r % tile_h
    ys = r + 0.5 + y0
    return xs[None, :], ys[:, None]


def _edge_dist(l: Tensor, chunk: Tensor, k: int) -> Tensor:
    g = torch.sqrt(chunk[:, k] ** 2 + chunk[:, k + 1] ** 2)
    return l / torch.clamp(g, min=1e-20)[:, None, None]


def rasterize_xla(setup: Tensor, width: int, height: int,
                  wireframe: bool = False, wire_thresh: float = 0.7,
                  batch: int = 16, y_offset: float = 0.0, y_stride: int = 1,
                  tile_h: int = 0) -> VisBuffer:
    """Visibility buffer of the (T, 16) setup rows (ops/vertex.py).

    ``wireframe``: keep only pixels within ``wire_thresh`` pixels of an
    edge of the covering triangle (PolygonMode::Line).  ``height`` rows
    from global row ``y_offset`` (a row band; interleaved with
    ``y_stride`` > 1 and ``tile_h``)."""
    dev = setup.device
    X, Y = _grid(width, height, dev, y_offset, y_stride, tile_h)
    zbuf = torch.ones((height, width), dtype=torch.float32, device=dev)
    tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros((height, width), dtype=torch.float32, device=dev)
    b2 = torch.zeros((height, width), dtype=torch.float32, device=dev)
    for base in range(0, setup.shape[0], batch):
        chunk = setup[base:base + batch]
        l0, l1, l2, z, covered = _planes(chunk, X, Y)
        if wireframe:
            d = torch.minimum(torch.minimum(_edge_dist(l0, chunk, 0),
                                            _edge_dist(l1, chunk, 3)),
                              _edge_dist(l2, chunk, 6))
            covered = covered & (d <= wire_thresh)
        zc = torch.where(covered, z, float("inf"))
        best = zc.argmin(0)                  # first minimum: lowest id
        pick = best[None]
        bz = torch.gather(zc, 0, pick)[0]
        lsum = l0 + l1 + l2
        lsum = torch.where(lsum != 0, lsum, 1e-30)
        lb1 = torch.gather(l1 / lsum, 0, pick)[0]
        lb2 = torch.gather(l2 / lsum, 0, pick)[0]
        win = torch.isfinite(bz) & (bz < zbuf)
        zbuf = torch.where(win, bz, zbuf)
        tri = torch.where(win, (base + best).to(torch.int32), tri)
        b1 = torch.where(win, lb1, b1)
        b2 = torch.where(win, lb2, b2)
    return VisBuffer(tri=tri, z=zbuf, bary=torch.stack([b1, b2], -1))


def rasterize_depth_xla(setup: Tensor, dim: int, batch: int = 16,
                        band_h: int | None = None,
                        y_offset: float = 0.0) -> Tensor:
    """(dim, dim) depth map: minimum covered depth, 1.0 where uncovered;
    with ``band_h`` only map rows [y_offset, y_offset + band_h)."""
    H = dim if band_h is None else band_h
    X, Y = _grid(dim, H, setup.device, y_offset)
    zbuf = torch.ones((H, dim), dtype=torch.float32, device=setup.device)
    for base in range(0, setup.shape[0], batch):
        *_, z, covered = _planes(setup[base:base + batch], X, Y)
        zbuf = torch.minimum(zbuf, torch.where(covered, z, 1.0).amin(0))
    return zbuf
