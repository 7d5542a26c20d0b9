"""The least time the card could take for a raster kernel's work, from the
frame's own inputs: a frozen copy of ``chip_smoke.py``'s ``bound`` and its
operation constants (commit 1e399aa), with the work counted from the
reference's triangle setup of the same pose instead of from the program's
bins, so that a kernel that bins, tiles or skips differently is measured
against the same work.

Operations: the (triangle, pixel) evaluations that the triangles' clipped
bounding boxes need, at the coverage test's FP32 operations each, and for
K2 the barycentrics and varyings of every covered pixel.  Bytes: each
input row that a triangle with a non-empty box needs, read once, the
record of every triangle that wins a pixel, read once, and the output
written once.  The count depends on the pose and the scene only.
"""

from __future__ import annotations

import subprocess

import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and FP32
# operations/s outside the tensor cores.
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
# FP32 operations per (triangle, pixel) evaluation: the five-plane
# coverage (4 planes of 2 mul + 2 add, and 1 - z) and the depth compare.
OPS_COVER = 18
# Per covered pixel after the visibility test, K2: the barycentrics (3
# planes, 2 divisions) and 17 varyings of 2 mul + 2 add.
OPS_K2_PIXEL = 3 * 4 + 2 + 17 * 4
# Bytes per triangle: a (16,) f32 setup row, a (4,) f32 bbox, a (76,) f32
# record; per output pixel: a depth (K1), or K2's depth, 17 varyings and
# 6 int32 lanes.
SETUP_B, BBOX_B, RECORD_B = 64, 16, 304
DEPTH_PX_B, PIXEL_PX_B = 4, (1 + 17 + 6) * 4


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    FP32 operations over the FP32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def box_pixels(bbox: torch.Tensor) -> torch.Tensor:
    """Pixels inside each (x0, y0, x1, y1) end-exclusive integer box."""
    w = (bbox[:, 2] - bbox[:, 0]).clamp(min=0)
    h = (bbox[:, 3] - bbox[:, 1]).clamp(min=0)
    return w.double() * h.double()


def depth_work(bbox: torch.Tensor, dim: int) -> tuple:
    """(bytes, operations) of K1 on a (dim × dim) map."""
    px = box_pixels(bbox)
    needed = int((px > 0).sum())
    return (needed * (SETUP_B + BBOX_B) + dim * dim * DEPTH_PX_B,
            float(px.sum()) * OPS_COVER)


def pixel_work(bbox: torch.Tensor, tid: torch.Tensor, width: int,
               height: int) -> tuple:
    """(bytes, operations) of K2 or K2w on a width × height raster;
    ``tid``: the winning triangle of every pixel, -1 where none."""
    px = box_pixels(bbox)
    needed = int((px > 0).sum())
    covered = tid >= 0
    winners = int(torch.unique(tid[covered]).numel())
    return (needed * (SETUP_B + BBOX_B) + winners * RECORD_B
            + width * height * PIXEL_PX_B,
            float(px.sum()) * OPS_COVER
            + int(covered.sum()) * OPS_K2_PIXEL)


def query_power_limit():
    """Start nvidia-smi's query of the card's name and power limit in the
    background; ``power_limit`` reads the answer."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def power_limit(query) -> str:
    """The card's name and power limit from ``query_power_limit``."""
    if query is None:
        return "nvidia-smi not readable"
    try:
        out, _ = query.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        query.kill()
        query.communicate()
        return "nvidia-smi not readable"
    lines = out.strip().splitlines()
    return lines[0] if lines else "nvidia-smi not readable"
