"""The least time the card could take for a raster or shading kernel's
work, from the frame's own inputs: a frozen copy of ``chip_smoke.py``'s
``bound`` and its operation constants (commit 1e399aa), with the work
counted from the reference's triangle setup and raster of the same pose
instead of from the program's bins, so that a kernel that bins, tiles or
skips differently is measured against the same work.

Operations: the (triangle, pixel) evaluations that the triangles' clipped
bounding boxes need, at the coverage test's FP32 operations each, and for
K2 the barycentrics and varyings of every covered pixel.  Bytes: each
input row that a triangle with a non-empty box needs, read once, the
record of every triangle that wins a pixel, read once, and the output
written once.  The count depends on the pose and the scene only.

The shading kernel (``lights_in_range``, ``shade_work``) is counted from
the reference's raster and light rig: the work of every covered pixel,
and each light's only on the covered pixels inside its range, where the
reference's attenuation can be non-zero.  Outside it a light adds
exactly nothing, so a kernel that culls lights is measured against the
same work.
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

# The shading kernel (csrc/shade_forward.cu), its operations counted from
# the equations of reference/forward.py and reference/color.py, one FP32
# operation per add, multiply, division, square root, compare, min or max;
# what is the same for every pixel (the sun's direction, a light's clamped
# range, the ambient factor) is left out.  The texture and PCF gathers
# count only their taps of non-zero weight, as the kernel takes them.
# Per covered pixel:
OPS_SHADE_PIXEL = (
    8 + 2 + 4 + 4        # texel coordinates (u·w − 0.5, floor, fraction;
    #                      the same for v), window offsets, hat weights,
    #                      the 4 tap weights
    + 3 * (4 * 3 + 3)    # diffuse: 3 channels × 4 taps of w·w/65025·wgt,
    #                      summed
    + 3 * (4 * 2 + 3)    # normal map: 3 channels × 4 taps of w/255·wgt
    + 6 + 10             # tangent normal: n·2 − 1, normalised (dot 5,
    #                      clamp, rsqrt, 3 mul)
    + 15 + 3 + 10        # view direction: TBN rows · camera (3 × 5),
    #                      − tangent position, normalised
    + 3                  # ambient: factor × colour
    + 36 + 9 + 3         # the sun: Blinn-Phong (half vector 3 + 10, two
    #                      clamped dots 2 × 6, x^32 by 5 squarings, colour
    #                      × diff and × spec 6), × 10 and × 5 summed,
    #                      × colour
    + 3 + 9              # the point lights' sum × colour; four terms
    #                      summed
    + 3 * 2              # Reinhard c / (c + 1)
    + 3 * 8)             # encode: clamp 2, compare 1, one branch 1 (c ·
#                          12.92, or a power as 1), × 255 + 0.5, clamp 2
# Per covered pixel in LIT_SHADOW: the 3×3 PCF and its product.
OPS_SHADE_PCF = (
    22                   # light-space u, v (3 mul + 3 add, ×0.5 + 0.5
    #                      each) and depth (3 mul + 3 add)
    + 8 + 2 + 1          # texel coordinates, window offsets, depth × 65535
    + 8 * 6              # trapezoid weights of 4 lanes a side: d, d + 1,
    #                      3 − d, min, clamp 2
    + 16 + 16 + 15 + 1   # 16 tap weights, 16 compares, summed, × 1/9
    + 3)                 # the sun term × shadow
# Per (covered pixel, light) with the pixel inside the light's range, the
# movable light and each of the point-light array alike.
OPS_SHADE_LIGHT = (
    3 + 5 + 2            # light − world position, its length (dot, clamp,
    #                      sqrt)
    + 15 + 3 + 10        # tangent-space light direction, normalised
    + 36                 # Blinn-Phong as the sun's
    + 6 + 7              # attenuation 1 / (1 + 0.09 d + 0.032 d²); range
    #                      factor d / r, squared twice, 1 − q⁴, clamp 2,
    #                      product
    + 3 + 3 + 3)         # (diff + spec) × attenuation, added to the sum
# Bytes per pixel of the surface: the coverage mask read and the u8 sRGB
# pixel written; per covered pixel: the 17 varying planes (f32) and the 4
# material planes (tex_w, tex_h, blk_base, blk_w; int32) read once.  The
# texel and shadow-table gathers are left out: neighbours share their
# rows, and the 2048² shadow table fits the card's L2.
MASK_PX_B, OUT_PX_B, SHADE_PLANES_B = 1, 3, (17 + 4) * 4


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


def lights_in_range(world: torch.Tensor, lights) -> int:
    """(pixel, light) pairs with the pixel inside the light's range,
    ``dist < range`` with the reference's distance; ``world``: (3, N) f32
    world positions of covered pixels, ``lights``: a reference ``Lights``,
    its movable light and every light of its point-light array counted."""
    pos = torch.cat([lights.movable.position.reshape(1, 3),
                     lights.points.position])
    rng = torch.cat([lights.movable.range.reshape(1), lights.points.range])
    pairs = torch.zeros((), dtype=torch.int64, device=world.device)
    for p, r in zip(pos, rng):
        d = p[:, None] - world
        dist = torch.sqrt(torch.clamp(d[0] * d[0] + d[1] * d[1]
                                      + d[2] * d[2], min=1e-30))
        pairs += (dist < r).sum()
    return int(pairs)


def shade_work(covered: int, pairs: int, width: int, height: int,
               shadow: bool) -> tuple:
    """(bytes, operations) of the shading kernel on a width × height u8
    surface with ``covered`` covered pixels and ``pairs`` (covered pixel,
    light) pairs in range (``lights_in_range``); ``shadow``: LIT_SHADOW's
    PCF."""
    per_pixel = OPS_SHADE_PIXEL + (OPS_SHADE_PCF if shadow else 0)
    return (width * height * (MASK_PX_B + OUT_PX_B)
            + covered * SHADE_PLANES_B,
            float(covered * per_pixel + pairs * OPS_SHADE_LIGHT))


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
