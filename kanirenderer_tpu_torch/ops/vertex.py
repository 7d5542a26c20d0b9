"""Per-frame vertex stage and triangle setup (PyTorch counterpart of
``kanirenderer_tpu/ops/vertex.py``).

Corner-major (``run_vertex_stage_corners`` / ``triangle_setup_corners``):
the scene stores every triangle's three corners expanded (Scene.corner_*),
so the vertex math runs over (corner, T) planes with no gathers; the corner
axis is a leading batch dimension of size 3.  Vertex-major
(``run_vertex_stage`` / ``triangle_setup``), for scenes built without
corner planes: the same math once per shared vertex, then one gather of
the three corners' clip rows.  Both evaluate every product and sum in the
same order, so a scene that has both forms gets the same setup rows from
either.

Varying layout (17 planes per corner):
  0:3   tangent_position (TBN rows · world_pos)
  3:6   TBN row t, 6:9 row b, 9:12 row n (world space, normalized)
  12:15 world_position
  15:17 uv

Triangle-setup layout (16 lanes, as in the reference):
  0:3 e0 (a, b, c) edge function l0(p) = a·x + b·y + c
  3:6 e1, 6:9 e2 (sign-normalized: inside ⇒ all l_i ≥ 0)
  9:12 zrow: screen-affine NDC depth z(p) = zrow · (x, y, 1)
  12:15 unused (zero)
  15 valid flag (1.0 = rasterize)
Invalid triangles get zeroed rows with e0.c = −1, so they cover nothing.

Edge functions come from the adjugate of the homogeneous screen matrix
(Olano-Greer), so near-plane crossers rasterize without clipping.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

NS = 16  # setup lanes per triangle
USED = 17  # varying planes per corner


class CornerOutputs(NamedTuple):
    clip: Tensor        # (3, 4, T) camera clip (x, y, z, w) per corner
    varyings: Tensor    # (3, USED, T)
    light_clip: Tensor  # (3, 4, T) directional-light clip


class TriangleSetup(NamedTuple):
    setup: Tensor     # (T, NS) f32
    bbox: Tensor      # (T, 4) f32 (x0, y0, x1, y1) pixels, end-exclusive
    clipfree: Tensor  # (T,) bool — every covered pixel passes the depth clip
    zmin: Tensor      # (T,) f32 — lower bound of covered-pixel depth


class VertexOutputs(NamedTuple):
    clip: Tensor        # (V, 4) camera clip positions
    varyings: Tensor    # (V, USED)
    light_clip: Tensor  # (V, 4) directional-light clip positions


def _norm_planes(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x * inv, y * inv, z * inv


def _vertex_math(mm, nm, pos, tangent, bitangent, normal, uv, view_proj,
                 light_view_proj):
    """The vertex stage on planes of any common shape: ``mm``/``nm`` the 16
    and 9 matrix-entry planes, the attributes as lists of component
    planes.  Returns (clip, varyings, light_clip), stacked along dim −2."""
    px, py, pz = pos
    wx = mm[0] * px + mm[1] * py + mm[2] * pz + mm[3]
    wy = mm[4] * px + mm[5] * py + mm[6] * pz + mm[7]
    wz = mm[8] * px + mm[9] * py + mm[10] * pz + mm[11]

    def nmul(v0, v1, v2):
        a = nm[0] * v0 + nm[1] * v1 + nm[2] * v2
        b = nm[3] * v0 + nm[4] * v1 + nm[5] * v2
        c = nm[6] * v0 + nm[7] * v1 + nm[8] * v2
        return _norm_planes(a, b, c)

    tx, ty, tz = nmul(*tangent)
    bx, by, bz = nmul(*bitangent)
    nx, ny, nz = nmul(*normal)

    def mat_apply(m):
        return torch.stack([m[i, 0] * wx + m[i, 1] * wy + m[i, 2] * wz
                            + m[i, 3] for i in range(4)], dim=-2)

    tp0 = tx * wx + ty * wy + tz * wz
    tp1 = bx * wx + by * wy + bz * wz
    tp2 = nx * wx + ny * wy + nz * wz
    u, v = uv
    varyings = torch.stack([tp0, tp1, tp2, tx, ty, tz, bx, by, bz,
                            nx, ny, nz, wx, wy, wz, u, v], dim=-2)
    return mat_apply(view_proj), varyings, mat_apply(light_view_proj)


def run_vertex_stage_corners(scene, object_model: Tensor,
                             object_normal: Tensor, view_proj: Tensor,
                             light_view_proj: Tensor) -> CornerOutputs:
    """World transform, camera and light clip positions and the varyings
    of every triangle corner (≈ vs_main, reference src/shader.wgsl:77-116)."""
    O = object_model.shape[0]
    mm = object_model.reshape(O, 16).index_select(0, scene.tri_object).T
    nm = object_normal.reshape(O, 9).index_select(0, scene.tri_object).T

    def planes(corner_attr, n):  # (3·n, T) → n planes of (3, T)
        a = corner_attr.reshape(3, n, -1)
        return [a[:, i] for i in range(n)]

    return CornerOutputs(*_vertex_math(
        mm, nm, planes(scene.corner_pos, 3), planes(scene.corner_tangent, 3),
        planes(scene.corner_bitangent, 3), planes(scene.corner_normal, 3),
        planes(scene.corner_uv, 2), view_proj, light_view_proj))


def run_vertex_stage(scene, object_model: Tensor, object_normal: Tensor,
                     view_proj: Tensor,
                     light_view_proj: Tensor) -> VertexOutputs:
    """The vertex stage once per scene vertex (vertex-major), for scenes
    without corner planes."""
    O = object_model.shape[0]
    vo = scene.vertex_object.to(torch.int64)
    mm = object_model.reshape(O, 16).index_select(0, vo).T
    nm = object_normal.reshape(O, 9).index_select(0, vo).T
    clip, varyings, light_clip = _vertex_math(
        mm, nm, scene.position.T, scene.tangent.T, scene.bitangent.T,
        scene.normal.T, scene.uv.T, view_proj, light_view_proj)
    return VertexOutputs(clip=clip.T.contiguous(),
                         varyings=varyings.T.contiguous(),
                         light_clip=light_clip.T.contiguous())


def triangle_setup(clip: Tensor, tri_idx: Tensor, tri_valid: Tensor, width,
                   height, cull_backfaces: bool,
                   depth_bias_constant: float = 0.0,
                   depth_bias_slope: float = 0.0):
    """``triangle_setup_corners`` from vertex-major clip rows (V, 4): one
    gather of the three corners' rows, then the same setup.  Returns
    (TriangleSetup, planes)."""
    c = clip[tri_idx.to(torch.int64)]            # (T, 3, 4)
    x, y, z, w = (c[:, :, i].T for i in range(4))
    return _setup_from_corner_planes(
        x, y, z, w, tri_valid, width, height, cull_backfaces,
        depth_bias_constant, depth_bias_slope)


def triangle_setup_corners(clip_c: Tensor, tri_valid: Tensor, width,
                           height, cull_backfaces: bool,
                           depth_bias_constant: float = 0.0,
                           depth_bias_slope: float = 0.0):
    """Edge/depth rows from corner-major clip planes ``clip_c`` (3, 4, T).

    ``cull_backfaces``: FrontFace::Ccw + cull Back (reference
    src/lib.rs:193-194).  The depth bias is the shadow pipeline's
    constant/slope state (reference src/lib.rs:896-900).  ``width`` and
    ``height`` are the view's extent in pixels, ints or floats: after a
    resize the view is smaller than the raster it is drawn into.  Returns
    (TriangleSetup, planes) with planes the (16, T) setup columns."""
    return _setup_from_corner_planes(
        clip_c[:, 0], clip_c[:, 1], clip_c[:, 2], clip_c[:, 3], tri_valid,
        width, height, cull_backfaces, depth_bias_constant, depth_bias_slope)


def _setup_from_corner_planes(x, y, z, w, tri_valid, width, height,
                              cull_backfaces, depth_bias_constant,
                              depth_bias_slope):
    # x, y, z, w: (3, T), one row per corner.
    inf = float("inf")
    # Homogeneous screen coords; NDC y-up → pixel y-down.
    px = (0.5 * x + 0.5 * w) * width
    py = (0.5 * w - 0.5 * y) * height
    pw = w

    # Edge k is the cross product of corners (A[k], B[k]).
    A = [1, 2, 0]
    B = [2, 0, 1]
    ra = py[A] * pw[B] - pw[A] * py[B]
    rb = pw[A] * px[B] - px[A] * pw[B]
    rc = px[A] * py[B] - py[A] * px[B]
    det = px[0] * ra[0] + py[0] * rb[0] + pw[0] * rc[0]

    # Outward-CCW front faces have det < 0 in this y-down convention;
    # scaling by sign(det) makes inside ⇒ l_i ≥ 0 for either winding.
    sgn = torch.where(det < 0, -1.0, 1.0)
    ra, rb, rc = ra * sgn, rb * sgn, rc * sgn

    valid = tri_valid & (det != 0.0)
    if cull_backfaces:
        valid = valid & (det < 0.0)

    # Frustum rejection (wgpu clip volume −w ≤ x, y ≤ w, 0 ≤ z ≤ w):
    # all w ≤ 0 culls; all w > 0 uses the outcode test; mixed w keeps.
    behind = (w <= 1e-30).all(0)
    all_front = (w > 0.0).all(0)
    out_plane = ((x < -w).all(0) | (x > w).all(0) | (y < -w).all(0)
                 | (y > w).all(0) | (z < 0.0).all(0) | (z > w).all(0))
    valid = valid & ~behind & ~(all_front & out_plane)

    # Screen-affine depth: the interpolated w is |det| per triangle, so
    # z(p) = (Σ l_i(p)·z_i) / |det| is one plane.
    rdet = 1.0 / torch.where(det != 0.0, det * sgn, 1.0)
    za, zb_, zc = ((r[0] * z[0] + r[1] * z[1] + r[2] * z[2]) * rdet
                   for r in (ra, rb, rc))

    bias = None
    if depth_bias_constant or depth_bias_slope:
        max_slope = torch.maximum(torch.abs(za), torch.abs(zb_))
        bias = depth_bias_slope * max_slope \
            + depth_bias_constant * (2.0 ** -23)
        zc = zc + bias

    # Clip-free: every (bias-shifted) vertex has z ∈ [0, w], and the depth
    # plane stays finite anywhere on screen.
    zbv = z if bias is None else z + w * bias
    zsafe = (torch.abs(za) < 1e30) & (torch.abs(zb_) < 1e30) \
        & (torch.abs(zc) < 1e30)
    clipfree_geo = ((zbv >= 0.0) & (w - zbv >= 0.0)).all(0) & zsafe

    # Bounding box of the visible part: front vertices plus the edge
    # crossings of the w = eps plane (near-plane crossers stay tight).
    eps = 1e-6
    front = w > eps
    sx = px / torch.where(front, pw, 1.0)
    sy = py / torch.where(front, pw, 1.0)
    A2 = [0, 1, 2]
    B2 = [1, 2, 0]
    crosses = front[A2] != front[B2]
    denom = w[B2] - w[A2]
    t = (eps - w[A2]) / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
    ix = torch.clamp((px[A2] + t * (px[B2] - px[A2])) / eps, -1.0, width + 1.0)
    iy = torch.clamp((py[A2] + t * (py[B2] - py[A2])) / eps,
                     -1.0, height + 1.0)
    min_x = torch.cat([torch.where(front, sx, inf),
                       torch.where(crosses, ix, inf)]).amin(0)
    min_y = torch.cat([torch.where(front, sy, inf),
                       torch.where(crosses, iy, inf)]).amin(0)
    max_x = torch.cat([torch.where(front, sx, -inf),
                       torch.where(crosses, ix, -inf)]).amax(0)
    max_y = torch.cat([torch.where(front, sy, -inf),
                       torch.where(crosses, iy, -inf)]).amax(0)

    wf, hf = float(width), float(height)
    x0 = torch.clamp(torch.floor(min_x), 0, wf)
    y0 = torch.clamp(torch.floor(min_y), 0, hf)
    x1 = torch.clamp(torch.ceil(max_x) + 1.0, 0, wf)
    y1 = torch.clamp(torch.ceil(max_y) + 1.0, 0, hf)
    valid = valid & (x1 > x0) & (y1 > y0)

    # Covered-pixel depth lower bound: the minimum vertex depth, 0 for
    # near-plane crossers, +inf for invalid triangles.
    anyback = ~front.all(0)
    zmin_t = (zbv / torch.where(front, w, 1.0)).amin(0)
    zmin_t = torch.where(anyback, 0.0, torch.clamp(zmin_t, min=0.0))
    zmin_t = torch.where(valid, zmin_t, inf)
    clipfree = clipfree_geo | ~valid
    x1 = torch.where(valid, x1, 0.0)
    y1 = torch.where(valid, y1, 0.0)
    x0 = torch.where(valid, x0, wf)
    y0 = torch.where(valid, y0, hf)

    vf = valid.to(torch.float32)
    zero = torch.zeros_like(vf)
    planes = torch.stack([
        ra[0] * vf, rb[0] * vf, rc[0] * vf - (1.0 - vf),
        ra[1] * vf, rb[1] * vf, rc[1] * vf,
        ra[2] * vf, rb[2] * vf, rc[2] * vf,
        za * vf, zb_ * vf, zc * vf,
        zero, zero, zero, vf])
    setup = planes.T.contiguous()
    bbox = torch.stack([x0, y0, x1, y1], dim=1)
    return TriangleSetup(setup=setup, bbox=bbox, clipfree=clipfree,
                         zmin=zmin_t), planes
