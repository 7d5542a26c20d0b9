"""Forward shading of the render modes (PyTorch counterpart of
``kanirenderer_tpu/shade/forward.py``): ``shade_lit`` (Blinn-Phong, with
3×3 PCF shadows for LIT_SHADOW, without for LIT, Reinhard or ACES),
``shade_unlit`` and ``shade_wireframe``.

Colours and vectors are channel-planar (3, H, W), scalars (H, W).  The
lighting model is the reference's (src/shader.wgsl:163-262): point-light
attenuation ``1/(1 + 0.09 d + 0.032 d²)`` times ``clamp(1 − (d/range)⁴)``,
ambient ``20·0.0005``, the directional light at a hardcoded 10.0 with 0.5
specular strength, modulated by 3×3 PCF, and the storage array of point
lights whose specular uses the unnormalized tangent normal (a reference
quirk, src/shader.wgsl:242).
"""

from __future__ import annotations

import torch

from kanirenderer_tpu_torch.core.color import aces_tonemap, reinhard_tonemap
from kanirenderer_tpu_torch.core.types import Lights, Scene
from kanirenderer_tpu_torch.ops.interpolate import PixelBuffer
from kanirenderer_tpu_torch.ops.sampling import (sample_materials_blocks,
                                                 sample_materials_combined,
                                                 sample_shadow_pcf)

Tensor = torch.Tensor

# Varying plane slices (ops/vertex.py layout)
TAN_POS = slice(0, 3)
TBN_T = slice(3, 6)
TBN_B = slice(6, 9)
TBN_N = slice(9, 12)
WORLD_POS = slice(12, 15)


def _dot3(a: Tensor, b: Tensor) -> Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def tbn_apply(vary: Tensor, p: Tensor) -> Tensor:
    """Tangent-space image of a constant world point: TBN rows · p.  The
    reference interpolates it per vertex; it is linear in the interpolated
    rows, so deriving it per pixel is exact."""
    t, b, n = vary[TBN_T], vary[TBN_B], vary[TBN_N]
    return torch.stack([
        t[0] * p[0] + t[1] * p[1] + t[2] * p[2],
        b[0] * p[0] + b[1] * p[1] + b[2] * p[2],
        n[0] * p[0] + n[1] * p[1] + n[2] * p[2],
    ])


def shadow_coords(vary: Tensor, light_vp: Tensor):
    """Light-space (u, v, depth) from the interpolated world position
    (reference src/shader.wgsl:113-114; the ortho projection is affine)."""
    w = vary[WORLD_POS]
    L = light_vp
    su = (L[0, 0] * w[0] + L[0, 1] * w[1] + L[0, 2] * w[2]
          + L[0, 3]) * 0.5 + 0.5
    sv = (L[1, 0] * w[0] + L[1, 1] * w[1] + L[1, 2] * w[2]
          + L[1, 3]) * -0.5 + 0.5
    sz = L[2, 0] * w[0] + L[2, 1] * w[1] + L[2, 2] * w[2] + L[2, 3]
    return su, sv, sz


def _norm3(v: Tensor) -> Tensor:
    return v * torch.rsqrt(torch.clamp(_dot3(v, v), min=1e-30))[None]


def sample_materials(scene: Scene, pix: PixelBuffer) -> tuple[Tensor, Tensor]:
    """Per-pixel diffuse (linear RGB) and raw normal-map samples, planar:
    from the combined table of an all-u8 scene, else from the separate
    tables that keep a deeper normal map at its source depth."""
    if scene.tex_combined.shape[0] > 0:
        return sample_materials_combined(scene.tex_combined, pix.blk_base,
                                         pix.blk_w, pix.tex_w, pix.tex_h,
                                         pix.varyings[15], pix.varyings[16])
    return sample_materials_blocks(scene.tex_diffuse, scene.tex_normal,
                                   pix.blk_base, pix.blk_w, pix.tex_w,
                                   pix.tex_h, pix.varyings[15],
                                   pix.varyings[16])


def shade_unlit(scene: Scene, pix: PixelBuffer) -> Tensor:
    """Diffuse sample + Reinhard (reference src/unlit_shader.wgsl:97-103)."""
    object_color, _ = sample_materials(scene, pix)
    return reinhard_tonemap(object_color)


def shade_wireframe(pix: PixelBuffer) -> Tensor:
    """Constant white (reference src/shader_wireframe.wgsl:140-144)."""
    return torch.ones((3,) + tuple(pix.mask.shape), dtype=torch.float32,
                      device=pix.mask.device)


def _blinn_phong(tangent_normal: Tensor, light_dir: Tensor, view_dir: Tensor,
                 light_color: Tensor) -> tuple[Tensor, Tensor]:
    half_dir = _norm3(view_dir + light_dir)
    diff = torch.clamp(_dot3(tangent_normal, light_dir), min=0.0)
    s1 = torch.clamp(_dot3(tangent_normal, half_dir), min=0.0)
    s2 = s1 * s1
    s4 = s2 * s2
    s8 = s4 * s4
    s16 = s8 * s8
    spec = s16 * s16      # x^32 by five squarings, as the reference
    return light_color * diff[None], light_color * spec[None]


def _attenuation(dist: Tensor, rng: Tensor) -> Tensor:
    att = 1.0 / (1.0 + 0.09 * dist + 0.032 * dist * dist)
    q = dist / torch.clamp(rng, min=1e-20)
    q2 = q * q
    range_att = torch.clamp(1.0 - q2 * q2, 0.0, 1.0)
    return att * range_att


def shade_lit(scene: Scene, pix: PixelBuffer, lights: Lights,
              shadow_table: Tensor | None, hdr: bool, shadow_dim: int = 0, *,
              camera_pos: Tensor, light_vp: Tensor | None = None) -> Tensor:
    """Blinn-Phong forward shading → (3, H, W) tonemapped linear colour.

    ``shadow_table`` None is the Lit pipeline; otherwise LitWithShadow with
    the table from ops/sampling.build_shadow_table and the directional
    light's view-projection ``light_vp``."""
    object_color, object_normal = sample_materials(scene, pix)
    vary = pix.varyings

    tangent_normal_raw = object_normal * 2.0 - 1.0
    tangent_normal = _norm3(tangent_normal_raw)

    tan_pos = vary[TAN_POS]
    view_dir = _norm3(tbn_apply(vary, camera_pos) - tan_pos)

    # movable point light (uniform `light`)
    world_pos = vary[WORLD_POS]
    m = lights.movable
    dvec = m.position[:, None, None] - world_pos
    dist = torch.sqrt(torch.clamp(_dot3(dvec, dvec), min=1e-30))
    light_dir = _norm3(tbn_apply(vary, m.position) - tan_pos)
    diff, spec = _blinn_phong(tangent_normal, light_dir, view_dir,
                              m.color[:, None, None])
    movable_term = (diff + spec) * _attenuation(dist, m.range)[None] \
        * object_color

    # ambient (reference src/shader.wgsl:179-181)
    ambient_term = (20.0 * 0.0005) * object_color

    # directional light
    d = lights.directional
    dl_dir = (-d.direction / torch.linalg.vector_norm(d.direction))
    dl_dir = dl_dir[:, None, None].expand_as(tangent_normal)
    dl_diff, dl_spec = _blinn_phong(tangent_normal, dl_dir, view_dir,
                                    d.color[:, None, None])
    dl_term = dl_diff * 10.0 + dl_spec * (10.0 * 0.5)
    if shadow_table is not None:
        su, sv, sz = shadow_coords(vary, light_vp)
        shadow = sample_shadow_pcf(shadow_table, shadow_dim, su, sv, sz)
        dl_term = dl_term * shadow[None]
    dl_term = dl_term * object_color

    # point-light storage array (reference src/shader.wgsl:225-257), in
    # light order; loop lights use the unnormalized tangent normal.
    p = lights.points
    points_term = torch.zeros_like(object_color)
    for k in range(p.position.shape[0]):
        lp = p.position[k]
        pdvec = lp[:, None, None] - world_pos
        pdist = torch.sqrt(torch.clamp(_dot3(pdvec, pdvec), min=1e-30))
        pl_dir = _norm3(tbn_apply(vary, lp) - tan_pos)
        pdiff, pspec = _blinn_phong(tangent_normal_raw, pl_dir, view_dir,
                                    p.color[k][:, None, None])
        points_term = points_term \
            + (pdiff + pspec) * _attenuation(pdist, p.range[k])[None]
    points_term = points_term * object_color

    result = ambient_term + dl_term + movable_term + points_term
    return aces_tonemap(result) if hdr else reinhard_tonemap(result)
