"""Deferred shading: G-buffer write + deferred lighting (PyTorch
counterpart of ``kanirenderer_tpu/shade/deferred.py``).

The reference renderer only scaffolded this pipeline
(src/deferredRenderPipeline.rs, gated off at src/lib.rs:730-736); the JAX
package realizes its design and the port follows the JAX package:

* the G-buffer holds channel-planar planes materialized from the pixel
  buffer: world normal and view direction in bf16, world position and the
  light-space coordinate in f32, albedo quantized to 8 bits;
* the lighting pass evaluates the forward light rig (movable point light,
  ambient, directional light with PCF shadows, the point-light array) in
  WORLD space, so the sun term is the geometrically correct one rather
  than the forward path's tangent-space mismatch;
* ACES for HDR surfaces, Reinhard otherwise.

Rounding: ``Tensor.to(torch.bfloat16)`` rounds to nearest even, as JAX's
``astype(jnp.bfloat16)`` does, and ``torch.round`` rounds half to even, as
``jnp.round`` does, so both packages store the same G-buffer values from
the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kanirenderer_tpu_torch.core.color import aces_tonemap, reinhard_tonemap
from kanirenderer_tpu_torch.core.types import Lights, Scene
from kanirenderer_tpu_torch.ops.interpolate import PixelBuffer
from kanirenderer_tpu_torch.ops.sampling import sample_shadow_pcf
from kanirenderer_tpu_torch.shade import forward

Tensor = torch.Tensor


class GBuffer(NamedTuple):
    """Dense per-pixel geometry and material attributes, channel-planar."""

    normal: Tensor     # (3, H, W) bf16 world-space shading normal
    position: Tensor   # (3, H, W) f32 world-space position
    albedo: Tensor     # (3, H, W) f32 8-bit-quantized linear albedo
    depth: Tensor      # (H, W) f32
    shadow_uv: Tensor  # (3, H, W) f32 light-space (u, v, depth)
    view_dir: Tensor   # (3, H, W) bf16 world-space unit view vector
    mask: Tensor       # (H, W) bool


def write_gbuffer(scene: Scene, pix: PixelBuffer, camera_pos: Tensor,
                  light_vp: Tensor) -> GBuffer:
    """Materialize the G-buffer from interpolated varyings and materials."""
    vary = pix.varyings
    albedo, obj_normal = forward.sample_materials(scene, pix)

    # world normal from the tangent-space normal map: n = nᵗT + nᵇB + nⁿN
    tn = obj_normal * 2.0 - 1.0
    n_world = (vary[forward.TBN_T] * tn[0][None]
               + vary[forward.TBN_B] * tn[1][None]
               + vary[forward.TBN_N] * tn[2][None])
    n_world = forward._norm3(n_world)

    world_pos = vary[forward.WORLD_POS]
    view = forward._norm3(camera_pos[:, None, None] - world_pos)

    albedo_q = torch.round(torch.clamp(albedo, 0.0, 1.0) * 255.0) / 255.0
    return GBuffer(
        normal=n_world.to(torch.bfloat16),
        position=world_pos,
        albedo=albedo_q,
        depth=pix.z,
        shadow_uv=torch.stack(forward.shadow_coords(vary, light_vp)),
        view_dir=view.to(torch.bfloat16),
        mask=pix.mask,
    )


def deferred_lighting(gbuf: GBuffer, lights: Lights,
                      shadow_table: Tensor | None, hdr: bool,
                      shadow_dim: int = 0) -> Tensor:
    """Fullscreen lighting over the G-buffer → (3, H, W) tonemapped colour.
    ``shadow_table`` None skips the shadow term (the LIT mode)."""
    n = gbuf.normal.to(torch.float32)
    view_dir = gbuf.view_dir.to(torch.float32)
    world_pos = gbuf.position

    def point_light_term(lpos, lcol, lrange):
        dvec = lpos[:, None, None] - world_pos
        dist = torch.sqrt(torch.clamp(forward._dot3(dvec, dvec), min=1e-30))
        ldir = dvec / dist[None]
        diff, spec = forward._blinn_phong(n, ldir, view_dir,
                                          lcol[:, None, None])
        return (diff + spec) * forward._attenuation(dist, lrange)[None]

    m = lights.movable
    acc = point_light_term(m.position, m.color, m.range)
    acc = acc + (20.0 * 0.0005)    # ambient

    d = lights.directional
    dl_dir = -d.direction / torch.linalg.vector_norm(d.direction)
    dl_dir = dl_dir[:, None, None].expand_as(n)
    dl_diff, dl_spec = forward._blinn_phong(n, dl_dir, view_dir,
                                            d.color[:, None, None])
    dl_term = dl_diff * 10.0 + dl_spec * (10.0 * 0.5)
    if shadow_table is not None:
        sh = sample_shadow_pcf(shadow_table, shadow_dim, gbuf.shadow_uv[0],
                               gbuf.shadow_uv[1], gbuf.shadow_uv[2])
        dl_term = dl_term * sh[None]
    acc = acc + dl_term

    p = lights.points
    for k in range(p.position.shape[0]):
        acc = acc + point_light_term(p.position[k], p.color[k], p.range[k])

    result = acc * gbuf.albedo
    return aces_tonemap(result) if hdr else reinhard_tonemap(result)


def gbuffer_debug_view(gbuf: GBuffer, which: str) -> Tensor:
    """Debug visualization of a G-buffer channel → (3, H, W) colour."""
    if which == "normal":
        return gbuf.normal.to(torch.float32) * 0.5 + 0.5
    if which == "albedo":
        return gbuf.albedo
    if which == "position":
        p = gbuf.position
        return p.abs() / torch.clamp(p.abs().max(), min=1e-6)
    if which == "depth":
        return gbuf.depth[None].expand(3, -1, -1)
    raise ValueError(which)
