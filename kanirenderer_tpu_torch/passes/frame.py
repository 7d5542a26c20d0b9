"""render_frame — the frame pipeline of every render mode (PyTorch
counterpart of ``render_band``/``render_frame`` in
``kanirenderer_tpu/passes/frame.py``, without row bands, cached shadow maps
or tables, and resize-without-recompile).

Per frame, as the reference renders it (src/lib.rs:1707-1914), with the
shadow map re-rasterized inside every frame where the mode has one:

  1. corner-major vertex stage;
  2. LIT_SHADOW and DEBUG: light-space triangle setup, binning, the K1
     shadow raster (ops/raster_cuda.rasterize_depth); the other modes emit
     an all-ones map;
  3. camera triangle setup (no back-face culling in WIREFRAME), triangle
     records, binning;
  4. the fused raster + interpolation, K2 (ops/raster_cuda.rasterize_pixels)
     or its wireframe variant K2w;
  5. shading by mode: ``shade_unlit``, ``shade_wireframe``, ``shade_lit``
     (LIT without, LIT_SHADOW and DEBUG with the PCF table; Reinhard, or
     ACES with ``hdr``), or the deferred G-buffer path (``deferred``);
  6. clear-colour compose; DEBUG composites the depth/shadow quad and the
     frame-time graph; the surface encode (sRGB, or clamp for HDR), the
     ``present_scale`` box downscale and the ``output_u8`` store (u8 for
     LDR, float16 for HDR).

All work runs on the scene's device except the uniform math, which runs
on the host (``frame_uniforms``); that round trip and the binning calls
are the frame's own device-to-host synchronisations.
``linearize_depth`` (depth picking) lives with the overlays that share it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kanirenderer_tpu_torch.core import math3d
from kanirenderer_tpu_torch.core.color import linear_to_srgb
from kanirenderer_tpu_torch.core.types import (DebugTexture, FrameState,
                                               RenderConfig, RenderMode,
                                               Scene)
from kanirenderer_tpu_torch.ops import raster_cuda
from kanirenderer_tpu_torch.ops.binning import ChunkBins, bin_tiles
from kanirenderer_tpu_torch.ops.interpolate import (PixelBuffer,
                                                    build_tri_records_corners)
from kanirenderer_tpu_torch.ops.sampling import build_shadow_table
from kanirenderer_tpu_torch.ops.vertex import (CornerOutputs, TriangleSetup,
                                               run_vertex_stage_corners,
                                               triangle_setup_corners)
from kanirenderer_tpu_torch.passes import overlay
from kanirenderer_tpu_torch.passes.overlay import linearize_depth  # noqa: F401
from kanirenderer_tpu_torch.shade import deferred, forward

Tensor = torch.Tensor

SHADOW_MODES = (RenderMode.LIT_SHADOW, RenderMode.DEBUG)


class FrameOutputs(NamedTuple):
    image: Tensor   # (H/p, W/p, 3) encoded: f32, or u8 / f16 (output_u8)
    depth: Tensor   # (H, W) f32 scene depth
    shadow: Tensor  # (shadow_dim, shadow_dim) f32, all ones without a pass
    raster_overflow: Tensor  # () i32 chunks dropped by the frame's binnings


class Geometry(NamedTuple):
    """Per-frame geometry: the kernels' inputs and the light transform.
    The shadow fields are None in modes without a shadow pass."""

    light_vp: Tensor
    vout: CornerOutputs
    shadow_setup: TriangleSetup | None
    shadow_bins: ChunkBins | None
    setup: TriangleSetup
    records: Tensor      # (T, 76) triangle records
    bins: ChunkBins


def _check_supported(cfg: RenderConfig) -> None:
    if cfg.cache_shadow_map:
        raise NotImplementedError(
            "cached shadow maps are not ported: the port renders a fresh "
            "shadow map in every frame (cache_shadow_map=False)")
    if cfg.present_scale < 1:
        raise ValueError("present_scale must be at least 1")


def frame_uniforms(state: FrameState, cfg: RenderConfig,
                   device: torch.device) -> tuple[Tensor, Tensor]:
    """(view_proj, light_vp) on ``device``: the per-frame uniform math
    (≈ State::update, src/lib.rs:1382-1704), computed on the host as the
    reference computes its uniforms, from one copy of the camera pose and
    the sun, and uploaded in one copy.  Every device then rasterizes from
    the same matrix bits: computed on the card, trigonometry and the 4×4
    products round differently in the last place, which flips the winner
    of near-coplanar surfaces."""
    cam, sun = state.camera, state.lights.directional
    host = torch.cat([t.reshape(-1) for t in (
        cam.position, cam.yaw, cam.pitch, sun.direction, sun.distance,
        sun.shadow_scene_size)]).cpu()
    fovy = torch.deg2rad(torch.tensor(cfg.fovy_deg, dtype=torch.float32))
    proj = math3d.perspective(fovy, cfg.aspect, cfg.znear, cfg.zfar)
    view_proj = proj @ math3d.camera_view_matrix(host[0:3], host[3], host[4])
    light_vp = math3d.directional_light_view_projection(host[5:8], host[8],
                                                        host[9])
    both = torch.stack([view_proj, light_vp]).to(device)
    return both[0], both[1]


def frame_geometry(scene: Scene, state: FrameState,
                   cfg: RenderConfig) -> Geometry:
    """Stages 1-3 without the rasters: uniforms, vertex stage, the setups
    and bins the mode needs."""
    W, H, D = cfg.width, cfg.height, cfg.shadow_dim
    view_proj, light_vp = frame_uniforms(state, cfg, scene.device)
    vout = run_vertex_stage_corners(scene, state.object_model,
                                    state.object_normal, view_proj, light_vp)
    sh_st = sh_bins = None
    if cfg.mode in SHADOW_MODES:
        sh_st, _ = triangle_setup_corners(
            vout.light_clip, scene.tri_valid, D, D, cull_backfaces=False,
            depth_bias_constant=cfg.shadow_bias_constant,
            depth_bias_slope=cfg.shadow_bias_slope)
        sh_bins = bin_tiles(sh_st.bbox, D, D, cfg.tile_w, cfg.shadow_tile_h,
                            cfg.shadow_chunks_per_tile)
    st, planes = triangle_setup_corners(
        vout.clip, scene.tri_valid, W, H,
        cull_backfaces=cfg.mode != RenderMode.WIREFRAME)
    records = build_tri_records_corners(vout.varyings, planes,
                                        scene.tri_extra)
    bins = bin_tiles(st.bbox, W, H, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile)
    return Geometry(light_vp=light_vp, vout=vout,
                    shadow_setup=sh_st, shadow_bins=sh_bins, setup=st,
                    records=records, bins=bins)


def _shade(scene: Scene, state: FrameState, cfg: RenderConfig,
           pix: PixelBuffer, shadow_map: Tensor, light_vp: Tensor) -> Tensor:
    """(3, H, W) linear colour of the mode (JAX render_band :391-422)."""
    mode, D = cfg.mode, cfg.shadow_dim
    cam_pos = state.camera.position
    if mode == RenderMode.UNLIT:
        return forward.shade_unlit(scene, pix)
    if mode == RenderMode.WIREFRAME:
        return forward.shade_wireframe(pix)
    table = build_shadow_table(shadow_map) if mode in SHADOW_MODES else None
    if cfg.deferred:
        gbuf = deferred.write_gbuffer(scene, pix, cam_pos, light_vp)
        return deferred.deferred_lighting(gbuf, state.lights, table, cfg.hdr,
                                          D)
    return forward.shade_lit(scene, pix, state.lights, table, cfg.hdr, D,
                             camera_pos=cam_pos, light_vp=light_vp)


def _surface(image: Tensor, state: FrameState, cfg: RenderConfig,
             depth: Tensor, shadow_map: Tensor) -> Tensor:
    """Planar (3, H, W) linear image → the (H/p, W/p, 3) surface (JAX
    render_band :427-488): sRGB encode for the LDR surface, clamp for the
    HDR one; DEBUG overlays composite before the encode, as the
    reference's overlay pipelines draw linear colours onto the surface."""
    p = cfg.present_scale

    def encode(img):
        return torch.clamp(img, 0.0, 1.0) if cfg.hdr else linear_to_srgb(img)

    def downscale(img):  # channel-last box average by p
        if p <= 1:
            return img
        H, W = img.shape[0] // p * p, img.shape[1] // p * p
        return img[:H, :W].reshape(H // p, p, W // p, p, 3).mean((1, 3))

    def quantize(img):  # Rgba8 (== runtime/display.to_uint8) or Rgba16Float
        if not cfg.output_u8:
            return img
        if cfg.hdr:
            return img.to(torch.float16)
        return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)

    if cfg.mode == RenderMode.DEBUG:
        image = image.permute(1, 2, 0)
        tex = shadow_map if cfg.debug_texture == DebugTexture.SHADOW_MAP \
            else depth
        image = overlay.debug_texture_quad(image, tex, cfg.znear, cfg.zfar)
        image = overlay.frame_time_graph(image, state.frame_times_ms)
        return quantize(downscale(encode(image))).contiguous()
    # Encode while planar, elementwise, so it commutes with the transpose.
    image = encode(image).permute(1, 2, 0)
    return quantize(downscale(image)).contiguous()


def render_frame(scene: Scene, state: FrameState,
                 config: RenderConfig) -> FrameOutputs:
    """Render one frame of ``config.mode`` with a fresh shadow map where the
    mode has one."""
    cfg = config
    _check_supported(cfg)
    g = frame_geometry(scene, state, cfg)
    D = cfg.shadow_dim

    # shadow pass (src/lib.rs:1721-1751)
    overflow = g.bins.overflow
    if g.shadow_setup is not None:
        shadow_map = raster_cuda.rasterize_depth(
            g.shadow_setup.setup, g.shadow_setup.bbox, g.shadow_bins, D)
        overflow = overflow + g.shadow_bins.overflow
    else:
        shadow_map = torch.ones((D, D), dtype=torch.float32,
                                device=scene.device)

    # main raster + varying interpolation
    pix = raster_cuda.rasterize_pixels(
        g.records, g.setup.setup, g.setup.bbox, g.bins, cfg.width,
        cfg.height,
        wireframe=cfg.mode == RenderMode.WIREFRAME,
        wire_thresh=cfg.wire_thresh_px)

    color = _shade(scene, state, cfg, pix, shadow_map, g.light_vp)
    clear = torch.tensor(cfg.clear_color, dtype=torch.float32,
                         device=scene.device)[:, None, None]
    image = torch.where(pix.mask[None], color, clear)
    return FrameOutputs(image=_surface(image, state, cfg, pix.z, shadow_map),
                        depth=pix.z, shadow=shadow_map,
                        raster_overflow=overflow)

