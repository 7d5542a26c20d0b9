"""render_frame — the LIT_SHADOW frame pipeline (PyTorch counterpart of
``render_band``/``render_frame`` in ``kanirenderer_tpu/passes/frame.py``).

Per frame, as the reference renders it (src/lib.rs:1707-1914), with the
shadow map re-rasterized inside every frame:

  1. corner-major vertex stage;
  2. light-space triangle setup and binning;
  3. K1 shadow raster (ops/raster_cuda.rasterize_depth), PCF table;
  4. camera triangle setup, triangle records, binning;
  5. K2 fused raster + interpolation (ops/raster_cuda.rasterize_pixels);
  6. shade_lit: combined-table materials, 3×3 PCF, Blinn-Phong, Reinhard;
  7. clear-colour compose, sRGB encode and the optional u8 quantize.

All work runs on the scene's device; the two binning calls are the frame's
only device-to-host synchronisations.  Other render modes, HDR, the
deferred path, banded rendering and cached shadow maps are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kanirenderer_tpu_torch.core import math3d
from kanirenderer_tpu_torch.core.color import linear_to_srgb
from kanirenderer_tpu_torch.core.types import (FrameState, RenderConfig,
                                               RenderMode, Scene)
from kanirenderer_tpu_torch.ops import raster_cuda
from kanirenderer_tpu_torch.ops.binning import ChunkBins, bin_tiles
from kanirenderer_tpu_torch.ops.interpolate import build_tri_records_corners
from kanirenderer_tpu_torch.ops.sampling import build_shadow_table
from kanirenderer_tpu_torch.ops.vertex import (CornerOutputs, TriangleSetup,
                                               run_vertex_stage_corners,
                                               triangle_setup_corners)
from kanirenderer_tpu_torch.shade import forward

Tensor = torch.Tensor


class FrameOutputs(NamedTuple):
    image: Tensor   # (H, W, 3) sRGB-encoded, f32 or u8 (output_u8)
    depth: Tensor   # (H, W) f32 scene depth
    shadow: Tensor  # (shadow_dim, shadow_dim) f32 shadow map
    raster_overflow: Tensor  # () i32 chunks dropped by both binnings


class Geometry(NamedTuple):
    """Per-frame geometry: the kernels' inputs and the light transform."""

    light_vp: Tensor
    vout: CornerOutputs
    shadow_setup: TriangleSetup
    shadow_bins: ChunkBins
    setup: TriangleSetup
    records: Tensor      # (T, 76) triangle records
    bins: ChunkBins


def _check_supported(cfg: RenderConfig) -> None:
    if (cfg.mode != RenderMode.LIT_SHADOW or cfg.hdr or cfg.deferred
            or cfg.present_scale != 1):
        raise NotImplementedError(
            "the port renders LIT_SHADOW, LDR, forward, present_scale=1")


def frame_geometry(scene: Scene, state: FrameState,
                   cfg: RenderConfig) -> Geometry:
    """Stages 1, 2 and 4: uniforms, vertex stage, both setups and bins."""
    dev = scene.device
    W, H, D = cfg.width, cfg.height, cfg.shadow_dim

    # per-frame uniform math (≈ State::update, src/lib.rs:1382-1704)
    fovy = torch.deg2rad(torch.tensor(cfg.fovy_deg, dtype=torch.float32,
                                      device=dev))
    proj = math3d.perspective(fovy, cfg.aspect, cfg.znear, cfg.zfar)
    cam = state.camera
    view_proj = proj @ math3d.camera_view_matrix(cam.position, cam.yaw,
                                                 cam.pitch)
    sun = state.lights.directional
    light_vp = math3d.directional_light_view_projection(
        sun.direction, sun.distance, sun.shadow_scene_size)

    vout = run_vertex_stage_corners(scene, state.object_model,
                                    state.object_normal, view_proj, light_vp)
    sh_st, _ = triangle_setup_corners(
        vout.light_clip, scene.tri_valid, D, D, cull_backfaces=False,
        depth_bias_constant=cfg.shadow_bias_constant,
        depth_bias_slope=cfg.shadow_bias_slope)
    sh_bins = bin_tiles(sh_st.bbox, D, D, cfg.tile_w, cfg.shadow_tile_h,
                        cfg.shadow_chunks_per_tile)
    st, planes = triangle_setup_corners(vout.clip, scene.tri_valid, W, H,
                                        cull_backfaces=True)
    records = build_tri_records_corners(vout.varyings, planes,
                                        scene.tri_extra)
    bins = bin_tiles(st.bbox, W, H, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile)
    return Geometry(light_vp=light_vp, vout=vout,
                    shadow_setup=sh_st, shadow_bins=sh_bins, setup=st,
                    records=records, bins=bins)


def render_frame(scene: Scene, state: FrameState,
                 config: RenderConfig) -> FrameOutputs:
    """Render one LIT_SHADOW frame with a fresh shadow map."""
    cfg = config
    _check_supported(cfg)
    g = frame_geometry(scene, state, cfg)
    D = cfg.shadow_dim

    # shadow pass (src/lib.rs:1721-1751)
    shadow_map = raster_cuda.rasterize_depth(
        g.shadow_setup.setup, g.shadow_setup.bbox, g.shadow_bins, D)
    shadow_tbl = build_shadow_table(shadow_map)

    # main raster + varying interpolation
    pix = raster_cuda.rasterize_pixels(g.records, g.setup.bbox, g.bins,
                                       cfg.width, cfg.height)

    color = forward.shade_lit(scene, pix, state.lights, shadow_tbl, False, D,
                              camera_pos=state.camera.position,
                              light_vp=g.light_vp)

    clear = torch.tensor(cfg.clear_color, dtype=torch.float32,
                         device=scene.device)[:, None, None]
    image = linear_to_srgb(torch.where(pix.mask[None], color, clear))
    if cfg.output_u8:
        # Rgba8 surface store, == runtime/display.to_uint8
        image = torch.clamp(image * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return FrameOutputs(image=image.permute(1, 2, 0).contiguous(),
                        depth=pix.z, shadow=shadow_map,
                        raster_overflow=g.shadow_bins.overflow + pix.overflow)
