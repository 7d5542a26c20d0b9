"""The plain reference frame: the camera pose from the events, the frame's
uniforms and one whole frame of the mode, written with the frozen copies
beside this file and nothing of the program.

Frozen from ``kanirenderer_tpu_torch`` at commit 1e399aa:
``runtime/controllers.update_camera_host``, ``runtime/loop._camera_inputs``
and ``_host_start_state``, ``passes/frame.frame_uniforms_host`` and the
whole-frame body of ``passes/frame.render_band`` with a fresh shadow map,
no bands and no occlusion skip (which renders the same pixels).  The
movable light takes no input in the benchmark's traffic, so it stays at
its start; the sun stays where the rig puts it.  The rig is
``default_lights``' unless a caller hands in another (a configuration's
``point_lights``), as the loop's ``point_lights`` argument chooses.

``lowp=True`` is the control: the same frame with every floating-point
stage result rounded to bfloat16 (the uniforms, the vertex stage's clip
positions and varyings, the setup rows and records, the interpolated
pixels, the shaded colour), the nearest precision below the float32 the
configuration states.  A comparison that cannot tell it from the program
cannot guard the program's precision.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import math3d
from portbench.reference.binning import bin_tiles
from portbench.reference.color import linear_to_srgb
from portbench.reference.forward import shade_lit, shade_wireframe
from portbench.reference.interpolate import build_tri_records_corners
from portbench.reference.raster import (rasterize_depth_plain,
                                        rasterize_pixels_plain)
from portbench.reference.sampling import build_shadow_table
from portbench.reference.types import (CameraState, FrameState, Lights,
                                       RenderConfig, RenderMode, Scene,
                                       default_lights)
from portbench.reference.vertex import (run_vertex_stage_corners,
                                        triangle_setup_corners)

SAFE_PITCH = 1.5707964 - 1e-4
CAMERA_SPEED = 300.0
CAMERA_SENSITIVITY = 0.4
START = dict(position=(0.0, 5.0, 10.0), yaw_deg=-90.0, pitch_deg=-20.0)


def start_pose():
    """(position, yaw, pitch) of the loop's first frame, host float32."""
    return (np.array(START["position"], np.float32),
            np.deg2rad(np.float32(START["yaw_deg"])),
            np.deg2rad(np.float32(START["pitch_deg"])))


def step_pose(pose, held, mouse_dx, mouse_dy, mouse_look, dt):
    """One frame of the camera controller on host float32 values: the keys
    held (WASD, arrows, space, lshift) and the mouse delta while looking."""
    position, yaw, pitch = pose
    f32 = np.float32
    fwd = 1.0 if ("w" in held or "up" in held) else 0.0
    back = 1.0 if ("s" in held or "down" in held) else 0.0
    left = 1.0 if ("a" in held or "left" in held) else 0.0
    right_k = 1.0 if ("d" in held or "right" in held) else 0.0
    up = 1.0 if "space" in held else 0.0
    down = 1.0 if "lshift" in held else 0.0
    rdx = mouse_dx if mouse_look else 0.0
    rdy = mouse_dy if mouse_look else 0.0
    dt, speed, sens = f32(dt), f32(CAMERA_SPEED), f32(CAMERA_SENSITIVITY)
    yaw, pitch = f32(yaw), f32(pitch)
    ys, yc = np.sin(yaw), np.cos(yaw)
    forward = np.array([yc, 0.0, ys], np.float32)
    right = np.array([-ys, 0.0, yc], np.float32)
    pos = np.asarray(position, np.float32).copy()
    pos += forward * (f32(fwd) - f32(back)) * speed * dt
    pos += right * (f32(right_k) - f32(left)) * speed * dt
    ps, pc = np.sin(pitch), np.cos(pitch)
    sv = np.array([pc * yc, ps, pc * ys], np.float32)
    sv = sv / np.linalg.norm(sv).astype(np.float32)
    pos += sv.astype(np.float32) * f32(0.0) * speed * sens * dt
    pos[1] += (f32(up) - f32(down)) * speed * dt
    yaw = yaw + f32(rdx) * sens * dt
    pitch = pitch + (-f32(rdy)) * sens * dt
    pitch = np.clip(pitch, f32(-SAFE_PITCH), f32(SAFE_PITCH))
    return pos.astype(np.float32), f32(yaw), f32(pitch)


def frame_uniforms_host(position, yaw, pitch, sun_direction, sun_distance,
                        shadow_scene_size, cfg: RenderConfig):
    """(2, 4, 4) [view_proj, light_vp] on the CPU from host values."""
    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    fovy = torch.deg2rad(torch.tensor(cfg.fovy_deg, dtype=torch.float32))
    proj = math3d.perspective(fovy, cfg.aspect, cfg.znear, cfg.zfar)
    view_proj = proj @ math3d.camera_view_matrix(f32(position), f32(yaw),
                                                 f32(pitch))
    light_vp = math3d.directional_light_view_projection(
        f32(sun_direction), f32(sun_distance), f32(shadow_scene_size))
    return torch.stack([view_proj, light_vp])


def _rounder(lowp: bool):
    if not lowp:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(t.dtype)


def frame_inputs(scene: Scene, pose, cfg: RenderConfig, lowp: bool = False,
                 lights: Lights | None = None):
    """(FrameState, (view_proj, light_vp)) of a pose on the scene's device,
    with the light rig ``lights`` (on that device), by default the one of
    one point light."""
    dev = scene.device
    q = _rounder(lowp)
    rig = default_lights(device=dev) if lights is None else lights
    sun = rig.directional
    host_sun = [t.cpu().numpy() for t in (sun.direction, sun.distance,
                                          sun.shadow_scene_size)]
    u = q(frame_uniforms_host(pose[0], pose[1], pose[2], *host_sun, cfg)
          .to(dev))
    cam = CameraState(
        position=torch.from_numpy(np.asarray(pose[0], np.float32)).to(dev),
        yaw=torch.tensor(pose[1], dtype=torch.float32, device=dev),
        pitch=torch.tensor(pose[2], dtype=torch.float32, device=dev))
    state = FrameState(
        camera=cam, lights=Lights(rig.movable, rig.points, sun),
        object_model=scene.object_model, object_normal=scene.object_normal,
        frame_times_ms=torch.zeros(256, dtype=torch.float32, device=dev))
    return state, (u[0], u[1])


def camera_geometry(scene: Scene, pose, cfg: RenderConfig,
                    lowp: bool = False, lights: Lights | None = None):
    """(state, uniforms, vertex outputs, camera TriangleSetup, planes)."""
    q = _rounder(lowp)
    state, (view_proj, light_vp) = frame_inputs(scene, pose, cfg, lowp,
                                                lights)
    vout = run_vertex_stage_corners(scene, state.object_model,
                                    state.object_normal, view_proj, light_vp)
    vout = type(vout)(*(q(t) for t in vout))
    st, planes = triangle_setup_corners(
        vout.clip, scene.tri_valid, cfg.width, cfg.height,
        cull_backfaces=cfg.mode != RenderMode.WIREFRAME)
    return state, (view_proj, light_vp), vout, st, q(planes)


def shadow_setup(scene: Scene, vout, cfg: RenderConfig):
    """The light-space TriangleSetup of the shadow pass."""
    D = cfg.shadow_dim
    st, _ = triangle_setup_corners(vout.light_clip, scene.tri_valid, D, D,
                                   False, cfg.shadow_bias_constant,
                                   cfg.shadow_bias_slope)
    return st


@torch.no_grad()
def render_frame(scene: Scene, pose, cfg: RenderConfig,
                 lowp: bool = False,
                 lights: Lights | None = None) -> np.ndarray:
    """The (H, W, 3) u8 surface of one frame of ``cfg.mode`` (LIT,
    LIT_SHADOW or WIREFRAME; LDR) at ``pose``, lit by ``lights``
    (``frame_inputs``)."""
    q = _rounder(lowp)
    mode, D = cfg.mode, cfg.shadow_dim
    state, (view_proj, light_vp), vout, st, planes = camera_geometry(
        scene, pose, cfg, lowp, lights)
    table = None
    if mode == RenderMode.LIT_SHADOW:
        sst = shadow_setup(scene, vout, cfg)
        sbins = bin_tiles(sst.bbox, D, D, cfg.tile_w, cfg.shadow_tile_h,
                          cfg.shadow_chunks_per_tile)
        smap = rasterize_depth_plain(q(sst.setup), sst.bbox, sbins, D)
        table = build_shadow_table(smap)
        del sbins, smap, sst
    records = q(build_tri_records_corners(vout.varyings, planes,
                                          scene.tri_extra))
    bins = bin_tiles(st.bbox, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile)
    pix = rasterize_pixels_plain(
        records, q(st.setup), st.bbox, bins, cfg.width, cfg.height,
        wireframe=mode == RenderMode.WIREFRAME,
        wire_thresh=cfg.wire_thresh_px)
    del records, bins, vout
    pix = pix._replace(varyings=q(pix.varyings))
    if mode == RenderMode.WIREFRAME:
        color = shade_wireframe(pix)
    else:
        color = shade_lit(scene, pix, state.lights, table, cfg.hdr, D,
                          camera_pos=state.camera.position,
                          light_vp=light_vp)
    clear = torch.tensor(cfg.clear_color, dtype=torch.float32,
                         device=pix.z.device)[:, None, None]
    image = q(torch.where(pix.mask[None], color, clear))
    image = linear_to_srgb(image).permute(1, 2, 0)
    image = torch.clamp(image * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return image.contiguous().cpu().numpy()
