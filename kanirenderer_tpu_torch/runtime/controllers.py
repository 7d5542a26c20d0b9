"""Input controllers as pure state transitions (counterpart of
``kanirenderer_tpu/runtime/controllers.py``; reference
src/camera.rs:90-198, src/light.rs:172-283).

Two forms of each of the four controllers.  The ``*_host`` functions are
pure numpy in float32 on host values: the per-frame update is a few
scalars, so the interactive loop keeps the pose and the lights on the host
and uploads only the result.  The functions without the suffix do the same
on tensors, on the device of their input.

Bindings (reference src/main.rs:11-17, src/lib.rs:1208-1379):
  camera: WASD/arrows planar, Space/LShift vertical, mouse look (RMB held),
          scroll zoom along the view direction;
  movable light: IJKL planar, U/O vertical, =/- range, [/] colour;
  directional light: R/T/Y rotate 4° about x/y/z, Key2/Key3 distance ±10.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kanirenderer_tpu_torch.core import math3d
from kanirenderer_tpu_torch.core.types import (CameraState, DirectionalLight,
                                               MovableLight)

SAFE_PITCH = 1.5707964 - 1e-4  # FRAC_PI_2 - 0.0001 (reference src/camera.rs:15)
CAMERA_SPEED = 300.0        # reference src/lib.rs:386
CAMERA_SENSITIVITY = 0.4
LIGHT_SPEED = 300.0         # reference src/lib.rs:445


class CameraInputs(NamedTuple):
    """Per-frame input amounts (1.0 while a key is held, mouse deltas px)."""

    forward: float = 0.0
    backward: float = 0.0
    left: float = 0.0
    right: float = 0.0
    up: float = 0.0
    down: float = 0.0
    rotate_dx: float = 0.0
    rotate_dy: float = 0.0
    scroll: float = 0.0


class LightInputs(NamedTuple):
    forward: float = 0.0
    backward: float = 0.0
    left: float = 0.0
    right: float = 0.0
    up: float = 0.0
    down: float = 0.0
    d_range: float = 0.0   # ±5 steps applied on key press
    d_color: float = 0.0   # ±5 per channel on key press


class HostCamera(NamedTuple):
    """Camera pose as host float32 values (position (3,), yaw, pitch)."""

    position: np.ndarray
    yaw: np.float32
    pitch: np.float32


def _f32(x):
    return np.float32(x)


def update_camera_host(cam: HostCamera, inp: CameraInputs, dt: float,
                       speed: float = CAMERA_SPEED,
                       sensitivity: float = CAMERA_SENSITIVITY) -> HostCamera:
    """Yaw-basis planar movement, scroll along the pitched view direction,
    mouse-delta yaw/pitch with pitch clamped to ±(π/2 − 1e-4)."""
    dt = _f32(dt)
    speed = _f32(speed)
    sensitivity = _f32(sensitivity)
    yaw = _f32(cam.yaw)
    pitch = _f32(cam.pitch)
    yaw_sin, yaw_cos = np.sin(yaw), np.cos(yaw)
    forward = np.array([yaw_cos, 0.0, yaw_sin], np.float32)
    right = np.array([-yaw_sin, 0.0, yaw_cos], np.float32)
    pos = np.asarray(cam.position, np.float32).copy()
    pos += forward * (_f32(inp.forward) - _f32(inp.backward)) * speed * dt
    pos += right * (_f32(inp.right) - _f32(inp.left)) * speed * dt

    pitch_sin, pitch_cos = np.sin(pitch), np.cos(pitch)
    sv = np.array([pitch_cos * yaw_cos, pitch_sin, pitch_cos * yaw_sin],
                  np.float32)
    sv = sv / np.linalg.norm(sv).astype(np.float32)
    pos += sv.astype(np.float32) * _f32(inp.scroll) * speed \
        * sensitivity * dt
    pos[1] += (_f32(inp.up) - _f32(inp.down)) * speed * dt

    yaw = yaw + _f32(inp.rotate_dx) * sensitivity * dt
    pitch = pitch + (-_f32(inp.rotate_dy)) * sensitivity * dt
    pitch = np.clip(pitch, _f32(-SAFE_PITCH), _f32(SAFE_PITCH))
    return HostCamera(position=pos.astype(np.float32), yaw=_f32(yaw),
                      pitch=_f32(pitch))


def update_movable_light_host(light: MovableLight, inp: LightInputs,
                              dt: float,
                              speed: float = LIGHT_SPEED) -> MovableLight:
    """MovableLightController::update_light (src/light.rs:263-282) and the
    range/colour key steps (src/light.rs:229-258) on host values: range ±5
    within (32, 12800), colour ∓5 per channel within (1e-5, 10000).  The
    guard tests the bound, the step applies whatever its direction, as in
    the reference."""
    dt = _f32(dt)
    speed = _f32(speed)
    yaw = _f32(light.yaw)
    yaw_sin, yaw_cos = np.sin(yaw), np.cos(yaw)
    forward = np.array([yaw_cos, 0.0, yaw_sin], np.float32)
    right = np.array([-yaw_sin, 0.0, yaw_cos], np.float32)
    pos = np.asarray(light.position, np.float32).copy()
    pos += forward * (_f32(inp.forward) - _f32(inp.backward)) * speed * dt
    pos += right * (_f32(inp.right) - _f32(inp.left)) * speed * dt
    pos[1] += (_f32(inp.up) - _f32(inp.down)) * speed * dt

    rng = _f32(light.range)
    if inp.d_range > 0 and rng > 32.0:
        rng = rng + _f32(5.0)
    if inp.d_range < 0 and rng < 12800.0:
        rng = rng - _f32(5.0)
    col = np.asarray(light.color, np.float32).copy()
    if inp.d_color < 0 and col[0] > 1e-5:
        col = col - _f32(5.0)
    if inp.d_color > 0 and col[0] < 10000.0:
        col = col + _f32(5.0)
    return MovableLight(position=pos.astype(np.float32),
                        color=col.astype(np.float32), range=rng, yaw=yaw)


def _rot_mats_host(deg_x, deg_y, deg_z):
    out = []
    for deg, (i, j) in ((deg_x, (1, 2)), (deg_y, (2, 0)), (deg_z, (0, 1))):
        a = np.deg2rad(_f32(deg)).astype(np.float32)
        c, s = np.cos(a), np.sin(a)
        m = np.eye(3, dtype=np.float32)
        m[i, i] = c
        m[i, j] = -s
        m[j, i] = s
        m[j, j] = c
        out.append(m)
    return out  # [Rx, Ry, Rz]


def rotate_directional_light_host(d: DirectionalLight, deg_x: float,
                                  deg_y: float,
                                  deg_z: float) -> DirectionalLight:
    """R/T/Y keys: rotate the sun by Rz·Ry·Rx (degrees) on host values
    (reference src/lib.rs:1341-1355 → src/light.rs:112-119)."""
    rx, ry, rz = _rot_mats_host(deg_x, deg_y, deg_z)
    new_dir = (rz @ ry @ rx) @ np.asarray(d.direction, np.float32)
    return d._replace(direction=new_dir.astype(np.float32))


def step_directional_distance_host(d: DirectionalLight,
                                   delta: float) -> DirectionalLight:
    """Key2/Key3 on host values: distance ±10 clamped to [-3000, -100],
    shadow_scene_size = |distance| · 1.5 (reference src/lib.rs:1329-1340)."""
    dist = np.clip(_f32(d.distance) + _f32(delta), -3000.0, -100.0) \
        .astype(np.float32)
    return d._replace(distance=dist,
                      shadow_scene_size=np.abs(dist) * _f32(1.5))


# ---- the same transitions on tensors ----

def _yaw_basis(yaw: torch.Tensor):
    s, c, zero = torch.sin(yaw), torch.cos(yaw), torch.zeros_like(yaw)
    return torch.stack([c, zero, s]), torch.stack([-s, zero, c])


def update_camera(cam: CameraState, inp: CameraInputs, dt: float,
                  speed: float = CAMERA_SPEED,
                  sensitivity: float = CAMERA_SENSITIVITY) -> CameraState:
    """``update_camera_host`` on a CameraState of tensors."""
    forward, right = _yaw_basis(cam.yaw)
    pos = cam.position
    pos = pos + forward * (inp.forward - inp.backward) * speed * dt
    pos = pos + right * (inp.right - inp.left) * speed * dt
    scrollward = math3d.camera_forward(cam.yaw, cam.pitch)
    pos = pos + scrollward * inp.scroll * speed * sensitivity * dt
    lift = torch.zeros_like(pos)
    lift[1] = (inp.up - inp.down) * speed * dt
    yaw = cam.yaw + inp.rotate_dx * sensitivity * dt
    pitch = cam.pitch + (-inp.rotate_dy) * sensitivity * dt
    return CameraState(position=pos + lift, yaw=yaw,
                       pitch=torch.clamp(pitch, -SAFE_PITCH, SAFE_PITCH))


def update_movable_light(light: MovableLight, inp: LightInputs, dt: float,
                         speed: float = LIGHT_SPEED) -> MovableLight:
    """``update_movable_light_host`` on a MovableLight of tensors."""
    forward, right = _yaw_basis(light.yaw)
    pos = light.position
    pos = pos + forward * (inp.forward - inp.backward) * speed * dt
    pos = pos + right * (inp.right - inp.left) * speed * dt
    lift = torch.zeros_like(pos)
    lift[1] = (inp.up - inp.down) * speed * dt
    rng = light.range
    rng = torch.where((rng > 32.0) & (inp.d_range > 0), rng + 5.0, rng)
    rng = torch.where((rng < 12800.0) & (inp.d_range < 0), rng - 5.0, rng)
    col = light.color
    col = torch.where((col[0] > 1e-5) & (inp.d_color < 0), col - 5.0, col)
    col = torch.where((col[0] < 10000.0) & (inp.d_color > 0), col + 5.0, col)
    return MovableLight(position=pos + lift, color=col, range=rng,
                        yaw=light.yaw)


def rotate_directional_light(d: DirectionalLight, deg_x: float, deg_y: float,
                             deg_z: float) -> DirectionalLight:
    """``rotate_directional_light_host`` on a DirectionalLight of tensors."""
    return d._replace(direction=math3d.rotate_direction_zyx(
        d.direction, deg_x, deg_y, deg_z))


def step_directional_distance(d: DirectionalLight,
                              delta: float) -> DirectionalLight:
    """``step_directional_distance_host`` on a DirectionalLight of tensors."""
    dist = torch.clamp(d.distance + delta, -3000.0, -100.0)
    return d._replace(distance=dist, shadow_scene_size=torch.abs(dist) * 1.5)
