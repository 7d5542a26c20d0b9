"""Camera controller as a host-side state transition (counterpart of
``CameraInputs``/``update_camera_host`` in
``kanirenderer_tpu/runtime/controllers.py``; reference
src/camera.rs:170-197).  Pure numpy in float32: the per-frame camera update
is a few scalars, so it stays on the host and only the result is uploaded.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SAFE_PITCH = 1.5707964 - 1e-4  # FRAC_PI_2 - 0.0001 (reference src/camera.rs:15)
CAMERA_SPEED = 300.0        # reference src/lib.rs:386
CAMERA_SENSITIVITY = 0.4


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
