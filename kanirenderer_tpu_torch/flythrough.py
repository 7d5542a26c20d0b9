"""Fly-through: frames of any render mode over a deterministic camera path.

The path is the JAX package's bench fly-through (bench.py:107-137): the
camera starts at ``BENCH_CAM0`` and each frame integrates
``BENCH_INPUTS`` (forward 1.0, yaw 6 px) over 1/60 s on the host.  Each
frame is rendered with ``passes.frame.render_frame`` and timed on the host
clock around work that ends in a device synchronisation.

``BENCH_CONFIG`` is the bench's LIT_SHADOW frame; ``MODE_CONFIGS`` holds
the other configurations of ``render_frame``, each the bench frame with
one setting changed (DEBUG once per debug texture).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from kanirenderer_tpu_torch.core.types import (DebugTexture, RenderConfig,
                                               RenderMode, Scene,
                                               camera_state, default_lights,
                                               frame_state)
from kanirenderer_tpu_torch.passes.frame import FrameOutputs, render_frame
from kanirenderer_tpu_torch.runtime.controllers import (CameraInputs,
                                                        HostCamera,
                                                        update_camera_host)

BENCH_CAM0 = HostCamera(position=np.array([-1000.0, 180.0, 0.0], np.float32),
                        yaw=np.float32(0.0),
                        pitch=np.float32(np.deg2rad(-5.0)))
BENCH_INPUTS = CameraInputs(forward=1.0, rotate_dx=6.0)
BENCH_CONFIG = RenderConfig(width=1920, height=1080,
                            mode=RenderMode.LIT_SHADOW, output_u8=True)


def _bench(**changes) -> RenderConfig:
    return dataclasses.replace(BENCH_CONFIG, **changes)


MODE_CONFIGS = {
    "unlit": _bench(mode=RenderMode.UNLIT),
    "lit": _bench(mode=RenderMode.LIT),
    "wireframe": _bench(mode=RenderMode.WIREFRAME),
    "debug_depth": _bench(mode=RenderMode.DEBUG,
                          debug_texture=DebugTexture.SCENE_DEPTH),
    "debug_shadow": _bench(mode=RenderMode.DEBUG,
                           debug_texture=DebugTexture.SHADOW_MAP),
    "hdr": _bench(hdr=True),
    "deferred": _bench(deferred=True),
    "present_scale2": _bench(present_scale=2),
}


def camera_path(frames: int, cam0: HostCamera = BENCH_CAM0,
                inputs: CameraInputs = BENCH_INPUTS,
                dt: float = 1.0 / 60.0) -> list[HostCamera]:
    """The ``frames`` poses after ``cam0`` (cam0 itself excluded, as the
    bench renders them)."""
    cams = [cam0]
    for _ in range(frames):
        cams.append(update_camera_host(cams[-1], inputs, dt))
    return cams[1:]


def fly(scene: Scene, config: RenderConfig, cams: list[HostCamera],
        lights=None) -> Iterator[tuple[FrameOutputs, float]]:
    """Render one frame per pose; yields (outputs, wall ms) per frame.  On a
    CUDA device each frame ends in a synchronisation, so the time covers
    the whole frame."""
    dev = scene.device
    lights = default_lights(device=dev) if lights is None else lights
    for cam in cams:
        t0 = time.perf_counter()
        state = frame_state(scene, camera_state(cam.position, cam.yaw,
                                                cam.pitch, dev), lights)
        out = render_frame(scene, state, config)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        yield out, (time.perf_counter() - t0) * 1e3
