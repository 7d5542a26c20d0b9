"""The cube goldens (tests/goldens/cube_*.png) rendered through the port.

The same seven cases, camera, lights, 160×120 frame and 256² shadow map as
tests/test_golden.py, with the cube scene built by the JAX package and
carried across with ``from_reference``; the port renders every case
through its own pipeline (tile rasters, corner-major interpolation) where
the goldens came from the JAX package's brute-force XLA backend.  The
criterion is the goldens' own (tests/test_golden.py:65-68): under 1% of
values more than 8 levels off and a mean difference under 1.5 levels.
"""

import os

import numpy as np
import pytest

import kanirenderer_tpu as kani
from kanirenderer_tpu.io.image import decode_png
from kanirenderer_tpu.models.procedural import cube_scene

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.passes.frame import render_frame

from test_golden import CAM, CASES, GOLDEN_DIR


@pytest.fixture(scope="module")
def cube():
    scene = port.from_reference(cube_scene(), device="cpu")
    state = port.frame_state(scene,
                             port.from_reference(CAM, device="cpu"),
                             port.from_reference(kani.default_lights(),
                                                 device="cpu"))
    return scene, state


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_cube_golden(cube, name, kw):
    scene, state = cube
    enums = {"mode": port.RenderMode, "debug_texture": port.DebugTexture}
    kw = {k: enums[k](int(v)) if k in enums else v for k, v in kw.items()}
    cfg = port.RenderConfig(width=160, height=120, shadow_dim=256, **kw)
    out = render_frame(scene, state, cfg)
    img = np.clip(out.image.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    path = os.path.join(GOLDEN_DIR, f"cube_{name}.png")
    golden = decode_png(open(path, "rb").read())
    assert img.shape == golden.shape
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert (diff > 8).mean() < 0.01, f"{name}: {(diff > 8).mean():.4f}"
    assert diff.mean() < 1.5, f"{name}: mean {diff.mean():.3f}"
