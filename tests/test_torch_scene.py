"""The port's scene packing and package boundary against the JAX package.

Tolerance: exact.  Both packages run the same numpy host code on the same
seed, so every Scene array must match in shape, dtype and value.  The
reference's optional native TBN/Morton library is patched off here, so it
takes its numpy paths too (a Morton tie broken differently would reorder
triangles and so every chunk).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import kanirenderer_tpu as kani
from kanirenderer_tpu.io import native as ref_native
from kanirenderer_tpu.models import procedural as ref_procedural

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(target_tris=6000, num_materials=4, tex_size=32)


def reference_scene(**kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_native, "compute_tbn", lambda *a: None)
        mp.setattr(ref_native, "morton_order", lambda *a: None)
        return ref_procedural.sponza_standin_scene(**kw)


@pytest.mark.parametrize("kw", [SMALL, dict(target_tris=20000,
                                            num_materials=3, tex_size=16,
                                            seed=5)])
def test_scene_matches_reference(kw):
    ref = reference_scene(**kw)
    ours = sponza_standin_scene(**kw, device="cpu")
    for name in port.Scene._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(ours, name).numpy()
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_from_reference_carries_state():
    scene = reference_scene(**SMALL)
    cam = kani.CameraState(position=np.array([1.0, 2.0, 3.0], np.float32),
                           yaw=np.float32(0.5), pitch=np.float32(-0.25))
    state = kani.frame_state(scene, cam, kani.default_lights(3))
    ours = port.from_reference(state, device="cpu")
    assert isinstance(ours, port.FrameState)
    assert isinstance(ours.lights.points, port.PointLights)
    assert ours.lights.points.position.shape == (3, 3)
    np.testing.assert_array_equal(ours.camera.position.numpy(), [1, 2, 3])
    assert ours.camera.yaw.dtype == torch.float32
    np.testing.assert_array_equal(ours.object_model.numpy(),
                                  np.asarray(scene.object_model))
    ours.object_model.add_(1.0)   # a writable copy, not the JAX buffer
    assert np.asarray(scene.object_model)[0, 0, 0] == 1.0


def test_defaults_match_reference():
    """Light rig and initial camera, value for value."""
    ref = port.from_reference(kani.default_lights(2), device="cpu")
    ours = port.default_lights(2, device="cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(ref),
                    torch.utils._pytree.tree_leaves(ours)):
        torch.testing.assert_close(a, b, rtol=2e-7, atol=0)
    torch.testing.assert_close(
        port.from_reference(kani.default_camera(), device="cpu"),
        port.default_camera(device="cpu"), rtol=2e-7, atol=0)


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib, kanirenderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import kanirenderer_tpu_torch.flythrough\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'kanirenderer_tpu')]\n"
        "assert 'torch' in sys.modules\n"
        "print(len(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0", out.stdout


def test_entry_points_default_to_the_card():
    """Every entry point that builds tensors puts them on the CUDA device
    unless told otherwise: with a card the defaults land there; without
    one each default call raises rather than building on the CPU."""
    from kanirenderer_tpu_torch.io.scene_loader import SceneBuilder
    small = dict(target_tris=300, num_materials=1, tex_size=8)
    calls = {
        "default_lights": port.default_lights,
        "default_camera": port.default_camera,
        "camera_state": lambda: port.camera_state([0.0, 1.0, 2.0], 0.0, 0.0),
        "from_reference": lambda: port.from_reference(kani.default_lights()),
        "SceneBuilder.build": lambda: SceneBuilder().build(),
        "sponza_standin_scene": lambda: sponza_standin_scene(**small),
    }
    if torch.cuda.is_available():
        for name, call in calls.items():
            leaves = torch.utils._pytree.tree_leaves(call())
            assert all(t.device.type == "cuda" for t in leaves), name
    else:
        for name, call in calls.items():
            with pytest.raises((AssertionError, RuntimeError)):
                call()
