"""The port's whole frame against the JAX package's render_frame, in every
configuration of the bench (LIT_SHADOW here with UNLIT, LIT, WIREFRAME,
HDR and present_scale; DEBUG and deferred in tests/test_torch_modes.py).

Criterion: the golden one of tests/test_golden.py:65-68 on the u8 image —
under 1% of values more than 8 levels off and a mean difference under 1.5
levels; the HDR surface (float16) is compared at 255 times its values.

The reference frame runs op by op (``jax.disable_jit``), with only its two
brute-force rasterizers compiled.  Compiled as one program, XLA's CPU
backend contracts multiply-adds in the vertex and setup math, so its clip
coordinates round differently from any op-by-op float32 evaluation, and
on this scene's floor — whose PCF compare sits within a 16-bit depth
quantum of the floor's own shadow-map depth (shadow acne) — those ulps
flip about 1% of the PCF taps.  Op by op, both frames round alike.
"""

import functools
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.io import native as ref_native
from kanirenderer_tpu.models import procedural as ref_procedural
from kanirenderer_tpu.ops import raster_xla
from kanirenderer_tpu.passes import frame as ref_frame

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch import flythrough
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import raster_cuda
from kanirenderer_tpu_torch.passes.frame import render_frame

W, H, D = 256, 192, 256

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


def _compiled(fn):
    @functools.wraps(fn)
    def call(*args, **kw):
        with jax.disable_jit(False):
            return fn(*args, **kw)
    return call


MODES = {
    "unlit": dict(mode="UNLIT"),
    "lit": dict(mode="LIT"),
    "wireframe": dict(mode="WIREFRAME"),
    "hdr": dict(hdr=True),
    "present_scale2": dict(present_scale=2),
    "debug_depth": dict(mode="DEBUG", debug_texture="SCENE_DEPTH"),
    "debug_shadow": dict(mode="DEBUG", debug_texture="SHADOW_MAP"),
    "deferred": dict(deferred=True),
}


def config(pkg, **kw):
    """``pkg.RenderConfig`` of the small frame with ``kw`` (enum members by
    name, so one dict serves both packages)."""
    enums = {"mode": pkg.RenderMode, "debug_texture": pkg.DebugTexture}
    kw = {k: enums[k][v] if k in enums else v for k, v in kw.items()}
    extra = dict(raster_backend="xla") if pkg is kani else {}
    return pkg.RenderConfig(width=W, height=H, shadow_dim=D, output_u8=True,
                            **extra, **kw)


def render_both(scenes, monkeypatch, **kw):
    """(reference frame run op by op, the port's frame) at the courtyard
    pose, in the configuration ``kw``."""
    ref_scene, scene = scenes
    cam = kani.CameraState(position=jnp.array([-900.0, 180.0, 0.0]),
                           yaw=jnp.float32(0.0),
                           pitch=jnp.float32(np.deg2rad(-5.0)))
    state = kani.frame_state(ref_scene, cam, kani.default_lights())
    monkeypatch.setattr(ref_frame, "raster_xla", types.SimpleNamespace(
        rasterize_xla=_compiled(raster_xla.rasterize_xla),
        rasterize_depth_xla=_compiled(raster_xla.rasterize_depth_xla)))
    with jax.disable_jit():
        ref = ref_frame.render_frame(ref_scene, state, config(kani, **kw))
    out = render_frame(scene, port.from_reference(state, device="cpu"),
                       config(port, **kw))
    return ref, out


def assert_images_close(img, ref_img):
    """The golden criterion; float16 (HDR) surfaces at 255× their values."""
    assert img.shape == ref_img.shape and img.dtype == ref_img.dtype
    scale = 255.0 if img.dtype == np.float16 else 1.0
    diff = np.abs(img.astype(np.float64) - ref_img.astype(np.float64)) \
        * scale
    assert img.astype(np.float64).std() * scale > 10.0
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
    assert diff.mean() < 1.5, diff.mean()


def check_mode(scenes, monkeypatch, name):
    ref, out = render_both(scenes, monkeypatch, **MODES[name])
    p = MODES[name].get("present_scale", 1)
    assert out.image.shape == (H // p, W // p, 3)
    assert_images_close(out.image.numpy(), np.asarray(ref.image))
    np.testing.assert_allclose(out.shadow.numpy(), np.asarray(ref.shadow),
                               rtol=0, atol=1e-6)
    # depth: the K2 bounds (winners differ on ≤ 0.2% of pixels, depth
    # within 1e-6 elsewhere; the oracle sums its plane in another order)
    close = np.abs(out.depth.numpy() - np.asarray(ref.depth)) <= 1e-6
    assert close.mean() >= 0.998
    assert int(out.raster_overflow) == 0


@pytest.fixture(scope="module")
def scenes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_native, "compute_tbn", lambda *a: None)
        mp.setattr(ref_native, "morton_order", lambda *a: None)
        ref = ref_procedural.sponza_standin_scene(
            target_tris=6000, num_materials=4, tex_size=32)
    return ref, port.from_reference(ref, device="cpu")


def test_frame_matches_reference(scenes, monkeypatch):
    ref_scene, scene = scenes
    cam = kani.CameraState(position=jnp.array([-900.0, 180.0, 0.0]),
                           yaw=jnp.float32(0.0),
                           pitch=jnp.float32(np.deg2rad(-5.0)))
    state = kani.frame_state(ref_scene, cam, kani.default_lights())
    cfg = kani.RenderConfig(width=W, height=H, shadow_dim=D,
                            mode=kani.RenderMode.LIT_SHADOW,
                            raster_backend="xla", output_u8=True)
    monkeypatch.setattr(ref_frame, "raster_xla", types.SimpleNamespace(
        rasterize_xla=_compiled(raster_xla.rasterize_xla),
        rasterize_depth_xla=_compiled(raster_xla.rasterize_depth_xla)))
    with jax.disable_jit():
        ref = ref_frame.render_frame(ref_scene, state, cfg)
    ref_img = np.asarray(ref.image)

    out = render_frame(scene, port.from_reference(state, device="cpu"),
                       port.RenderConfig(width=W, height=H, shadow_dim=D,
                                         output_u8=True))
    img = out.image.numpy()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert img.std() > 10.0
    diff = np.abs(img.astype(np.int32) - ref_img.astype(np.int32))
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
    assert diff.mean() < 1.5, diff.mean()
    np.testing.assert_allclose(out.shadow.numpy(), np.asarray(ref.shadow),
                               rtol=0, atol=1e-6)
    assert int(out.raster_overflow) == 0


def test_flythrough_runs_the_bench_path():
    """A few frames of the bench camera path at a small size: the poses
    follow the reference's host controller, frames are finite and lit."""
    cams = flythrough.camera_path(3)
    assert np.allclose(cams[0].position, [-995.0, 180.0, 0.0])
    np.testing.assert_allclose(cams[-1].yaw, 3 * 6.0 * 0.4 / 60.0, rtol=1e-6)
    scene = sponza_standin_scene(target_tris=3000, num_materials=2,
                                 tex_size=16, device="cpu")
    cfg = port.RenderConfig(width=96, height=64, shadow_dim=64,
                            output_u8=True)
    before = dict(raster_cuda.launch_counts)
    frames = list(flythrough.fly(scene, cfg, cams))
    assert len(frames) == 3
    out, ms = frames[-1]
    assert out.image.shape == (64, 96, 3) and out.image.dtype == torch.uint8
    assert out.image.float().std() > 1.0 and ms > 0
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert raster_cuda.launch_counts == before


@pytest.mark.parametrize("name", ["unlit", "lit", "wireframe", "hdr",
                                  "present_scale2"])
def test_mode_matches_reference(scenes, monkeypatch, name):
    check_mode(scenes, monkeypatch, name)
