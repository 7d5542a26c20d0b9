"""The port's whole LIT_SHADOW frame against the JAX package's render_frame.

Criterion: the golden one of tests/test_golden.py:65-68 on the u8 image —
under 1% of values more than 8 levels off and a mean difference under 1.5
levels.

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


def _compiled(fn):
    @functools.wraps(fn)
    def call(*args, **kw):
        with jax.disable_jit(False):
            return fn(*args, **kw)
    return call


@pytest.fixture(scope="module")
def scenes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_native, "compute_tbn", lambda *a: None)
        mp.setattr(ref_native, "morton_order", lambda *a: None)
        ref = ref_procedural.sponza_standin_scene(
            target_tris=6000, num_materials=4, tex_size=32)
    return ref, port.from_reference(ref)


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

    out = render_frame(scene, port.from_reference(state), port.RenderConfig(
        width=W, height=H, shadow_dim=D, output_u8=True))
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
                                 tex_size=16)
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


@pytest.mark.parametrize("kw", [dict(mode=port.RenderMode.LIT),
                                dict(hdr=True), dict(deferred=True)])
def test_unported_modes_raise(kw):
    scene = sponza_standin_scene(target_tris=300, num_materials=1,
                                 tex_size=8)
    state = port.frame_state(scene, port.default_camera(),
                             port.default_lights())
    with pytest.raises(NotImplementedError):
        render_frame(scene, state, port.RenderConfig(width=32, height=32,
                                                     shadow_dim=32, **kw))
