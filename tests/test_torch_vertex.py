"""Uniform matrices, corner vertex stage, triangle setup and triangle
records of the port against the JAX package.

Both sides run float32 op by op (the reference eagerly, no jit fusion) on
the same scene and the same matrices.  Tolerances: setup rows within 1e-6
of each row's largest coefficient, depth bounds within 1e-6, bboxes and
clip-free flags exact; varyings and records within 1e-6 relative to each
lane's magnitude (the reference's XLA rsqrt may round the normalized TBN
rows one ulp differently).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.core import math3d as ref_math
from kanirenderer_tpu.io import native as ref_native
from kanirenderer_tpu.models import procedural as ref_procedural
from kanirenderer_tpu.ops import interpolate as ref_interp
from kanirenderer_tpu.ops import vertex as ref_vertex

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.core import math3d
from kanirenderer_tpu_torch.ops import interpolate, vertex

W, H, D = 256, 192, 256

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


POSES = {
    "courtyard": ([-900.0, 180.0, 0.0], 0.0, -5.0),
    "near_floor": ([0.0, 3.0, 0.0], 0.0, -10.0),   # near-plane crossers
}


@pytest.fixture(scope="module")
def scenes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_native, "compute_tbn", lambda *a: None)
        mp.setattr(ref_native, "morton_order", lambda *a: None)
        ref = ref_procedural.sponza_standin_scene(
            target_tris=6000, num_materials=4, tex_size=32)
    return ref, port.from_reference(ref, device="cpu")


def ref_camera(pose):
    pos, yaw, pitch = pose
    return kani.CameraState(position=jnp.array(pos, jnp.float32),
                            yaw=jnp.float32(np.deg2rad(yaw)),
                            pitch=jnp.float32(np.deg2rad(pitch)))


def ref_matrices(cam, lights):
    proj = ref_math.perspective(jnp.deg2rad(45.0), W / H, 0.1, 10000.0)
    vp = proj @ ref_math.camera_view_matrix(cam.position, cam.yaw, cam.pitch)
    d = lights.directional
    lvp = ref_math.directional_light_view_projection(
        d.direction, d.distance, d.shadow_scene_size)
    return vp, lvp


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("pose", POSES.values(), ids=POSES.keys())
def test_uniform_matrices(pose):
    cam, lights = ref_camera(pose), kani.default_lights()
    vp, lvp = ref_matrices(cam, lights)
    c = port.from_reference(cam, device="cpu")
    lt = port.from_reference(lights, device="cpu")
    proj = math3d.perspective(torch.deg2rad(torch.tensor(45.0)), W / H,
                              0.1, 10000.0)
    ours = proj @ math3d.camera_view_matrix(c.position, c.yaw, c.pitch)
    d = lt.directional
    ours_l = math3d.directional_light_view_projection(
        d.direction, d.distance, d.shadow_scene_size)
    np.testing.assert_allclose(ours.numpy(), np.asarray(vp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ours_l.numpy(), np.asarray(lvp), rtol=1e-6,
                               atol=1e-8)


def _assert_setup(ref_st, st):
    a, b = np.asarray(ref_st.setup), st.setup.numpy()
    scale = np.abs(a).max(axis=1, keepdims=True) + 1e-30
    assert (np.abs(a - b) <= 1e-6 * scale).all()
    np.testing.assert_array_equal(np.asarray(ref_st.bbox), st.bbox.numpy())
    np.testing.assert_array_equal(np.asarray(ref_st.clipfree),
                                  st.clipfree.numpy())
    np.testing.assert_allclose(np.asarray(ref_st.zmin), st.zmin.numpy(),
                               rtol=0, atol=1e-6)


def _assert_lanes(a, b):
    scale = np.maximum(np.abs(a).max(axis=0, keepdims=True), 1.0)
    assert (np.abs(a - b) <= 1e-6 * scale).all()


@pytest.mark.parametrize("pose", POSES.values(), ids=POSES.keys())
def test_vertex_setup_and_records(scenes, pose):
    ref, ours = scenes
    cam, lights = ref_camera(pose), kani.default_lights()
    vp, lvp = ref_matrices(cam, lights)
    rv = ref_vertex.run_vertex_stage_corners(
        ref, ref.object_model, ref.object_normal, vp, cam.position, lights,
        lvp)
    ov = vertex.run_vertex_stage_corners(ours, ours.object_model,
                                         ours.object_normal, t(vp), t(lvp))
    np.testing.assert_array_equal(
        np.stack([np.stack(c) for c in rv.clip]), ov.clip.numpy())
    np.testing.assert_array_equal(
        np.stack([np.stack(c) for c in rv.light_clip]),
        ov.light_clip.numpy())
    rvar = np.stack([np.stack(c) for c in rv.varyings])      # (3, 17, T)
    _assert_lanes(rvar.transpose(2, 0, 1).reshape(-1, 51),
                  ov.varyings.numpy().transpose(2, 0, 1).reshape(-1, 51))

    # camera setup (back faces culled) and records
    rst, rplanes = ref_vertex.triangle_setup_corners(
        rv.clip, ref.tri_valid, W, H, True)
    ost, oplanes = vertex.triangle_setup_corners(ov.clip, ours.tri_valid, W,
                                                 H, True)
    _assert_setup(rst, ost)
    assert ost.setup[:, 15].sum() > 100         # the pose sees geometry
    if pose is POSES["near_floor"]:
        assert (~ost.clipfree).any()            # ... and crosses w = 0
    rrec = np.asarray(ref_interp.build_tri_records_corners(
        rv.varyings, rplanes, ref.tri_extra))
    orec = interpolate.build_tri_records_corners(ov.varyings, oplanes,
                                                 ours.tri_extra)
    assert orec.shape == (ref.tri_idx.shape[0], interpolate.FAT_LANES)
    np.testing.assert_array_equal(rrec[:, interpolate.FAT_LANES:], 0.0)
    _assert_lanes(rrec[:, :interpolate.FAT_LANES], orec.numpy())

    # light-space setup: no culling, the shadow pipeline's depth bias
    rsh, _ = ref_vertex.triangle_setup_corners(
        rv.light_clip, ref.tri_valid, D, D, False, 2.0, 2.0)
    osh, _ = vertex.triangle_setup_corners(ov.light_clip, ours.tri_valid, D,
                                           D, False, 2.0, 2.0)
    _assert_setup(rsh, osh)


def test_transform_helpers_match_reference():
    """Quaternion, instance and point transforms, within 1e-6 relative."""
    rng = np.random.RandomState(3)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    p = rng.uniform(-50, 50, (5, 3)).astype(np.float32)
    pts = rng.uniform(-500, 500, (7, 3)).astype(np.float32)
    np.testing.assert_allclose(math3d.quat_to_mat3(t(q)).numpy(),
                               np.asarray(ref_math.quat_to_mat3(q)),
                               rtol=1e-6, atol=1e-6)
    m = math3d.instance_to_model_matrix(t(p), t(q))
    ref_m = np.asarray(ref_math.instance_to_model_matrix(p, q))
    np.testing.assert_allclose(m.numpy(), ref_m, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        math3d.transform_points_h(m[1], t(pts)).numpy(),
        np.asarray(ref_math.transform_points_h(ref_m[1], pts)),
        rtol=1e-6, atol=1e-3)
