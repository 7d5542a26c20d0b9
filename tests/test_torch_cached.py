"""What the interactive loop feeds ``render_frame``: the vertex-major
geometry path, the standalone shadow pass and the frame's cached-shadow and
resize arguments, against the JAX package and against the port's own fresh
frame.

Tolerances.  Vertex-major stage, setup and records against JAX run op by
op: those of tests/test_torch_vertex.py (clip exact, setup rows within 1e-6
of each row's largest coefficient, bboxes and clip-free flags exact, lanes
within 1e-6 relative).  Inside the port the vertex-major and the
corner-major path evaluate the same expressions, so their setup rows, the
standalone shadow map and every frame that is handed a cached map, table
or light-space setup must equal the fresh frame exactly (``torch.equal``).
Against the JAX ``render_shadow_map``, which transforms vertices with an
einsum and a matrix product where the port (as its own fresh frame) uses
plane arithmetic, the setup rows differ in the last bits: depth within
1e-6 on at least 99.5% of the texels (the rest are texels on a triangle's
edge that one side covers and the other does not).  Whole frames against
the JAX frame run op by op: the golden criterion.
"""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.models import procedural as ref_procedural
from kanirenderer_tpu.ops import interpolate as ref_interp
from kanirenderer_tpu.ops import raster_xla as ref_raster
from kanirenderer_tpu.ops import sampling as ref_sampling
from kanirenderer_tpu.ops import vertex as ref_vertex
from kanirenderer_tpu.passes import frame as ref_frame

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.models.procedural import cube_scene
from kanirenderer_tpu_torch.ops import interpolate, raster_xla, vertex
from kanirenderer_tpu_torch.ops.sampling import build_shadow_table
from kanirenderer_tpu_torch.passes.frame import (frame_geometry,
                                                 render_frame,
                                                 render_shadow_geometry,
                                                 render_shadow_map)

from test_torch_frame import (_compiled, assert_images_close, config,  # noqa: F401
                              scenes)
from test_torch_vertex import (POSES, _assert_lanes, _assert_setup,
                               ref_camera, ref_matrices, t)

W, H, D = 256, 192, 256

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


def without_corner_planes(scene):
    """The scene as a hand-built one: no corner planes, no static material
    lanes, so the frame takes the vertex-major path."""
    e = scene.corner_pos[:0, :0]
    return scene._replace(corner_pos=e, corner_uv=e, corner_normal=e,
                          corner_tangent=e, corner_bitangent=e,
                          tri_extra=scene.tri_extra[:0])


def port_state(scene, pose="courtyard"):
    pos, yaw, pitch = POSES[pose]
    cam = port.camera_state(pos, np.deg2rad(np.float32(yaw)),
                            np.deg2rad(np.float32(pitch)), "cpu")
    return port.frame_state(scene, cam, port.default_lights(device="cpu"))


@pytest.mark.parametrize("pose", POSES.keys())
def test_vertex_major_stage_setup_and_records(scenes, pose):  # noqa: F811
    ref, ours = scenes
    cam, lights = ref_camera(POSES[pose]), kani.default_lights()
    vp, lvp = ref_matrices(cam, lights)
    rv = ref_vertex.run_vertex_stage(ref, ref.object_model,
                                     ref.object_normal, vp, cam.position,
                                     lights, lvp)
    ov = vertex.run_vertex_stage(ours, ours.object_model, ours.object_normal,
                                 t(vp), t(lvp))
    np.testing.assert_array_equal(np.asarray(rv.clip), ov.clip.numpy())
    np.testing.assert_array_equal(np.asarray(rv.light_clip),
                                  ov.light_clip.numpy())
    _assert_lanes(np.asarray(rv.varyings)[:, :vertex.USED],
                  ov.varyings.numpy())
    np.testing.assert_array_equal(np.asarray(rv.varyings)[:, vertex.USED:],
                                  0.0)

    rst = ref_vertex.triangle_setup(rv.clip, ref.tri_idx, ref.tri_valid, W,
                                    H, True)
    ost, planes = vertex.triangle_setup(ov.clip, ours.tri_idx,
                                        ours.tri_valid, W, H, True)
    _assert_setup(rst, ost)
    assert torch.equal(planes.T, ost.setup)
    rsh = ref_vertex.triangle_setup(rv.light_clip, ref.tri_idx,
                                    ref.tri_valid, D, D, False, 2.0, 2.0)
    osh, _ = vertex.triangle_setup(ov.light_clip, ours.tri_idx,
                                   ours.tri_valid, D, D, False, 2.0, 2.0)
    _assert_setup(rsh, osh)

    args = (ours.tri_idx, ours.tri_mat, ov.varyings, ours.mat_blk_base,
            ours.mat_blk_w, ours.mat_tex_size)
    rargs = (ref.tri_idx, ref.tri_mat, rv.varyings, ref.mat_blk_base,
             ref.mat_blk_w, ref.mat_tex_size)
    for extra, rextra in ((ours.tri_extra, ref.tri_extra), (None, None)):
        fat = interpolate.build_tri_records(*args, setup=ost.setup,
                                            extra=extra)
        rfat = np.asarray(ref_interp.build_tri_records(
            *rargs, setup=rst.setup, extra=rextra))
        assert fat.shape[1] == interpolate.FAT_LANES
        _assert_lanes(rfat[:, :interpolate.FAT_LANES], fat.numpy())
    thin = interpolate.build_tri_records(*args)
    _assert_lanes(np.asarray(ref_interp.build_tri_records(*rargs)),
                  thin.numpy())


@pytest.mark.parametrize("pose", POSES.keys())
def test_vertex_major_equals_corner_major(scenes, pose):  # noqa: F811
    """One scene through both paths of the port: the same setup rows,
    bboxes, bins and records, bit for bit."""
    _, scene = scenes
    cfg = port.RenderConfig(width=W, height=H, shadow_dim=D)
    gc = frame_geometry(scene, port_state(scene, pose), cfg)
    bare = without_corner_planes(scene)
    gv = frame_geometry(bare, port_state(bare, pose), cfg)
    assert isinstance(gv.vout, vertex.VertexOutputs)
    assert isinstance(gc.vout, vertex.CornerOutputs)
    for a, b in ((gc.setup, gv.setup), (gc.shadow_setup, gv.shadow_setup)):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(gc.records, gv.records)
    assert torch.equal(gc.bins.chunk, gv.bins.chunk)
    assert torch.equal(gc.shadow_bins.pair_tile, gv.shadow_bins.pair_tile)


def test_interpolate_matches_reference(scenes):  # noqa: F811
    """The gather-based interpolate on one visibility buffer: varyings
    within 1e-6 relative per plane, the integer planes equal."""
    ref, ours = scenes
    w, h = 64, 48
    cfg = port.RenderConfig(width=w, height=h)
    g = frame_geometry(without_corner_planes(ours), port_state(ours), cfg)
    vis = raster_xla.rasterize_xla(g.setup.setup, w, h)
    assert (vis.tri >= 0).float().mean() > 0.5
    out = interpolate.interpolate(
        vis, ours.tri_idx, ours.tri_mat, g.vout.varyings, ours.mat_blk_base,
        ours.mat_blk_w, ours.mat_tex_size)
    rvis = ref_raster.VisBuffer(tri=jnp.asarray(vis.tri.numpy()),
                                z=jnp.asarray(vis.z.numpy()),
                                bary=jnp.asarray(vis.bary.numpy()))
    rout = ref_interp.interpolate(
        rvis, ref.tri_idx, ref.tri_mat,
        jnp.asarray(g.vout.varyings.numpy()), ref.mat_blk_base,
        ref.mat_blk_w, ref.mat_tex_size)
    _assert_lanes(np.asarray(rout.varyings).reshape(vertex.USED, -1).T,
                  out.varyings.numpy().reshape(vertex.USED, -1).T)
    for f in ("mat_id", "tex_w", "tex_h", "blk_base", "blk_w", "mask", "z"):
        np.testing.assert_array_equal(np.asarray(getattr(rout, f)),
                                      getattr(out, f).numpy(), err_msg=f)


@pytest.mark.parametrize("corners", [True, False],
                         ids=["corner_major", "vertex_major"])
def test_render_shadow_map_equals_fresh_and_reference(scenes, monkeypatch,  # noqa: F811
                                                      corners):
    ref_scene, scene = scenes
    if not corners:
        scene = without_corner_planes(scene)
    cfg = port.RenderConfig(width=64, height=48, shadow_dim=128)
    state = port_state(scene)
    smap = render_shadow_map(scene, state, cfg)
    fresh = render_frame(scene, state, cfg)
    assert torch.equal(smap, fresh.shadow)
    assert 0.05 < (smap < 1.0).float().mean() < 1.0

    if corners:
        rcfg = kani.RenderConfig(width=64, height=48, shadow_dim=128,
                                 raster_backend="xla")
        rstate = kani.frame_state(ref_scene, ref_camera(POSES["courtyard"]),
                                  kani.default_lights())
        monkeypatch.setattr(ref_frame, "raster_xla", types.SimpleNamespace(
            rasterize_depth_xla=_compiled(ref_raster.rasterize_depth_xla)))
        with jax.disable_jit():
            rmap = np.asarray(ref_frame.render_shadow_map(ref_scene, rstate,
                                                          rcfg))
        close = np.abs(rmap - smap.numpy()) <= 1e-6
        print(f"shadow map texels within 1e-6 of the reference: "
              f"{close.mean():.5f}")
        assert close.mean() >= 0.995


ARGS = ["shadow_table", "shadow_map", "use_cached", "use_fresh",
        "shadow_geom", "cache_config"]


# The deferred shader takes the map and never a table, as in the JAX loop.
@pytest.mark.parametrize("arg,deferred", [
    (a, d) for d in (False, True) for a in ARGS
    if not (d and a == "shadow_table")])
def test_cached_shadow_arguments_equal_the_fresh_frame(scenes, arg,  # noqa: F811
                                                       deferred):
    """A frame handed the cached map, its table or the light-space setup
    equals the frame that builds them itself, and emits the shadow output
    the JAX frame emits: (1, 1) zeros for an external map or table, (D, D)
    zeros when use_cached_shadow reused the caller's, else the map."""
    _, scene = scenes
    cfg = port.RenderConfig(width=96, height=64, shadow_dim=128,
                            output_u8=True, deferred=deferred,
                            cache_shadow_map=arg == "cache_config")
    state = port_state(scene)
    fresh = render_frame(scene, state, cfg.with_(cache_shadow_map=False))
    smap = render_shadow_map(scene, state, cfg)
    kw, shadow = {
        "shadow_table": (dict(shadow_table=build_shadow_table(smap)),
                         torch.zeros(1, 1)),
        "shadow_map": (dict(shadow_map=smap), torch.zeros(1, 1)),
        "use_cached": (dict(shadow_map=smap, use_cached_shadow=True),
                       torch.zeros(128, 128)),
        "use_fresh": (dict(shadow_map=torch.ones_like(smap),
                           use_cached_shadow=False), smap),
        "shadow_geom": (dict(shadow_geom=render_shadow_geometry(
            scene, state, cfg)), smap),
        "cache_config": ({}, smap),
    }[arg]
    out = render_frame(scene, state, cfg, **kw)
    assert torch.equal(out.image, fresh.image)
    assert torch.equal(out.depth, fresh.depth)
    assert torch.equal(out.shadow, shadow)
    assert out.image.float().std() > 10.0


def test_cached_shadow_argument_errors(scenes):  # noqa: F811
    _, scene = scenes
    cfg = port.RenderConfig(width=32, height=32, shadow_dim=64)
    state = port_state(scene)
    table = build_shadow_table(torch.ones(64, 64))
    with pytest.raises(ValueError):
        render_frame(scene, state, cfg.with_(mode=port.RenderMode.DEBUG),
                     shadow_table=table)
    with pytest.raises(ValueError):
        render_frame(scene, state, cfg, shadow_table=table,
                     shadow_map=torch.ones(64, 64))
    with pytest.raises(ValueError):
        render_frame(scene, state, cfg, use_cached_shadow=True)
    with pytest.raises(ValueError):
        render_frame(scene, state, cfg.with_(present_scale=0))


def test_vertex_major_frame_equals_corner_major_frame(scenes):  # noqa: F811
    _, scene = scenes
    cfg = port.RenderConfig(width=96, height=64, shadow_dim=128,
                            output_u8=True)
    a = render_frame(scene, port_state(scene), cfg)
    bare = without_corner_planes(scene)
    b = render_frame(bare, port_state(bare), cfg)
    assert torch.equal(a.image, b.image) and torch.equal(a.shadow, b.shadow)


@pytest.mark.parametrize("case", ["shadow_table", "view_wh"])
def test_frame_arguments_match_reference(scenes, monkeypatch, case):  # noqa: F811
    """``shadow_table=`` and ``view_wh=`` frames against the JAX
    render_frame given the same arguments (its own table from its own
    shadow pass), run op by op: the golden criterion."""
    ref_scene, scene = scenes
    rstate = kani.frame_state(ref_scene, ref_camera(POSES["courtyard"]),
                              kani.default_lights())
    state = port.from_reference(rstate, device="cpu")
    monkeypatch.setattr(ref_frame, "raster_xla", types.SimpleNamespace(
        rasterize_xla=_compiled(ref_raster.rasterize_xla),
        rasterize_depth_xla=_compiled(ref_raster.rasterize_depth_xla)))
    if case == "shadow_table":
        kw = dict()
        rcfg, cfg = config(kani, **kw), config(port, **kw)
        with jax.disable_jit():
            rtable = ref_sampling.build_shadow_table(
                ref_frame.render_shadow_map(ref_scene, rstate, rcfg))
            ref = ref_frame.render_frame(ref_scene, rstate, rcfg,
                                         shadow_table=rtable)
        table = build_shadow_table(render_shadow_map(scene, state, cfg))
        # the table itself: u16 depth quanta, equal but for edge texels
        same = (np.asarray(rtable)[:, :121] == table.numpy()[:, :121])
        assert same.mean() >= 0.99
        out = render_frame(scene, state, cfg, shadow_table=table)
        view = (W, H)
    else:
        kw = dict(mode="LIT")
        rcfg, cfg = config(kani, **kw), config(port, **kw)
        view = (200, 150)
        with jax.disable_jit():
            ref = ref_frame.render_frame(
                ref_scene, rstate, rcfg,
                view_wh=jnp.asarray(view, jnp.float32))
        out = render_frame(scene, state, cfg, view_wh=view)
    assert out.shadow.shape == np.asarray(ref.shadow).shape
    assert out.image.shape == (H, W, 3)
    assert_images_close(out.image.numpy()[:view[1], :view[0]],
                        np.asarray(ref.image)[:view[1], :view[0]])


def test_view_wh_matches_exact_size():
    """Rendering into a padded target with the view size given, then
    cropping, equals rendering at the exact size (the JAX package pins the
    same at 2e-6 on the float image)."""
    scene = cube_scene(device="cpu")
    state = port.frame_state(scene, port.default_camera(device="cpu"),
                             port.default_lights(device="cpu"))
    exact = port.RenderConfig(width=100, height=70, shadow_dim=64,
                              mode=port.RenderMode.LIT)
    out_e = render_frame(scene, state, exact)
    out_p = render_frame(scene, state, exact.with_(width=256, height=128),
                         view_wh=(100, 70))
    assert out_e.image.std() > 0.05
    np.testing.assert_allclose(out_p.image.numpy()[:70, :100],
                               out_e.image.numpy(), rtol=0, atol=2e-6)
