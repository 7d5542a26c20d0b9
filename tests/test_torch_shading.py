"""PCF table, samplers, the shaders of every mode, the deferred G-buffer
and lighting, and the DEBUG overlays of the port against the JAX package,
on a fixed PixelBuffer and shadow map (the port's plain rasters at the
courtyard pose, handed to both sides).

Tolerances: the PCF table is exact (same quantization, same windows); the
samplers and the shaded colour agree within 1e-6 absolute on values of
order one — the port sums the same per-lane terms with a reduction where
the reference uses a selector matmul, so only the summation order differs.
The G-buffer's bf16 planes and 8-bit albedo round values that agree within
that bound, so they are equal except where a value sits on a rounding
boundary: at most 0.1% of values, each within one step of its format.
The overlays are exact: the same elementwise float32 operations in the
same order on both sides.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.core import color as ref_color
from kanirenderer_tpu.ops import interpolate as ref_interp
from kanirenderer_tpu.ops import sampling as ref_sampling
from kanirenderer_tpu.passes import frame as ref_frame
from kanirenderer_tpu.passes import overlay as ref_overlay
from kanirenderer_tpu.shade import deferred as ref_deferred
from kanirenderer_tpu.shade import forward as ref_forward

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.core import color
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops import sampling
from kanirenderer_tpu_torch.passes import overlay
from kanirenderer_tpu_torch.passes.frame import (frame_geometry,
                                                 linearize_depth)
from kanirenderer_tpu_torch.shade import deferred, forward

W, H, D = 256, 192, 256

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frame():
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32, device="cpu")
    lights = port.default_lights(2, device="cpu")
    lights = lights._replace(points=port.PointLights(   # a live loop light
        position=torch.tensor([[99999.0, 999999.0, 99999.0],
                               [-700.0, 60.0, 30.0]]),
        color=torch.tensor([[0.0, 0.0, 0.0], [10.0, 2.0, 0.0]]),
        range=torch.tensor([0.0, 256.0])))
    state = port.frame_state(scene, port.camera_state(
        [-900.0, 180.0, 0.0], 0.0, np.deg2rad(-5.0), "cpu"), lights)
    g = frame_geometry(scene, state,
                       port.RenderConfig(width=W, height=H, shadow_dim=D))
    pix = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox,
                              g.bins, W, H)
    st = g.shadow_setup
    smap = rc.rasterize_depth(st.setup, st.bbox, g.shadow_bins, D)
    return scene, state, g, pix, smap


def ref_pixels(pix):
    return ref_interp.PixelBuffer(*(jnp.asarray(getattr(pix, f).numpy())
                                    for f in ref_interp.PixelBuffer._fields
                                    if f != "overflow"))


def ref_lights(lights):
    return kani.Lights(*(type(ref_part)(*(jnp.asarray(x.numpy())
                                          for x in part))
                         for ref_part, part in zip(kani.default_lights(),
                                                   lights)))


def test_shadow_table_matches_reference(frame):
    *_, smap = frame
    ref = np.asarray(ref_sampling.build_shadow_table(
        jnp.asarray(smap.numpy())))
    ours = sampling.build_shadow_table(smap)
    assert ours.shape == ref.shape == ((D // 8) ** 2, 128)
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.float32))


def test_samplers_match_reference(frame):
    scene, state, g, pix, smap = frame
    rp = ref_pixels(pix)
    rd, rn = ref_sampling.sample_materials_combined(
        jnp.asarray(scene.tex_combined.numpy()), rp.blk_base, rp.blk_w,
        rp.tex_w, rp.tex_h, rp.varyings[15], rp.varyings[16])
    od, on = sampling.sample_materials_combined(
        scene.tex_combined, pix.blk_base, pix.blk_w, pix.tex_w, pix.tex_h,
        pix.varyings[15], pix.varyings[16])
    np.testing.assert_allclose(od.numpy(), np.asarray(rd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(on.numpy(), np.asarray(rn), rtol=0, atol=1e-6)

    lvp = jnp.asarray(g.light_vp.numpy())
    su, sv, sz = ref_forward.shadow_coords(rp.varyings, lvp)
    ref_tbl = ref_sampling.build_shadow_table(jnp.asarray(smap.numpy()))
    rpcf = np.asarray(ref_sampling.sample_shadow_pcf(ref_tbl, D, su, sv, sz))
    osu, osv, osz = forward.shadow_coords(pix.varyings, g.light_vp)
    opcf = sampling.sample_shadow_pcf(sampling.build_shadow_table(smap), D,
                                      osu, osv, osz).numpy()
    assert 0.05 < (rpcf > 0.5).mean() < 0.95    # lit and shadowed pixels
    np.testing.assert_allclose(opcf, rpcf, rtol=0, atol=1e-6)


def test_shade_lit_matches_reference(frame):
    scene, state, g, pix, smap = frame
    ref_scene = kani.Scene(*[jnp.asarray(getattr(scene, f).numpy())
                             for f in kani.Scene._fields])
    lvp = jnp.asarray(g.light_vp.numpy())
    ref = np.asarray(ref_forward.shade_lit(
        ref_scene, ref_pixels(pix), ref_lights(state.lights),
        ref_sampling.build_shadow_table(jnp.asarray(smap.numpy())), False, D,
        camera_pos=jnp.asarray(state.camera.position.numpy()),
        light_vp=lvp))
    ours = forward.shade_lit(scene, pix, state.lights,
                             sampling.build_shadow_table(smap), False, D,
                             camera_pos=state.camera.position,
                             light_vp=g.light_vp).numpy()
    m = pix.mask.numpy()
    assert ours.shape == (3, H, W) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours[:, m], ref[:, m], rtol=0, atol=1e-6)


def test_color_transfer_matches_reference():
    """sRGB both ways and both tonemaps, within 1e-6 on values in [0, 4]."""
    x = np.linspace(-0.1, 4.0, 4097, dtype=np.float32)
    for name in ("linear_to_srgb", "srgb_to_linear", "reinhard_tonemap",
                 "aces_tonemap"):
        np.testing.assert_allclose(
            getattr(color, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(ref_color, name)(x)), rtol=1e-6, atol=1e-6,
            err_msg=name)


def ref_scene_of(scene):
    return kani.Scene(*[jnp.asarray(getattr(scene, f).numpy())
                        for f in kani.Scene._fields])


@pytest.mark.parametrize("hdr", [False, True])
def test_shade_lit_without_shadow_matches_reference(frame, hdr):
    """The LIT mode (no shadow table), with Reinhard and with ACES."""
    scene, state, g, pix, smap = frame
    ref = np.asarray(ref_forward.shade_lit(
        ref_scene_of(scene), ref_pixels(pix), ref_lights(state.lights), None,
        hdr, camera_pos=jnp.asarray(state.camera.position.numpy())))
    ours = forward.shade_lit(scene, pix, state.lights, None, hdr,
                             camera_pos=state.camera.position).numpy()
    m = pix.mask.numpy()
    np.testing.assert_allclose(ours[:, m], ref[:, m], rtol=0, atol=1e-6)


def test_shade_lit_hdr_matches_reference(frame):
    scene, state, g, pix, smap = frame
    ref = np.asarray(ref_forward.shade_lit(
        ref_scene_of(scene), ref_pixels(pix), ref_lights(state.lights),
        ref_sampling.build_shadow_table(jnp.asarray(smap.numpy())), True, D,
        camera_pos=jnp.asarray(state.camera.position.numpy()),
        light_vp=jnp.asarray(g.light_vp.numpy())))
    ours = forward.shade_lit(scene, pix, state.lights,
                             sampling.build_shadow_table(smap), True, D,
                             camera_pos=state.camera.position,
                             light_vp=g.light_vp).numpy()
    m = pix.mask.numpy()
    np.testing.assert_allclose(ours[:, m], ref[:, m], rtol=0, atol=1e-6)


def test_shade_unlit_and_wireframe_match_reference(frame):
    scene, state, g, pix, smap = frame
    ref = np.asarray(ref_forward.shade_unlit(ref_scene_of(scene),
                                             ref_pixels(pix)))
    ours = forward.shade_unlit(scene, pix).numpy()
    m = pix.mask.numpy()
    np.testing.assert_allclose(ours[:, m], ref[:, m], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        forward.shade_wireframe(pix).numpy(),
        np.asarray(ref_forward.shade_wireframe(ref_pixels(pix))))


def _gbuffers(frame):
    scene, state, g, pix, smap = frame
    ref = ref_deferred.write_gbuffer(
        ref_scene_of(scene), ref_pixels(pix),
        jnp.asarray(state.camera.position.numpy()),
        jnp.asarray(g.light_vp.numpy()))
    ours = deferred.write_gbuffer(scene, pix, state.camera.position,
                                  g.light_vp)
    return ref, ours


def _rounded_alike(ours, ref, step):
    """Equal except on ≤ 0.1% of values, each within ``step``."""
    a = ours.to(torch.float32).numpy()
    b = np.asarray(ref.astype(jnp.float32))
    assert a.shape == b.shape
    assert (a != b).mean() <= 1e-3, (a != b).mean()
    print(f"{(a != b).sum()} of {a.size} values differ")
    assert (np.abs(a - b) <= step(b)).all()


def test_write_gbuffer_matches_reference(frame):
    ref, ours = _gbuffers(frame)
    m = ours.mask.numpy()
    assert m.mean() > 0.5 and ours.normal.dtype == torch.bfloat16 \
        and ours.view_dir.dtype == torch.bfloat16
    for f in ("normal", "view_dir"):
        # one bf16 step (2^-8 relative) of a float32 value that agrees
        # within 1e-6 (components of a unit vector near 0 cancel)
        _rounded_alike(getattr(ours, f)[:, m], getattr(ref, f)[:, m],
                       lambda b: np.abs(b) * 2.0 ** -7 + 1e-6)
    _rounded_alike(ours.albedo[:, m], ref.albedo[:, m],
                   lambda b: np.full_like(b, 1.0 / 255.0 + 1e-6))
    for f in ("position", "depth", "shadow_uv", "mask"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("shadow", [False, True])
def test_deferred_lighting_matches_reference(frame, shadow):
    """Both sides light the port's G-buffer (bf16 planes carried across
    unchanged), with the PCF table (LIT_SHADOW) and without (LIT), LDR and
    HDR."""
    scene, state, g, pix, smap = frame
    _, gbuf = _gbuffers(frame)
    ref_gbuf = ref_deferred.GBuffer(*(
        jnp.asarray(t.to(torch.float32).numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype)
        for t in gbuf))
    table = sampling.build_shadow_table(smap) if shadow else None
    ref_table = ref_sampling.build_shadow_table(
        jnp.asarray(smap.numpy())) if shadow else None
    m = gbuf.mask.numpy()
    for hdr in (False, True):
        ref = np.asarray(ref_deferred.deferred_lighting(
            ref_gbuf, ref_lights(state.lights), ref_table, hdr, D))
        ours = deferred.deferred_lighting(gbuf, state.lights, table, hdr,
                                          D).numpy()
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours[:, m], ref[:, m], rtol=0, atol=1e-6)


def test_gbuffer_debug_view_matches_reference(frame):
    ref, ours = _gbuffers(frame)
    for which in ("normal", "albedo", "position", "depth"):
        np.testing.assert_allclose(
            deferred.gbuffer_debug_view(ours, which).numpy(),
            np.asarray(ref_deferred.gbuffer_debug_view(ref, which)),
            rtol=0, atol=2.0 ** -7, err_msg=which)


@pytest.mark.parametrize("size", [(120, 160), (192, 256)])
def test_debug_texture_quad_matches_reference(size):
    """The depth quad over a random image, from a non-square depth texture
    and from a square map, as in DEBUG with either debug texture."""
    rng = np.random.RandomState(sum(size))
    image = rng.uniform(0, 1, size + (3,)).astype(np.float32)
    for tex in (rng.uniform(0, 1, size), rng.uniform(0, 1, (64, 64))):
        tex = tex.astype(np.float32)
        ref = np.asarray(ref_overlay.debug_texture_quad(
            jnp.asarray(image), jnp.asarray(tex), 0.1, 10000.0))
        ours = overlay.debug_texture_quad(torch.from_numpy(image),
                                          torch.from_numpy(tex), 0.1,
                                          10000.0).numpy()
        assert (ours != image).any()
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(
            linearize_depth(torch.from_numpy(tex), 0.1, 10000.0).numpy(),
            np.asarray(ref_frame.linearize_depth(jnp.asarray(tex), 0.1,
                                                 10000.0)))


@pytest.mark.parametrize("size", [(120, 160), (480, 640)])
def test_frame_time_graph_matches_reference(size):
    rng = np.random.RandomState(size[0])
    image = rng.uniform(0, 1, size + (3,)).astype(np.float32)
    times = rng.uniform(2.0, 14.0, 256).astype(np.float32)
    ref = np.asarray(ref_overlay.frame_time_graph(jnp.asarray(image),
                                                  jnp.asarray(times)))
    ours = overlay.frame_time_graph(torch.from_numpy(image),
                                    torch.from_numpy(times)).numpy()
    red = (ours == [1.0, 0.0, 0.0]).all(-1)
    assert red.sum() > 100
    np.testing.assert_array_equal(ours, ref)
