"""PCF table, samplers and shade_lit of the port against the JAX package,
on a fixed PixelBuffer and shadow map (the port's plain rasters at the
courtyard pose, handed to both sides).

Tolerances: the PCF table is exact (same quantization, same windows); the
samplers and the shaded colour agree within 1e-6 absolute on values of
order one — the port sums the same per-lane terms with a reduction where
the reference uses a selector matmul, so only the summation order differs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.core import color as ref_color
from kanirenderer_tpu.ops import interpolate as ref_interp
from kanirenderer_tpu.ops import sampling as ref_sampling
from kanirenderer_tpu.shade import forward as ref_forward

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.core import color
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops import sampling
from kanirenderer_tpu_torch.passes.frame import frame_geometry
from kanirenderer_tpu_torch.shade import forward

W, H, D = 256, 192, 256


@pytest.fixture(scope="module")
def frame():
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32)
    lights = port.default_lights(2)
    lights = lights._replace(points=port.PointLights(   # a live loop light
        position=torch.tensor([[99999.0, 999999.0, 99999.0],
                               [-700.0, 60.0, 30.0]]),
        color=torch.tensor([[0.0, 0.0, 0.0], [10.0, 2.0, 0.0]]),
        range=torch.tensor([0.0, 256.0])))
    state = port.frame_state(scene, port.camera_state(
        [-900.0, 180.0, 0.0], 0.0, np.deg2rad(-5.0)), lights)
    g = frame_geometry(scene, state,
                       port.RenderConfig(width=W, height=H, shadow_dim=D))
    pix = rc.rasterize_pixels(g.records, g.setup.bbox, g.bins, W, H)
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
