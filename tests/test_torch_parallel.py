"""Row-band rendering in the port (passes/frame.render_band,
parallel/mesh.py) against the port's own whole frame and against the JAX
package's band functions.

Tolerances.  Inside the port the bands reassemble to the whole frame
exactly (``torch.equal`` on image and depth): every plane is evaluated at
the global pixel centre, the PCF table's rows come out the same from a
band and its halo, and the overlays mask in global rows.  Against the JAX
package: ``build_shadow_table_band`` rows, ``deinterleave_rows`` and
``_band_geometry`` exactly; the band overlays within 1e-6; the plain band
rasters against the brute-force oracle's band rasters with the K2 bounds
of tests/test_torch_raster.py (coverage mask exact, winners equal on at
least 99.8% of pixels, depth within 1e-6 where they are), over the band
rows inside the frame (the oracle draws an interleaved band's padding
rows below the frame, the port leaves them empty); the port's own oracle
band rasters equal the reference's; the JAX frame on its 8-device virtual
CPU mesh against the port's banded frame by the golden criterion
(tests/test_golden.py:65-68).  Two gloo processes give the one-process
frames ``torch.equal``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.models.procedural import cube_scene as ref_cube_scene
from kanirenderer_tpu.ops import raster_xla as ref_raster
from kanirenderer_tpu.ops import sampling as ref_sampling
from kanirenderer_tpu.parallel import mesh as ref_mesh
from kanirenderer_tpu.passes import overlay as ref_overlay

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.core.types import DebugTexture, RenderMode
from kanirenderer_tpu_torch.models.procedural import (cube_scene,
                                                      sponza_standin_scene)
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops import raster_xla as port_raster
from kanirenderer_tpu_torch.ops.binning import bin_tiles, interleave_bins
from kanirenderer_tpu_torch.ops.sampling import (build_shadow_table,
                                                 build_shadow_table_band)
from kanirenderer_tpu_torch.parallel import mesh
from kanirenderer_tpu_torch.passes import overlay
from kanirenderer_tpu_torch.passes.frame import (frame_geometry,
                                                 render_band, render_frame,
                                                 render_shadow_geometry,
                                                 render_shadow_map)

from test_torch_frame import assert_images_close

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)

W, H, D = 128, 96, 128
POSE = ([60.0, 45.0, 80.0], -127.0, -20.0)   # tests/test_parallel.py:23-26


def cube_state(scene, times=None):
    pos, yaw, pitch = POSE
    cam = port.camera_state(pos, np.deg2rad(np.float32(yaw)),
                            np.deg2rad(np.float32(pitch)), "cpu")
    return port.frame_state(scene, cam, port.default_lights(device="cpu"),
                            times)


@pytest.fixture(scope="module")
def cube():
    scene = cube_scene(device="cpu")
    times = torch.linspace(2.0, 9.0, 256)
    return scene, cube_state(scene), cube_state(scene, times)


def config(**kw):
    return port.RenderConfig(**{"width": W, "height": H, "shadow_dim": D,
                                **kw})


# name: (config changes, bands, interleave, external map): the cases of
# tests/test_parallel.py:53-140 at its 8 bands, and a shadow map whose
# bands are not whole 8-row blocks (the map is gathered, not the table).
CASES = {
    "lit": (dict(mode=RenderMode.LIT), 8, False, False),
    "lit_shadow": (dict(mode=RenderMode.LIT_SHADOW), 8, False, False),
    "deferred": (dict(mode=RenderMode.LIT_SHADOW, deferred=True), 8, False,
                 False),
    "external_map": (dict(mode=RenderMode.LIT_SHADOW), 8, False, True),
    "unlit": (dict(mode=RenderMode.UNLIT), 8, False, False),
    "wireframe": (dict(mode=RenderMode.WIREFRAME), 8, False, False),
    "debug_depth": (dict(mode=RenderMode.DEBUG,
                         debug_texture=DebugTexture.SCENE_DEPTH), 8, False,
                    False),
    "debug_shadow": (dict(mode=RenderMode.DEBUG,
                          debug_texture=DebugTexture.SHADOW_MAP), 8, False,
                     False),
    "interleaved_lit": (dict(mode=RenderMode.LIT), 8, True, False),
    "interleaved_lit_shadow": (dict(mode=RenderMode.LIT_SHADOW), 8, True,
                               False),
    "interleaved_nondividing_height": (dict(mode=RenderMode.LIT, tile_h=8),
                                       8, True, False),
    "lit_shadow_map_gathered": (dict(mode=RenderMode.LIT_SHADOW,
                                     shadow_dim=120), 6, False, False),
}


@pytest.mark.parametrize("name", CASES)
def test_banded_frame_equals_whole_frame(cube, name):
    """Every band of the one-process mesh, reassembled: the port's whole
    frame bit for bit, u8 surface and depth."""
    scene, state, timed = cube
    changes, n, interleave, external = CASES[name]
    cfg = config(output_u8=True, **changes)
    st = timed if cfg.mode == RenderMode.DEBUG else state
    kw = {"shadow_map": render_shadow_map(scene, st, cfg)} if external \
        else {}
    whole = render_frame(scene, st, cfg, **kw)
    out = mesh.render_frame_sharded(scene, st, cfg, mesh.make_mesh(n),
                                    interleave=interleave, **kw)
    image, depth = out.image, out.depth
    if interleave:
        image, depth = (mesh.deinterleave_rows(t, n, cfg.tile_h, H)
                        for t in (image, depth))
    assert torch.equal(image, whole.image) and torch.equal(depth, whole.depth)
    assert whole.image.float().std() > 10.0
    assert int(out.raster_overflow) == int(whole.raster_overflow) == 0


def test_band_rules(cube):
    """The reference's rules: no DEBUG in interleaved bands, shadow_geom
    for whole maps only; and view_wh for whole frames only."""
    scene, state, _ = cube
    dbg = config(mode=RenderMode.DEBUG)
    with pytest.raises(ValueError):
        mesh.render_frame_sharded(scene, state, dbg, mesh.make_mesh(4),
                                  interleave=True)
    cfg = config()
    geom = render_shadow_geometry(scene, state, cfg)
    with pytest.raises(ValueError):
        render_band(scene, state, cfg, shadow_geom=geom, band_h=24,
                    y0=[0, 24, 48, 72], shadow_bands=4)
    with pytest.raises(ValueError):
        render_band(scene, state, cfg, band_h=48, y0=[0, 48],
                    view_wh=(100, 80))


@pytest.fixture(scope="module")
def standin():
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32, device="cpu")
    state = port.frame_state(scene, port.camera_state(
        [-900.0, 180.0, 0.0], 0.0, np.deg2rad(-5.0), "cpu"),
        port.default_lights(device="cpu"))
    return frame_geometry(scene, state, config())


@pytest.mark.parametrize("n,interleave", [(4, False), (3, False),
                                          (4, True)])
def test_plain_band_rasters_match_reference_oracle(standin, n, interleave):
    """The plain K2 on each band (its own grid's bins when contiguous,
    band_h 24 or 32 on 16-row tiles; the full grid's tile rows when
    interleaved) against the JAX oracle's band raster
    (``rasterize_xla(y_offset, y_stride, tile_h)``), and the port's oracle
    band against it."""
    g = standin
    band_h, step = mesh._band_geometry(config(), n, interleave)
    stride = n if interleave else 1
    setup = jnp.asarray(g.setup.setup.numpy())
    for k in range(n):
        y0 = k * (step if interleave else band_h)
        bins = interleave_bins(g.bins, k, n) if interleave else bin_tiles(
            g.setup.bbox, W, band_h, 16, 16, 640, y0=y0)
        pix = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox,
                                  bins, W, H, y0=y0, y_stride=stride,
                                  band_h=band_h)
        ref = ref_raster.rasterize_xla(setup, W, band_h,
                                       y_offset=float(y0), y_stride=stride,
                                       tile_h=16)
        ours = port_raster.rasterize_xla(g.setup.setup, W, band_h,
                                         y_offset=float(y0),
                                         y_stride=stride, tile_h=16)
        r = torch.arange(band_h)
        inside = (y0 + r // 16 * stride * 16 + r % 16 < H).numpy()
        tri = np.asarray(ref.tri)[inside]
        np.testing.assert_array_equal(pix.mask.numpy()[inside], tri >= 0)
        same = pix.tid.numpy()[inside] == tri
        assert same.mean() >= 0.998
        np.testing.assert_allclose(pix.z.numpy()[inside][same],
                                   np.asarray(ref.z)[inside][same], rtol=0,
                                   atol=1e-6)
        assert (pix.tid[torch.from_numpy(~inside)] == -1).all()
        np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri))
        np.testing.assert_allclose(ours.z.numpy(), np.asarray(ref.z),
                                   rtol=0, atol=1e-6)
    assert g.setup.bbox.shape[0] > 5000


def test_plain_depth_bands_match_reference_oracle(standin):
    """The plain K1 on each of 4 map bands, from the full map's bins:
    the rows of the whole map exactly, and the JAX oracle's band raster
    (``rasterize_depth_xla(band_h, y_offset)``) within 1e-6."""
    g = standin
    st = g.shadow_setup
    whole = rc.rasterize_depth(st.setup, st.bbox, g.shadow_bins, D)
    assert (whole < 1.0).float().mean() > 0.05
    sb = D // 4
    for k in range(4):
        band = rc.rasterize_depth(st.setup, st.bbox, g.shadow_bins, D,
                                  k * sb, sb)
        assert torch.equal(band, whole[k * sb:(k + 1) * sb])
        ref = ref_raster.rasterize_depth_xla(jnp.asarray(st.setup.numpy()),
                                             D, band_h=sb,
                                             y_offset=float(k * sb))
        np.testing.assert_allclose(band.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


def test_shadow_table_bands_match_reference():
    """Every band of 4 with its halo (edge-clamped at the map's ends):
    the JAX ``build_shadow_table_band``'s values and the port's whole
    table's rows, exactly."""
    rng = np.random.RandomState(6)
    smap = rng.uniform(0.0, 1.2, (D, D)).astype(np.float32)
    smap[rng.rand(D, D) < 0.3] = 1.0
    full = build_shadow_table(torch.from_numpy(smap))
    n, sb = 4, D // 4
    rows = full.shape[0] // n
    for k in range(n):
        band = smap[k * sb:(k + 1) * sb]
        top1 = smap[k * sb - 1:k * sb] if k else band[:1]
        bot2 = smap[(k + 1) * sb:(k + 1) * sb + 2] if k < n - 1 \
            else np.repeat(band[-1:], 2, 0)
        ours = build_shadow_table_band(*map(torch.from_numpy,
                                            (band, top1, bot2)), D)
        ref = ref_sampling.build_shadow_table_band(
            *map(jnp.asarray, (band, top1, bot2)), D)
        np.testing.assert_array_equal(ours.numpy(),
                                      np.asarray(ref).astype(np.float32))
        assert torch.equal(ours, full[k * rows:(k + 1) * rows])


@pytest.mark.parametrize("row0", [0, 5, 30, 47, 80])
def test_band_overlays_match_reference(row0):
    """Both band overlays on a band of 32 rows of a 112-row screen, at
    first rows that hold all, part or none of the quad and the graph's
    region, against the JAX ``*_band`` functions and the full composite's
    rows."""
    rng = np.random.RandomState(row0)
    full_h, hb, w = 112, 32, 512
    image = rng.uniform(0, 1, (full_h, w, 3)).astype(np.float32)
    tex = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    times = rng.uniform(2.0, 14.0, 256).astype(np.float32)
    band = image[row0:row0 + hb]
    ours = overlay.debug_texture_quad_band(torch.from_numpy(band), row0,
                                           full_h, torch.from_numpy(tex),
                                           0.1, 10000.0)
    ref = ref_overlay.debug_texture_quad_band(
        jnp.asarray(band), jnp.float32(row0), full_h, jnp.asarray(tex), 0.1,
        10000.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    whole = overlay.debug_texture_quad(torch.from_numpy(image),
                                       torch.from_numpy(tex), 0.1, 10000.0)
    assert torch.equal(ours, whole[row0:row0 + hb])
    ours = overlay.frame_time_graph_band(torch.from_numpy(band), row0,
                                         full_h, torch.from_numpy(times))
    ref = ref_overlay.frame_time_graph_band(jnp.asarray(band),
                                            jnp.float32(row0), full_h,
                                            jnp.asarray(times))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    whole = overlay.frame_time_graph(torch.from_numpy(image),
                                     torch.from_numpy(times))
    assert torch.equal(ours, whole[row0:row0 + hb])


@pytest.mark.parametrize("n,interleave,tile_h", [
    (8, False, 16), (4, True, 16), (8, True, 8), (5, True, 16)])
def test_band_geometry_and_deinterleave_match_reference(n, interleave,
                                                        tile_h):
    cfg = config(tile_h=tile_h)
    ref_cfg = kani.RenderConfig(width=W, height=H, shadow_dim=D,
                                tile_h=tile_h)
    assert mesh._band_geometry(cfg, n, interleave) \
        == ref_mesh._band_geometry(ref_cfg, n, interleave)
    band_h, _ = mesh._band_geometry(cfg, n, True)
    stack = np.random.RandomState(n).uniform(
        0, 1, (n * band_h, 7, 3)).astype(np.float32)
    ref = np.asarray(ref_mesh.deinterleave_rows(stack, n, tile_h, H))
    np.testing.assert_array_equal(
        mesh.deinterleave_rows(stack, n, tile_h, H), ref)
    np.testing.assert_array_equal(
        mesh.deinterleave_rows(torch.from_numpy(stack), n, tile_h,
                               H).numpy(), ref)


def test_banded_frame_matches_reference_sharded_frame(cube):
    """The JAX ``render_frame_sharded`` on its 8-device virtual CPU mesh
    (LIT_SHADOW, fresh map in bands, contiguous) against the port's frame
    in 8 bands: the golden criterion on the u8 surface."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh of tests/conftest.py")
    scene, state, _ = cube
    ref_scene = ref_cube_scene()
    pos, yaw, pitch = POSE
    ref_state = kani.frame_state(ref_scene, kani.CameraState(
        position=jnp.array(pos, jnp.float32),
        yaw=jnp.float32(np.deg2rad(np.float32(yaw))),
        pitch=jnp.float32(np.deg2rad(np.float32(pitch)))),
        kani.default_lights())
    ref = ref_mesh.render_frame_sharded(
        ref_scene, ref_state,
        kani.RenderConfig(width=W, height=H, shadow_dim=D, output_u8=True,
                          mode=kani.RenderMode.LIT_SHADOW),
        ref_mesh.make_mesh())
    ours = mesh.render_frame_sharded(
        scene, state, config(output_u8=True), mesh.make_mesh(8))
    assert_images_close(ours.image.numpy(), np.asarray(ref.image))


def test_gloo_ranks_equal_one_process():
    """``dryrun_multichip(2, "cpu")``: two gloo processes render
    LIT_SHADOW (fresh map in bands, assembled as its table) in contiguous
    and interleaved bands and DEBUG in contiguous bands, each equal to the
    whole frame; rank 0's frames equal the one-process mesh's, bit for
    bit."""
    ranks = mesh.dryrun_multichip(2, device="cpu")
    local = mesh._dryrun_frames(mesh.make_mesh(2), torch.device("cpu"))
    assert ranks.keys() == local.keys()
    for name, (image, depth) in local.items():
        assert torch.equal(ranks[name][0], image), name
        assert torch.equal(ranks[name][1], depth), name
    assert local["full"][0].float().std() > 10.0
