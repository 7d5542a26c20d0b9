"""The plain PyTorch versions of K2w (K2's wireframe variant) and K3 (the
visibility raster) against the JAX package's rasters, as
tests/test_torch_raster.py holds K1 and K2 (same inputs, Pallas kernels in
interpret mode with ``EVAL_LOOP``).

Tolerances:
* K3 against the reference's ``rasterize``: winners agree on ≥ 99.8% of
  pixels; where they agree, depth within 1e-6 and barycentrics within
  1e-4 — the interpreted Pallas kernel is compiled by XLA, whose contracted
  multiply-adds move l_i/Σl by ulps of plane coefficients that reach 1e5
  at this pose (as for the brute-force oracle, test_torch_raster.py);
* K2w against the reference's wireframe ``rasterize_pixels``: K2's bounds
  (test_torch_raster.py);
* wireframe coverage: the Pallas kernel scales the edge function by
  ``rsqrt``, the port by a correctly rounded 1/sqrt, and the brute-force
  oracle divides by the edge length, so a pixel whose edge distance lies
  within rounding of the 0.7 px threshold can flip.  Such pixels are found
  by rendering the port at thresholds 1e-4 px either side ("unstable");
  every other pixel must agree as above, and unstable pixels stay under
  0.5% of the frame.  ``pytest -s`` prints how many pixels were unstable
  and how many of them differ.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.ops import raster_pallas, raster_xla

from kanirenderer_tpu_torch.core.types import RenderConfig, RenderMode
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops import raster_xla as port_xla
from kanirenderer_tpu_torch.ops.interpolate import FAT_LANES

from test_torch_raster import D, H, W, _geometry, ref_setup
from test_torch_raster import pallas_loop_form  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def geometry():
    return _geometry(RenderMode.LIT_SHADOW)


@pytest.fixture(scope="module")
def wire_geometry():
    """The WIREFRAME mode's geometry: camera setup without culling."""
    return _geometry(RenderMode.WIREFRAME)


WIRE = RenderConfig().wire_thresh_px
EPS = 1e-4


def _unstable(rows, bbox, bins, fn):
    """Pixels whose winner changes between thresholds WIRE ± EPS."""
    lo = fn(rows, bbox, bins, W, H, True, WIRE - EPS)
    hi = fn(rows, bbox, bins, W, H, True, WIRE + EPS)
    key = "tid" if hasattr(lo, "tid") else "tri"
    return (getattr(lo, key) != getattr(hi, key)).numpy()


def test_wireframe_pixels_plain_matches_pallas(wire_geometry,
                                               pallas_loop_form):
    g = wire_geometry
    ours = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox,
                               g.bins, W, H, wireframe=True)
    assert ours.tid.numpy().max() >= 0 and 0.2 < ours.mask.float().mean() \
        < 0.8
    cfg = kani.RenderConfig(width=W, height=H, shadow_dim=D)
    rec = np.zeros((g.records.shape[0], 128), np.float32)
    rec[:, :FAT_LANES] = g.records.numpy()
    ref = raster_pallas.rasterize_pixels(ref_setup(g.setup),
                                         jnp.asarray(rec), cfg,
                                         wireframe=True)
    unstable = _unstable(
        g.records, g.setup.bbox, g.bins,
        lambda rec, *rest: rc.rasterize_pixels(rec, g.setup.setup, *rest))
    assert unstable.mean() < 0.005, unstable.mean()
    differ = ours.mask.numpy() != np.asarray(ref.mask)
    print(f"K2w vs Pallas: {unstable.sum()} of {unstable.size} pixels "
          f"unstable, coverage differs on {differ.sum()} "
          f"({(differ & unstable).sum()} of them unstable)")
    ok = ~unstable
    np.testing.assert_array_equal(ours.mask.numpy()[ok],
                                  np.asarray(ref.mask)[ok])
    np.testing.assert_allclose(ours.z.numpy()[ok], np.asarray(ref.z)[ok],
                               rtol=0, atol=1e-6)
    a, b = ours.varyings.numpy()[:, ok], np.asarray(ref.varyings)[:, ok]
    scale = np.abs(b).max(axis=1, keepdims=True) + 1.0
    assert (np.abs(a - b) <= 1e-5 * scale).all()
    for f in ("mat_id", "tex_w", "tex_h", "blk_base", "blk_w"):
        np.testing.assert_array_equal(getattr(ours, f).numpy()[ok],
                                      np.asarray(getattr(ref, f))[ok],
                                      err_msg=f)
    # wireframe coverage is interior coverage near an edge
    full = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox,
                               g.bins, W, H)
    assert (full.mask | ~ours.mask).all()


@pytest.mark.parametrize("wireframe", [False, True])
def test_visibility_plain_matches_pallas(geometry, wire_geometry,
                                         pallas_loop_form, wireframe):
    g = wire_geometry if wireframe else geometry
    st = g.setup
    ours = rc.rasterize(st.setup, st.bbox, g.bins, W, H, wireframe)
    assert ours.tri.dtype == torch.int32 and ours.bary.shape == (H, W, 2)
    cfg = kani.RenderConfig(width=W, height=H, shadow_dim=D)
    ref = raster_pallas.rasterize(ref_setup(st), cfg, wireframe)
    ok = np.ones((H, W), bool)
    if wireframe:
        ok = ~_unstable(st.setup, st.bbox, g.bins, rc.rasterize)
        assert (~ok).mean() < 0.005
    tri = ours.tri.numpy()
    same = (tri == np.asarray(ref.tri)) & ok
    assert (tri >= 0).mean() > 0.2
    assert same[ok].mean() >= 0.998
    np.testing.assert_allclose(ours.z.numpy()[same], np.asarray(ref.z)[same],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.bary.numpy()[same],
                               np.asarray(ref.bary)[same], rtol=0, atol=1e-4)
    bg = tri < 0
    assert (ours.z.numpy()[bg] == 1.0).all() \
        and (ours.bary.numpy()[bg] == 0.0).all()
    # K3's winners are K2's
    pix = rc.rasterize_pixels(g.records, st.setup, st.bbox, g.bins, W, H,
                              wireframe)
    assert torch.equal(pix.tid, ours.tri) and torch.equal(pix.z, ours.z)


def test_wireframe_oracle(wire_geometry):
    """The port's brute-force wireframe raster against the reference's
    (the same formula: winners on ≥ 99.8% of pixels, depth and
    barycentrics as in test_brute_force_oracle), and the plain K3 against
    it away from the threshold."""
    g = wire_geometry
    st = g.setup
    vis = port_xla.rasterize_xla(st.setup, W, H, wireframe=True)
    ref = raster_xla.rasterize_xla(jnp.asarray(st.setup.numpy()), W, H,
                                   wireframe=True)
    same = vis.tri.numpy() == np.asarray(ref.tri)
    assert same.mean() >= 0.998 and 0.2 < (vis.tri >= 0).float().mean() < 0.8
    np.testing.assert_allclose(vis.z.numpy()[same], np.asarray(ref.z)[same],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(vis.bary.numpy()[same],
                               np.asarray(ref.bary)[same], rtol=0, atol=1e-4)
    ok = ~_unstable(st.setup, st.bbox, g.bins, rc.rasterize)
    k3 = rc.rasterize(st.setup, st.bbox, g.bins, W, H, wireframe=True)
    agree = (k3.tri == vis.tri).numpy()
    print(f"K3 vs brute-force oracle, wireframe: winners differ on "
          f"{(~agree).sum()} pixels, {(~agree & ~ok).sum()} of them "
          "unstable")
    assert agree[ok].mean() >= 0.998


def test_rasterize_config_bins_and_rasterizes(geometry):
    """``rasterize_config`` is ``rasterize`` on the main grid's bins."""
    g = geometry
    cfg = RenderConfig(width=W, height=H, shadow_dim=D)
    vis = rc.rasterize_config(g.setup, cfg)
    want = rc.rasterize(g.setup.setup, g.setup.bbox, g.bins, W, H)
    for a, b in zip(vis, want):
        assert torch.equal(a, b)
