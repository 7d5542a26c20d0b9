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
from kanirenderer_tpu_torch.ops import raster_cases
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops import raster_xla as port_xla
from kanirenderer_tpu_torch.ops.binning import bin_tiles
from kanirenderer_tpu_torch.ops.interpolate import FAT_LANES
from kanirenderer_tpu_torch.ops.raster_ablation import patch_survivors

from test_torch_raster import (D, H, W, _geometry, random_triangles,
                               ref_setup)
from test_torch_raster import pallas_loop_form  # noqa: F401  (fixture)

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


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


@pytest.mark.parametrize("wireframe", [False, True])
@pytest.mark.parametrize("make", [raster_cases.wire_interior_case,
                                  raster_cases.nonfinite_case])
def test_plain_visibility_matches_oracle_on_interior_and_nonfinite_cases(
        make, wireframe):
    """The plain K3 and K2w on wireframe interiors (whole tiles, whole
    patches and single pixels farther than the threshold from every edge)
    and on infinite or overflowing plane coefficients, against the
    reference's brute-force raster: exact on winners and depth,
    barycentrics within 1e-6.  The planes are exactly representable, and
    the threshold band that the formulas' rounding could flip (the port's
    l·(1/sqrt), the oracle's l/sqrt) is empty: 5e-5 px either side of
    ``raster_cases.WIRE_THRESH`` no pixel changes its winner."""
    case = make("cpu")
    W2, H2, thresh = case.width, case.height, raster_cases.WIRE_THRESH
    args = (case.setup, case.bbox, case.bins, W2, H2, wireframe)
    vis = rc.rasterize(*args, thresh)
    for eps in (-5e-5, 5e-5):
        assert torch.equal(rc.rasterize(*args, thresh + eps).tri, vis.tri)
    ref = raster_xla.rasterize_xla(jnp.asarray(case.setup.numpy()), W2, H2,
                                   wireframe=wireframe, wire_thresh=thresh)
    np.testing.assert_array_equal(vis.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(vis.z.numpy(), np.asarray(ref.z))
    np.testing.assert_allclose(vis.bary.numpy(), np.asarray(ref.bary),
                               rtol=0, atol=1e-6)
    pix = rc.rasterize_pixels(case.records, *args, thresh)
    assert torch.equal(pix.tid, vis.tri) and torch.equal(pix.z, vis.z)
    assert torch.isfinite(pix.varyings).all()
    covered = (vis.tri >= 0).float().mean().item()
    won = set(vis.tri.unique().tolist())
    if make is raster_cases.wire_interior_case:
        # the large triangles' insides are transparent, their edges are not
        assert (0.1 < covered < 0.3) if wireframe else covered > 0.85
        assert {0, 1, 2} <= won
    else:
        # g = 0 with finite plane values keeps a whole band in the
        # wireframe; an infinite plane value is inside, but its distance
        # inf·0 is NaN and covers nothing, as jnp.minimum has it
        assert {0, 7, 10} <= won
        assert ({1, 2} <= won) != wireframe and not {4, 5, 8, 9} & won
        band0 = vis.tri[4:, 2:11]
        assert (band0 == 0).all()


CASES = [raster_cases.list_overflow_case, raster_cases.chunk_cap_case,
         raster_cases.wire_interior_case, raster_cases.nonfinite_case,
         "random"]


@pytest.mark.parametrize("make", CASES)
def test_warp_rejection_drops_nothing_that_covers(make):
    """The kernels' per-warp rejections (raster_common.cuh may_cover and,
    for wireframe, may_pass), written out in PyTorch: no (triangle, 8×4
    patch) they drop has a pixel the triangle covers, on every adversarial
    case and on random triangles; and they do drop work (for wireframe,
    more than without)."""
    if make == "random":
        st = random_triangles(3, 112, 64, T=2 * 128)
        setup, bbox, width, height = st.setup, st.bbox, 112, 64
        bins = bin_tiles(bbox, width, height, 16, 16, 640)
    elif make is raster_cases.list_overflow_case:
        case = make(104, 40, "cpu", chunks=4)
    elif make is raster_cases.chunk_cap_case:
        case = make(3, "cpu", extra=1)
    else:
        case = make("cpu")
    if make != "random":
        setup, bbox, bins = case.setup, case.bbox, case.bins
        width, height = case.width, case.height
    tile, chunk = rc._pairs(bins)
    dropped = {}
    for thresh in (None, raster_cases.WIRE_THRESH):
        cov, _, _ = rc._eval_pairs(setup, bbox, tile, chunk, bins, width,
                                   height, thresh)
        hit, keep = patch_survivors(setup, bbox, tile, chunk, bins, thresh)
        # (P, 128, 16·16) pixels → (P, 128, 8 patches): any pixel covered
        P = cov.shape[0]
        by_patch = cov.reshape(P, 128, 4, 4, 2, 8).permute(
            0, 1, 2, 4, 3, 5).reshape(P, 128, 8, 32).any(-1)
        assert cov.any() and not (by_patch & ~keep).any()
        assert not (keep & ~hit[..., None]).any()
        dropped[thresh] = int((hit[..., None] & ~keep).sum())
    assert 0 < dropped[None] <= dropped[raster_cases.WIRE_THRESH]
    if make is raster_cases.wire_interior_case:
        assert dropped[raster_cases.WIRE_THRESH] > dropped[None] + 100


def test_rasterize_config_bins_and_rasterizes(geometry):
    """``rasterize_config`` is ``rasterize`` on the main grid's bins."""
    g = geometry
    cfg = RenderConfig(width=W, height=H, shadow_dim=D)
    vis = rc.rasterize_config(g.setup, cfg)
    want = rc.rasterize(g.setup.setup, g.setup.bbox, g.bins, W, H)
    for a, b in zip(vis, want):
        assert torch.equal(a, b)
