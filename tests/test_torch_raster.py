"""The plain PyTorch versions of K1 and K2 against the JAX package's rasters
(K2's wireframe variant and K3: tests/test_torch_visibility.py).

The reference Pallas kernels run in interpret mode on the CPU, as the JAX
package's own raster tests run them, with its loop-form subbatch sweep
(``raster_pallas.EVAL_LOOP``, same results, an 8x smaller program to
compile).  Both sides get the same setup rows (the port's, handed across).

Tolerances:
* K1: depth maps equal to the Pallas kernel's and to the brute-force
  ``rasterize_depth_xla`` within 1e-6 (both evaluate the depth plane the
  same way up to FMA contraction);
* K2: the reference's parity bounds (test_binning_pallas.py:79-84) —
  coverage mask identical, winning triangle differs on ≤ 0.2% of pixels,
  depth within 1e-6 and integer planes equal where it agrees, varyings
  within 1e-5 relative to each plane's magnitude;
* the adversarial cases (ops/raster_cases.py) have exactly representable
  planes, so there the plain rasters equal the brute-force ones bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.ops import raster_pallas, raster_xla
from kanirenderer_tpu.ops.interpolate import interpolate as ref_interpolate
from kanirenderer_tpu.ops.vertex import TriangleSetup as RefSetup

from kanirenderer_tpu_torch.core.types import (CHUNK_SIZE, RenderConfig,
                                               RenderMode, camera_state,
                                               default_lights, frame_state)
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import raster_cases
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops import raster_xla as port_xla
from kanirenderer_tpu_torch.ops import vertex
from kanirenderer_tpu_torch.ops.binning import bin_tiles
from kanirenderer_tpu_torch.ops.interpolate import FAT_LANES
from kanirenderer_tpu_torch.passes.frame import frame_geometry

W, H, D = 256, 192, 256

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


def _geometry(mode):
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32, device="cpu")
    state = frame_state(scene, camera_state([-900.0, 180.0, 0.0], 0.0,
                                            np.deg2rad(-5.0), "cpu"),
                        default_lights(device="cpu"))
    return frame_geometry(scene, state, RenderConfig(
        width=W, height=H, shadow_dim=D, mode=mode))


@pytest.fixture(scope="module")
def geometry():
    return _geometry(RenderMode.LIT_SHADOW)


@pytest.fixture
def pallas_loop_form(monkeypatch):
    monkeypatch.setattr(raster_pallas, "EVAL_LOOP", True)


def ref_setup(st):
    return RefSetup(setup=jnp.asarray(st.setup.numpy()),
                    bbox=jnp.asarray(st.bbox.numpy()),
                    clipfree=jnp.asarray(st.clipfree.numpy()),
                    zmin=jnp.asarray(st.zmin.numpy()))


def test_depth_plain_matches_pallas_and_xla(geometry, pallas_loop_form):
    st = geometry.shadow_setup
    ours = rc.rasterize_depth(st.setup, st.bbox, geometry.shadow_bins, D)
    assert ours.shape == (D, D) and (ours < 1.0).mean(dtype=float) > 0.05
    cfg = kani.RenderConfig(width=W, height=H, shadow_dim=D)
    pallas = np.asarray(raster_pallas.rasterize_depth(ref_setup(st), cfg))
    brute = np.asarray(raster_xla.rasterize_depth_xla(
        jnp.asarray(st.setup.numpy()), D))
    np.testing.assert_allclose(ours.numpy(), pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.numpy(), brute, rtol=0, atol=1e-6)


def test_pixels_plain_matches_pallas(geometry, pallas_loop_form):
    g = geometry
    ours = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox,
                               g.bins, W, H)
    cfg = kani.RenderConfig(width=W, height=H, shadow_dim=D)
    rec = np.zeros((g.records.shape[0], 128), np.float32)
    rec[:, :FAT_LANES] = g.records.numpy()
    ref = raster_pallas.rasterize_pixels(ref_setup(g.setup),
                                         jnp.asarray(rec), cfg)
    vis = raster_xla.rasterize_xla(jnp.asarray(g.setup.setup.numpy()), W, H)

    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    assert ours.mask.float().mean() > 0.5
    tid = ours.tid.numpy()
    same = tid == np.asarray(vis.tri)
    assert (~same).mean() <= 0.002
    np.testing.assert_allclose(ours.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ours.z.numpy()[same], np.asarray(vis.z)[same],
                               rtol=0, atol=1e-6)
    a, b = ours.varyings.numpy(), np.asarray(ref.varyings)
    scale = np.abs(b).max(axis=(1, 2), keepdims=True) + 1.0
    assert (np.abs(a - b) <= 1e-5 * scale).all()
    for f in ("mat_id", "tex_w", "tex_h", "blk_base", "blk_w"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert int(ours.overflow) == 0
    assert ours.tid.dtype == ours.mat_id.dtype == torch.int32


def _band_setup(bands, T=3 * CHUNK_SIZE, width=64, height=32):
    """Setup rows and bboxes of triangles covering x ∈ [x0, x1), y ≥ 4 at a
    constant depth: ``bands`` maps triangle id → (x0, x1, z); the other
    rows are invalid (zero with e0.c = −1, empty bbox)."""
    setup = torch.zeros((T, 16))
    setup[:, 2] = -1.0
    bbox = torch.zeros((T, 4))
    bbox[:, 0], bbox[:, 1] = width, height
    for i, (x0, x1, z) in bands.items():
        setup[i, 0:3] = torch.tensor([1.0, 0.0, -x0])     # x − x0 ≥ 0
        setup[i, 3:6] = torch.tensor([-1.0, 0.0, x1])     # x1 − x ≥ 0
        setup[i, 6:9] = torch.tensor([0.0, 1.0, -4.0])    # y − 4 ≥ 0
        setup[i, 9:12] = torch.tensor([0.0, 0.0, z])
        setup[i, 15] = 1.0
        bbox[i] = torch.tensor([x0, 4.0, x1, height])
    records = torch.zeros((T, FAT_LANES))
    records[:, :16] = setup
    records[:, 67] = torch.arange(T, dtype=torch.float32)   # mat = id
    return setup, bbox, records


def test_depth_ties_keep_the_lower_triangle_id():
    """Coplanar triangles in one chunk and across chunks: the lowest id
    wins a depth tie (strict < in ascending id), a nearer triangle wins
    outright, and a triangle at z = 1 (the clear depth) is never kept."""
    bands = {7: (8, 40, 0.5), 3: (8, 40, 0.5), 140: (8, 40, 0.5),
             290: (44, 60, 1.0)}
    setup, bbox, records = _band_setup(bands)
    bins = bin_tiles(bbox, 64, 32, 16, 16, cap=64)
    pix = rc.rasterize_pixels(records, setup, bbox, bins, 64, 32)
    inside = torch.zeros((32, 64), dtype=torch.bool)
    inside[4:, 8:40] = True
    assert torch.equal(pix.mask, inside)
    assert (pix.tid[inside] == 3).all() and (pix.mat_id[inside] == 3).all()
    assert (pix.z[inside] == 0.5).all() and (pix.z[~inside] == 1.0).all()
    assert (pix.tid[~inside] == -1).all()

    bands[200] = (8, 40, 0.25)                # nearer, higher id
    setup, bbox, records = _band_setup(bands, height=64)
    pix = rc.rasterize_pixels(records, setup, bbox,
                              bin_tiles(bbox, 64, 32, 16, 16, cap=64), 64, 32)
    assert (pix.tid[inside] == 200).all()
    depth = rc.rasterize_depth(setup, bbox,
                               bin_tiles(bbox, 64, 64, 16, 16, cap=64), 64)
    assert (depth[4:, 8:40] == 0.25).all()
    assert (depth[:, 40:] == 1.0).all() and (depth[:4] == 1.0).all()


def test_pixels_plain_matches_brute_force_interpolation(geometry):
    """Phase 2 against the reference's gather-based interpolate on the
    brute-force visibility buffer (the XLA backend's path), where the
    winning triangle agrees."""
    g = geometry
    ours = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox,
                               g.bins, W, H)
    vis = raster_xla.rasterize_xla(jnp.asarray(g.setup.setup.numpy()), W, H)
    same = ours.tid.numpy() == np.asarray(vis.tri)
    # per-vertex tables in the reference's layout: one vertex per corner
    T = g.records.shape[0]
    vary = g.vout.varyings.permute(2, 0, 1).reshape(3 * T, -1).numpy()
    tri_idx = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    extra = g.records[:, 67:73].numpy()
    mat = extra[:, 0].astype(np.int32)
    ref = ref_interpolate(vis, jnp.asarray(tri_idx), jnp.asarray(mat),
                          jnp.asarray(vary), jnp.zeros(1, jnp.int32),
                          jnp.zeros(1, jnp.int32), jnp.zeros((1, 2),
                                                             jnp.int32))
    a, b = ours.varyings.numpy()[:, same], np.asarray(ref.varyings)[:, same]
    scale = np.abs(b).max(axis=1, keepdims=True) + 1.0
    assert (np.abs(a - b) <= 1e-5 * scale).all()
    np.testing.assert_array_equal(ours.mat_id.numpy()[same],
                                  np.asarray(ref.mat_id)[same])


def test_brute_force_oracle(geometry):
    """The port's brute-force rasters against the reference's, and the
    plain tile rasters against them (K2 bounds as above; depth maps within
    1e-6).  Barycentrics within 1e-4: the reference oracle is compiled, and
    XLA's contracted multiply-adds move l_i/Σl by ulps of plane
    coefficients that reach 1e5 at this pose."""
    g = geometry
    vis = port_xla.rasterize_xla(g.setup.setup, W, H)
    ref = raster_xla.rasterize_xla(jnp.asarray(g.setup.setup.numpy()), W, H)
    same = vis.tri.numpy() == np.asarray(ref.tri)
    assert (~same).mean() <= 0.002 and (vis.tri >= 0).float().mean() > 0.5
    np.testing.assert_allclose(vis.z.numpy()[same], np.asarray(ref.z)[same],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(vis.bary.numpy()[same],
                               np.asarray(ref.bary)[same], rtol=0, atol=1e-4)
    pix = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox,
                              g.bins, W, H)
    same = pix.tid == vis.tri
    assert (~same).float().mean() <= 0.002
    torch.testing.assert_close(pix.z[same], vis.z[same], rtol=0, atol=1e-6)

    st = g.shadow_setup
    depth = port_xla.rasterize_depth_xla(st.setup, D)
    np.testing.assert_allclose(
        depth.numpy(), np.asarray(raster_xla.rasterize_depth_xla(
            jnp.asarray(st.setup.numpy()), D)), rtol=0, atol=1e-6)
    torch.testing.assert_close(
        rc.rasterize_depth(st.setup, st.bbox, g.shadow_bins, D), depth,
        rtol=0, atol=1e-6)


def random_triangles(seed, width, height, T=3 * CHUNK_SIZE):
    """Triangle setup of random clip-space triangles: small and large ones,
    some crossing the near plane (w < 0 corners), some outside the depth
    range, ~5% invalid."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(0.2, 2.0, (3, 1, T))
    w[0, 0, rng.rand(T) < 0.03] = -0.2       # near-plane crossers
    centre = rng.uniform(-1.0, 1.0, (1, 2, T))
    size = rng.choice([0.05, 0.3, 1.5], (1, 1, T), p=[0.7, 0.28, 0.02])
    xy = (centre + size * rng.uniform(-1, 1, (3, 2, T))) * np.abs(w)
    z = rng.uniform(-0.1, 1.1, (3, 1, T)) * np.abs(w)
    clip = torch.from_numpy(np.concatenate([xy, z, w], 1).astype(np.float32))
    valid = torch.from_numpy(rng.rand(T) > 0.05)
    st, _ = vertex.triangle_setup_corners(clip, valid, width, height, False)
    return st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_rasters_match_oracle_on_random_triangles(seed):
    """Near-plane crossers, slivers and full-screen triangles through the
    binner and the plain tile rasters, against the brute-force oracle:
    winners within the K2 bound above; depth within four float32 ulps of
    the depth plane's terms |a|·x + |b|·y + |c| (these planes reach
    coefficients of ~100, and the oracle adds the same three terms in
    another order)."""
    W2, H2 = 80, 48
    st = random_triangles(seed, W2, H2)
    assert (~st.clipfree).any() and (st.setup[:, 15] > 0).sum() > 200
    records = torch.zeros((st.setup.shape[0], FAT_LANES))
    records[:, :16] = st.setup
    bins = bin_tiles(st.bbox, W2, H2, 16, 16, cap=640)
    pix = rc.rasterize_pixels(records, st.setup, st.bbox, bins, W2, H2)
    vis = port_xla.rasterize_xla(st.setup, W2, H2)
    assert 0.2 < pix.mask.float().mean() < 1.0
    same = pix.tid == vis.tri
    assert (~same).float().mean() <= 0.002
    assert _within_ulps(pix.z, vis.z, st.setup, pix.tid)[same].all()

    sq = random_triangles(seed, 64, 64)
    bins = bin_tiles(sq.bbox, 64, 64, 16, 16, cap=640)
    depth = rc.rasterize_depth(sq.setup, sq.bbox, bins, 64)
    want = port_xla.rasterize_depth_xla(sq.setup, 64)
    winner = port_xla.rasterize_xla(sq.setup, 64, 64).tri
    assert _within_ulps(depth, want, sq.setup, winner).all()


def _within_ulps(z, want, setup, tid):
    """|z − want| ≤ 4 ulps of the winning depth plane's term magnitude."""
    h, w = z.shape
    r = setup[tid.clamp(min=0).to(torch.int64)]
    x = torch.arange(w, dtype=torch.float32) + 0.5
    y = torch.arange(h, dtype=torch.float32)[:, None] + 0.5
    scale = r[..., 9].abs() * x + r[..., 10].abs() * y + r[..., 11].abs()
    return (z - want).abs() <= 4 * 2.0 ** -24 * scale + 1e-7



def _kept_rows(case):
    """The case's setup rows with the triangles of dropped chunks made
    invalid, as numpy: what a raster that honours the cap sees."""
    invalid = torch.zeros(16)
    invalid[2] = -1.0
    return torch.where(case.kept[:, None], case.setup, invalid).numpy()


@pytest.mark.parametrize("which", [0, 1])
def test_plain_rasters_match_oracle_on_adversarial_cases(which):
    """Hit-list overflow, a capped tile with counted overflow, empty
    tiles, depth ties across chunks, a ragged raster and NaN planes: the
    plain K2 and K1 against the reference's brute-force rasters, exact."""
    case = raster_cases.adversarial_cases("cpu", cap=8)[which]
    W2, H2 = case.width, case.height
    want_overflow = 0 if which == 0 else 2 * 10
    assert int(case.bins.overflow) == want_overflow
    assert int(case.bins.count.max()) == (24, 8)[which]
    assert (case.bins.count == 0).any()
    assert case.setup.isnan().any() and (W2 % 16 or which == 1)
    pix = rc.rasterize_pixels(case.records, case.setup, case.bbox, case.bins,
                              W2, H2)
    vis = raster_xla.rasterize_xla(jnp.asarray(_kept_rows(case)), W2, H2)
    np.testing.assert_array_equal(pix.tid.numpy(), np.asarray(vis.tri))
    np.testing.assert_array_equal(pix.z.numpy(), np.asarray(vis.z))
    assert 0.2 < pix.mask.float().mean() < 1.0
    assert int(pix.overflow) == want_overflow
    # the lowest id among the nearest bands wins each pixel
    tid = pix.tid[pix.mask].to(torch.int64)
    assert not case.setup[tid].isnan().any() and case.kept[tid].all()
    # phase 2 reads the winner's record
    np.testing.assert_array_equal(
        pix.mat_id[pix.mask].numpy(),
        case.records[tid, 67].to(torch.int32).numpy())

    sq = raster_cases.adversarial_cases("cpu", cap=8, square=True)[which]
    depth = rc.rasterize_depth(sq.setup, sq.bbox, sq.bins, sq.width)
    want = raster_xla.rasterize_depth_xla(jnp.asarray(_kept_rows(sq)),
                                          sq.width)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want))
    assert (depth < 1.0).any() and (depth == 1.0).any()


@pytest.mark.parametrize("make", [raster_cases.wire_interior_case,
                                  raster_cases.nonfinite_case])
def test_plain_rasters_match_oracle_on_interior_and_nonfinite_cases(make):
    """Triangles spanning many tiles with slivers and small triangles
    between them, and infinite or float32-overflowing plane coefficients
    (an infinite plane value is inside, a NaN one is not): the plain K2
    and K1 against the reference's brute-force rasters, exact.  The
    wireframe variants are in tests/test_torch_visibility.py."""
    case = make("cpu")
    W2, H2 = case.width, case.height
    assert int(case.bins.overflow) == 0 and (W2 % 16 or H2 % 16)
    pix = rc.rasterize_pixels(case.records, case.setup, case.bbox, case.bins,
                              W2, H2)
    vis = raster_xla.rasterize_xla(jnp.asarray(case.setup.numpy()), W2, H2)
    np.testing.assert_array_equal(pix.tid.numpy(), np.asarray(vis.tri))
    np.testing.assert_array_equal(pix.z.numpy(), np.asarray(vis.z))
    assert 0.8 < pix.mask.float().mean() < 1.0
    assert torch.isfinite(pix.varyings).all()
    tid = pix.tid[pix.mask].to(torch.int64)
    np.testing.assert_array_equal(
        pix.mat_id[pix.mask].numpy(),
        case.records[tid, 67].to(torch.int32).numpy())
    if make is raster_cases.nonfinite_case:
        finite = torch.isfinite(case.setup).all(1)
        assert not finite.all() and not finite[tid.unique()].all()

    sq = make("cpu", height=W2)
    depth = rc.rasterize_depth(sq.setup, sq.bbox, sq.bins, W2)
    want = raster_xla.rasterize_depth_xla(jnp.asarray(sq.setup.numpy()), W2)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want))
    assert (depth < 1.0).any() and (depth == 1.0).any()


def test_record_lanes_equal_setup_rows(geometry):
    """K2's visibility phase reads its planes from the setup rows and its
    second phase from the records: lanes 0:16 of a record are the setup
    row."""
    g = geometry
    assert torch.equal(g.records[:, :16], g.setup.setup)
    assert g.setup.setup.shape == (g.records.shape[0], 16)


@pytest.mark.parametrize("cap", [640, 3])
def test_pair_tile_names_the_kept_entries(geometry, cap):
    """``ChunkBins.pair_tile`` holds the tile of every kept entry of the
    sorted list and -1 elsewhere, and the plain rasters never read it."""
    st = geometry.shadow_setup
    bins = bin_tiles(st.bbox, D, D, 16, 16, cap)
    tile, chunk = rc._pairs(bins)
    live = bins.pair_tile >= 0
    assert bins.pair_tile.shape == bins.chunk.shape
    assert bins.pair_tile.dtype == torch.int32
    assert torch.equal(bins.pair_tile[live].to(torch.int64), tile)
    assert torch.equal(bins.chunk[live].to(torch.int64), chunk)
    assert (int(bins.overflow) > 0) == (cap == 3)
    assert int((~live & (bins.chunk >= 0)).sum()) == int(bins.overflow)
    scrambled = bins._replace(pair_tile=torch.full_like(bins.pair_tile, 7))
    assert torch.equal(rc.rasterize_depth(st.setup, st.bbox, bins, D),
                       rc.rasterize_depth(st.setup, st.bbox, scrambled, D))
