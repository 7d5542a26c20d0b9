"""The port's occlusion skip: nearest-first lists and ``depth_bound``
(ops/binning) against the reference's ``bin_stream(zmin=)``, and the
skip rule replayed by ops/occ_replay against the plain rasters.  The gate
and the scopes are in tests/test_torch_occ_gate.py, the comparison with
the Pallas raster in tests/test_torch_occ_pallas.py.

Tolerances: the chunk sets per tile equal the reference's exactly; the
bound lies at or below every covered depth exactly (it is a proof, not an
estimate); a raster that skips what the replayed rule skips equals the
plain raster bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kanirenderer_tpu.ops import binning as ref_binning

from kanirenderer_tpu_torch.core.types import (CHUNK_SIZE, RenderConfig,
                                               RenderMode, camera_state,
                                               default_camera,
                                               default_lights, frame_state)
from kanirenderer_tpu_torch.models.procedural import (layered_scene,
                                                      sponza_standin_scene)
from kanirenderer_tpu_torch.ops import occ_replay, raster_cases
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops.binning import (RANKS, bin_tiles,
                                                depth_bound)
from kanirenderer_tpu_torch.passes.frame import frame_geometry
from tests.test_torch_binning import decode_stream

W, H, D = 256, 192, 256

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def geometry():
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32, device="cpu")
    state = frame_state(scene, camera_state([-900.0, 180.0, 0.0], 0.0,
                                            np.deg2rad(-5.0), "cpu"),
                        default_lights(device="cpu"))
    return frame_geometry(scene, state, RenderConfig(
        width=W, height=H, shadow_dim=D, occ_scope="1"))


@pytest.fixture(scope="module")
def layered():
    """layered_scene(target_tris=8000) at the gate test's configuration
    (tests/test_occ_gate.py:21-34): its main-grid geometry, scope "1"."""
    scene = layered_scene(target_tris=8_000, device="cpu")
    state = frame_state(scene, default_camera("cpu"),
                        default_lights(device="cpu"))
    cfg = RenderConfig(width=256, height=128, shadow_dim=64,
                       mode=RenderMode.LIT, occ_scope="1")
    return scene, state, cfg, frame_geometry(scene, state, cfg)


def _grid(geometry, grid):
    if grid == "camera":
        return geometry.setup, (W, H), geometry.bins
    return geometry.shadow_setup, (D, D), geometry.shadow_bins


@pytest.mark.parametrize("grid", ["camera", "shadow"])
def test_front_to_back_lists_match_bin_stream(geometry, grid):
    """Every tile's chunk set equals the reference's z-ordered run stream
    decoded, and every list is non-decreasing in the port's bound rank."""
    st, (w, h), bins = _grid(geometry, grid)
    assert bins.bound is not None
    tx, ty = bins.tiles_x, bins.tiles_y
    ref = ref_binning.bin_stream(
        jnp.asarray(st.bbox.numpy()), tx, ty, 16, 16, 64, 640, 128,
        zmin=jnp.asarray(st.zmin.numpy()))
    want = decode_stream(ref, st.bbox.shape[0] // CHUNK_SIZE, tx * ty)
    assert int(bins.count.sum()) == sum(map(len, want)) > 0
    rank = torch.clamp(bins.bound * RANKS, 0, RANKS - 1).to(torch.int64)
    ordered = 0
    for t in range(tx * ty):
        s, n = int(bins.start[t]), int(bins.count[t])
        lst = bins.chunk[s:s + n].to(torch.int64)
        assert sorted(lst.tolist()) == want[t], t
        assert bool((torch.diff(rank[lst]) >= 0).all()), t
        ordered += int(not bool((torch.diff(lst) >= 0).all()))
    assert int(bins.overflow) == int(ref.overflow) == 0
    if grid == "camera":   # some list is not in id order: it was sorted
        assert ordered > 0


def test_cap_keeps_the_nearest_chunks(geometry):
    st = geometry.setup
    bound = depth_bound(st.setup, st.bbox, 16, 16)
    full = bin_tiles(st.bbox, W, H, 16, 16, cap=10_000, occ_bound=bound)
    cap = 3
    capped = bin_tiles(st.bbox, W, H, 16, 16, cap=cap, occ_bound=bound)
    raw = full.count.to(torch.int64)
    assert raw.max() > cap
    assert int(capped.overflow) == int(torch.clamp(raw - cap, min=0).sum())
    rank = torch.clamp(full.bound * RANKS, 0, RANKS - 1).to(torch.int64)
    for t in range(raw.shape[0]):
        s, n = int(capped.start[t]), int(capped.count[t])
        fs, fn = int(full.start[t]), int(full.count[t])
        kept = capped.chunk[s:s + n].to(torch.int64)
        assert kept.tolist() == full.chunk[fs:fs + min(fn, cap)].tolist()
        dropped = full.chunk[fs + cap:fs + fn].to(torch.int64)
        if dropped.numel():
            assert rank[kept].max() <= rank[dropped].min()


def _bound_holds(setup, bbox, bins, width, height):
    """Every (pixel, triangle) the plain raster finds covered has a depth
    at or above the triangle's depth_bound; returns the covered count."""
    bound = depth_bound(setup, bbox, bins.tile_w, bins.tile_h)
    tile, chunk = rc._pairs(bins)
    n = 0
    for s in range(0, tile.shape[0], rc.PAIR_BATCH):
        ch = chunk[s:s + rc.PAIR_BATCH]
        cov, z, _ = rc._eval_pairs(setup, bbox, tile[s:s + rc.PAIR_BATCH],
                                   ch, bins, width, height)
        tri = ch[:, None] * CHUNK_SIZE + torch.arange(CHUNK_SIZE)
        assert bool(((z >= bound[tri][..., None]) | ~cov).all())
        n += int(cov.sum())
    return n


def test_bound_is_below_every_covered_depth(geometry, layered):
    for st, (w, h), bins in (_grid(geometry, "camera"),
                             _grid(geometry, "shadow")):
        assert _bound_holds(st.setup, st.bbox, bins, w, h) > 0
    g = layered[3]
    assert _bound_holds(g.setup.setup, g.setup.bbox, g.bins, 256, 128) > 0
    for case in (raster_cases.two_layer_case("cpu"),
                 raster_cases.bound_case("cpu")):
        assert _bound_holds(case.setup, case.bbox, case.bins, case.width,
                            case.height) > 0


def test_bound_case_defeats_the_vertex_bound():
    """The steep slivers cover a pixel centre where their plane lies
    below their vertex depth zmin by more than the reference's 2⁻²²
    quantum, and win it in front of an occluder between the two: a skip
    on the vertex bound would lose them there, the port's bound does
    not."""
    rows, boxes, zmin, pix, zs = raster_cases.steep_triangles()
    assert (zs < zmin - 2.0 ** -21).all()
    case = raster_cases.bound_case("cpu")
    occ = raster_cases.occlusion_case(case)
    vis = rc.rasterize_plain(case.setup, case.bbox, case.bins, case.width,
                             case.height)
    steep0 = CHUNK_SIZE       # the slivers fill the second chunk
    for k, (px, py) in enumerate(pix):
        assert int(vis.tri[py, px]) == steep0 + k
        assert float(occ.bins.bound[1]) <= float(zs[k]) < float(zmin[k])
    r = occ_replay.replay(case.setup, case.bbox, occ.bins, case.width,
                          case.height)
    assert torch.equal(r.tid, vis.tri) and torch.equal(r.z, vis.z)


def _replay_equals_plain(setup, bbox, bins, width, height):
    """K2, K2w (the pixels' winners and depth) and K3 under the replayed
    rule against the plain rasters; returns the share of evaluations the
    rule spares (non-wireframe)."""
    share = None
    for wire in (None, raster_cases.WIRE_THRESH):
        on = occ_replay.replay(setup, bbox, bins, width, height, wire)
        off = occ_replay.replay(setup, bbox, bins._replace(bound=None),
                                width, height, wire, raster=False).counts
        vis = rc.rasterize_plain(setup, bbox, bins, width, height,
                                 wire is not None, wire or 0.7)
        rec = torch.zeros((setup.shape[0], 76))
        rec[:, :16] = setup
        pix = rc.rasterize_pixels_plain(rec, setup, bbox, bins, width,
                                        height, wire is not None,
                                        wire or 0.7)
        assert torch.equal(on.tid, vis.tri) and torch.equal(on.z, vis.z)
        assert torch.equal(on.tid, pix.tid) and torch.equal(on.z, pix.z)
        assert on.counts["visits"] <= off["visits"]
        if wire is None:
            share = occ_replay.skipped_share(on.counts, off)
    return share


def test_replayed_skips_leave_the_rasters_exact(geometry, layered):
    """A plain raster that skips what the replayed rule skips equals the
    plain raster without skips (depth, pixels, wireframe, visibility), and
    the rule spares over 30% of the evaluations on the two-layer case and
    the layered scene."""
    st, _, bins = _grid(geometry, "camera")
    _replay_equals_plain(st.setup, st.bbox, bins, W, H)
    sh, _, sbins = _grid(geometry, "shadow")
    k1 = occ_replay.replay(sh.setup, sh.bbox, sbins, D, D, depth_only=True)
    assert torch.equal(k1.z, rc.rasterize_depth_plain(sh.setup, sh.bbox,
                                                      sbins, D))
    g = layered[3]
    share = _replay_equals_plain(g.setup.setup, g.setup.bbox, g.bins, 256,
                                 128)
    assert share > 0.3, share
    two = raster_cases.occlusion_case(raster_cases.two_layer_case("cpu"))
    share = _replay_equals_plain(two.setup, two.bbox, two.bins, two.width,
                                 two.height)
    assert share > 0.3, share


@pytest.mark.parametrize("square", [False, True])
def test_replay_exact_on_every_raster_case(square):
    """Every case of ops/raster_cases.py, binned nearest first and with
    its own (id-ordered) bins and bounds: the replayed rule's raster is
    the plain one (K1 on the square cases, K2/K2w/K3 on the others)."""
    for case in raster_cases.adversarial_cases("cpu", cap=4, square=square):
        occ = raster_cases.occlusion_case(case, cap=4)
        for bins in (occ.bins, case.bins._replace(bound=occ.bins.bound)):
            if square:
                r = occ_replay.replay(case.setup, case.bbox, bins,
                                      case.width, case.width,
                                      depth_only=True)
                assert torch.equal(r.z, rc.rasterize_depth_plain(
                    case.setup, case.bbox, bins, case.width)), case.name
            else:
                _replay_equals_plain(case.setup, case.bbox, bins,
                                     case.width, case.height)


def test_simulate_tile_sums_to_the_replay(layered):
    """``simulate_tile`` replays one tile: the tiles' counts add up to the
    whole grid's replay, with the skip and without."""
    g = layered[3]
    st = g.setup
    for bins in (g.bins, g.bins._replace(bound=None)):
        whole = occ_replay.replay(st.setup, st.bbox, bins, 256, 128,
                                  raster=False).counts
        total = dict.fromkeys(rc.OCC_COUNTS, 0)
        for t in range(bins.tiles_x * bins.tiles_y):
            for k, v in occ_replay.simulate_tile(st.setup, st.bbox, bins, t,
                                                 256, 128).items():
                total[k] += v
        assert total == whole and whole["visits"] > 0
