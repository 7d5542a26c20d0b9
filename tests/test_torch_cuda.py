"""The port's CUDA kernels (K1, K2, K2w, K3 and the forward shading
kernel) against their plain PyTorch versions, and the interactive loop's
launch counts, on the card.

These tests need an NVIDIA GPU and skip elsewhere.  The GPU machine has no
JAX, so run them without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel and plain version evaluate every plane in the same
order without fused multiply-adds, so depth maps, coverage, winners,
barycentrics and interpolated outputs must be bit-equal (``torch.equal``)
for every kernel, with the occlusion skip on and off.  The kernels' own
occlusion counts equal ops/occ_replay's for K2, K2w and K3; K1's blocks
also read the map other blocks lower, so it skips at least as much.  The loop's steady-state frame (cached PCF table) must
equal ``render_frame`` with a fresh map, bit for bit.  The shading kernel
sums the texture's and the PCF's non-zero lane terms in another order than
the plain chain's reductions, so on its u8 surface no value may be more
than one level off and at most 0.1% of values off at all, pixels with no
coverage bit-equal; on the float16 surface the same at 255 times its
values.
"""

import os

import numpy as np
import pytest
import torch

from kanirenderer_tpu_torch.core.types import (CHUNK_SIZE, RenderConfig,
                                               RenderMode, camera_state,
                                               default_lights, frame_state,
                                               spawn_point_lights)
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import occ_replay, raster_cases, shade_cuda
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops.binning import bin_tiles, depth_bound
from kanirenderer_tpu_torch.ops.interpolate import FAT_LANES
from kanirenderer_tpu_torch.ops.sampling import build_shadow_table
from kanirenderer_tpu_torch.ops.vertex import triangle_setup_corners
from kanirenderer_tpu_torch.passes.frame import (band_bins, band_pixels,
                                                 frame_geometry)

pytestmark = pytest.mark.cuda


def _geometry(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32, device=dev)
    state = frame_state(scene, camera_state([-900.0, 180.0, 0.0], 0.0,
                                            np.deg2rad(-5.0), dev),
                        default_lights(device=dev))
    cfg = RenderConfig(width=256, height=192, shadow_dim=256, mode=mode)
    return frame_geometry(scene, state, cfg), cfg


@pytest.fixture(scope="module")
def geometry():
    return _geometry(RenderMode.LIT_SHADOW)


@pytest.fixture(scope="module")
def wire_geometry():
    """WIREFRAME geometry: the camera setup does not cull."""
    return _geometry(RenderMode.WIREFRAME)


def _assert_pixels_equal(k, p):
    for f in ("tid", "mask", "z", "varyings", "mat_id", "tex_w", "tex_h",
              "blk_base", "blk_w"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f


def test_depth_kernel_matches_plain(geometry):
    g, cfg = geometry
    st = g.shadow_setup
    before = rc.launch_counts["rasterize_depth"]
    k = rc.rasterize_depth(st.setup, st.bbox, g.shadow_bins, cfg.shadow_dim)
    assert rc.launch_counts["rasterize_depth"] == before + 1
    p = rc.rasterize_depth_plain(st.setup, st.bbox, g.shadow_bins,
                                 cfg.shadow_dim)
    torch.cuda.synchronize()
    assert (k < 1.0).any()
    assert torch.equal(k, p)


def test_pixels_kernel_matches_plain(geometry):
    g, cfg = geometry
    W, H = cfg.width, cfg.height
    st = g.setup
    before = rc.launch_counts["rasterize_pixels"]
    k = rc.rasterize_pixels(g.records, st.setup, st.bbox, g.bins, W, H)
    assert rc.launch_counts["rasterize_pixels"] == before + 1
    p = rc.rasterize_pixels_plain(g.records, st.setup, st.bbox, g.bins, W, H)
    torch.cuda.synchronize()
    assert k.mask.float().mean().item() > 0.5
    _assert_pixels_equal(k, p)


def test_wireframe_kernel_matches_plain(wire_geometry):
    g, cfg = wire_geometry
    W, H = cfg.width, cfg.height
    before = rc.launch_counts["rasterize_pixels_wireframe"]
    k = rc.rasterize_pixels(g.records, g.setup.setup, g.setup.bbox, g.bins,
                            W, H, wireframe=True)
    assert rc.launch_counts["rasterize_pixels_wireframe"] == before + 1
    p = rc.rasterize_pixels_plain(g.records, g.setup.setup, g.setup.bbox,
                                  g.bins, W, H, wireframe=True)
    torch.cuda.synchronize()
    assert 0.2 < k.mask.float().mean().item() < 0.8
    _assert_pixels_equal(k, p)


@pytest.mark.parametrize("wireframe", [False, True])
def test_visibility_kernel_matches_plain(geometry, wire_geometry, wireframe):
    g, cfg = wire_geometry if wireframe else geometry
    W, H = cfg.width, cfg.height
    st = g.setup
    before = rc.launch_counts["rasterize_visibility"]
    k = rc.rasterize(st.setup, st.bbox, g.bins, W, H, wireframe)
    assert rc.launch_counts["rasterize_visibility"] == before + 1
    p = rc.rasterize_plain(st.setup, st.bbox, g.bins, W, H, wireframe)
    torch.cuda.synchronize()
    assert (k.tri >= 0).any()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_wrapper_rejects_what_the_kernel_does_not_take(geometry):
    g, cfg = geometry
    st = g.shadow_setup
    with pytest.raises(ValueError):
        rc.rasterize_depth(st.setup.double(), st.bbox, g.shadow_bins,
                           cfg.shadow_dim)
    with pytest.raises(ValueError):
        rc.rasterize_pixels(g.records[:, :16].contiguous(), g.setup.setup,
                            g.setup.bbox, g.bins, cfg.width, cfg.height)
    with pytest.raises(ValueError):
        rc.rasterize_pixels(g.records, g.records, g.setup.bbox, g.bins,
                            cfg.width, cfg.height)
    with pytest.raises(ValueError):
        rc.rasterize(g.records, g.setup.bbox, g.bins, cfg.width, cfg.height)


@pytest.mark.parametrize("seed,tile_w,tile_h", [
    (0, 16, 16), (1, 16, 16), (2, 8, 16), (3, 32, 32), (4, 12, 16),
    (5, 32, 4)])
def test_kernels_match_plain_on_random_triangles(geometry, seed, tile_w,
                                                 tile_h):
    """Random clip-space triangles (near-plane crossers, slivers, large
    ones) through the kernels and their plain versions: bit-equal, for
    blocks of 128 to 1024 threads and for tiles that do and do not divide
    into the warps' 8×4 patches."""
    dev = geometry[0].records.device
    rng = np.random.RandomState(seed)
    T = 4 * CHUNK_SIZE
    w = rng.uniform(0.2, 2.0, (3, 1, T))
    w[0, 0, rng.rand(T) < 0.03] = -0.2
    centre = rng.uniform(-1.0, 1.0, (1, 2, T))
    size = rng.choice([0.05, 0.3, 1.5], (1, 1, T), p=[0.7, 0.28, 0.02])
    xy = (centre + size * rng.uniform(-1, 1, (3, 2, T))) * np.abs(w)
    z = rng.uniform(-0.1, 1.1, (3, 1, T)) * np.abs(w)
    clip = torch.from_numpy(np.concatenate([xy, z, w], 1).astype(
        np.float32)).to(dev)
    valid = torch.from_numpy(rng.rand(T) > 0.05).to(dev)
    W, H = 200, 120
    st, planes = triangle_setup_corners(clip, valid, W, H, False)
    records = torch.zeros((T, FAT_LANES), device=dev)
    records[:, :16] = planes.T
    records[:, 16:67] = torch.from_numpy(
        rng.standard_normal((T, 51)).astype(np.float32)).to(dev)
    records[:, 67:73] = torch.from_numpy(
        rng.randint(0, 30000, (T, 6)).astype(np.float32)).to(dev)
    records[:, 73:76] = (planes[0:3] + planes[3:6] + planes[6:9]).T
    bins = bin_tiles(st.bbox, W, H, tile_w, tile_h, cap=640)
    k = rc.rasterize_pixels(records, st.setup, st.bbox, bins, W, H)
    p = rc.rasterize_pixels_plain(records, st.setup, st.bbox, bins, W, H)
    torch.cuda.synchronize()
    assert 0.2 < k.mask.float().mean().item() < 1.0
    _assert_pixels_equal(k, p)
    for wire in (False, True):
        _assert_pixels_equal(
            rc.rasterize_pixels(records, st.setup, st.bbox, bins, W, H,
                                wire, 1.5),
            rc.rasterize_pixels_plain(records, st.setup, st.bbox, bins, W,
                                      H, wire, 1.5))
        for a, b in zip(rc.rasterize(st.setup, st.bbox, bins, W, H, wire),
                        rc.rasterize_plain(st.setup, st.bbox, bins, W, H,
                                           wire)):
            assert torch.equal(a, b)
    sq, _ = triangle_setup_corners(clip, valid, 128, 128, False)
    sbins = bin_tiles(sq.bbox, 128, 128, tile_w, tile_h, cap=640)
    assert torch.equal(rc.rasterize_depth(sq.setup, sq.bbox, sbins, 128),
                       rc.rasterize_depth_plain(sq.setup, sq.bbox, sbins,
                                                128))


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_kernels_match_plain_on_adversarial_cases(geometry, which):
    """Hit-list overflow, tiles at the 640-chunk cap with counted overflow,
    empty tiles, depth ties across chunks, a ragged raster, NaN planes,
    wireframe interiors and infinite or overflowing plane coefficients
    (ops/raster_cases.py): K2, K2w, K3 with and without wireframe and K1
    against their plain versions, bit-equal, at a threshold that an edge
    distance of the band cases equals (1.5) and at the cases' own."""
    dev = geometry[0].records.device
    case = raster_cases.adversarial_cases(dev)[which]
    assert int(case.bins.overflow) == (0, 20, 0, 0)[which]
    assert int(case.bins.count.max()) == (24, 640, 1, 1)[which]
    for wire, thresh in ((False, 0.7), (True, 1.5),
                         (True, raster_cases.WIRE_THRESH)):
        args = (case.setup, case.bbox, case.bins, case.width, case.height,
                wire, thresh)
        k = rc.rasterize_pixels(case.records, *args)
        p = rc.rasterize_pixels_plain(case.records, *args)
        torch.cuda.synchronize()
        assert 0.05 < k.mask.float().mean().item() < 1.0
        _assert_pixels_equal(k, p)
        tid = k.tid[k.mask].to(torch.int64)
        assert case.kept[tid].all() and not case.setup[tid].isnan().any()
        k3, p3 = rc.rasterize(*args), rc.rasterize_plain(*args)
        for f, a, b in zip(k3._fields, k3, p3):
            assert torch.equal(a, b), f
        assert torch.equal(k3.tri, k.tid)
    sq = raster_cases.adversarial_cases(dev, square=True)[which]
    k1 = rc.rasterize_depth(sq.setup, sq.bbox, sq.bins, sq.width)
    p1 = rc.rasterize_depth_plain(sq.setup, sq.bbox, sq.bins, sq.width)
    torch.cuda.synchronize()
    assert (k1 < 1.0).any() and (k1 == 1.0).any()
    assert torch.equal(k1, p1)


def _occ_counts(fn):
    """The kernel's occlusion counts of one call ``fn(counts=...)``."""
    counts = torch.zeros(len(rc.OCC_COUNTS), dtype=torch.int64,
                         device="cuda")
    out = fn(counts=counts)
    torch.cuda.synchronize()
    return out, dict(zip(rc.OCC_COUNTS, counts.tolist()))


def _check_skip(setup, bbox, bins, width, height, records=None,
                depth=False):
    """K1 (``depth``) or K2, K2w and K3 with the skip (``bins.bound``) and
    without against the plain versions, bit-equal, and their counts
    against the replay's; returns the share of K2's warp visits spared."""
    off_bins = bins._replace(bound=None)
    if depth:
        on, c_on = _occ_counts(lambda counts: rc.rasterize_depth(
            setup, bbox, bins, width, counts=counts))
        off = rc.rasterize_depth(setup, bbox, off_bins, width)
        plain = rc.rasterize_depth_plain(setup, bbox, bins, width)
        torch.cuda.synchronize()
        assert torch.equal(on, off) and torch.equal(on, plain)
        r = occ_replay.replay(setup, bbox, bins, width, width,
                              depth_only=True)
        assert torch.equal(r.z, plain)
        assert c_on["chunks_tested"] == r.counts["chunks_tested"]
        assert c_on["chunks_skipped"] >= r.counts["chunks_skipped"]
        assert c_on["visits"] <= r.counts["visits"]
        return None
    if records is None:
        records = torch.zeros((setup.shape[0], FAT_LANES), device="cuda")
        records[:, :16] = setup
    share = None
    for wire, thresh in ((False, 0.7), (True, raster_cases.WIRE_THRESH)):
        args = (setup, bbox, bins, width, height, wire, thresh)
        off_args = (setup, bbox, off_bins, width, height, wire, thresh)
        k, c_on = _occ_counts(lambda counts: rc.rasterize_pixels(
            records, *args, counts=counts))
        k_off, c_off = _occ_counts(lambda counts: rc.rasterize_pixels(
            records, *off_args, counts=counts))
        p = rc.rasterize_pixels_plain(records, *args)
        torch.cuda.synchronize()
        _assert_pixels_equal(k, p)
        _assert_pixels_equal(k_off, p)
        v, c3 = _occ_counts(lambda counts: rc.rasterize(*args,
                                                        counts=counts))
        v_off = rc.rasterize(*off_args)
        vp = rc.rasterize_plain(*args)
        for f, a, b, c in zip(vp._fields, v, v_off, vp):
            assert torch.equal(a, c) and torch.equal(b, c), f
        r = occ_replay.replay(setup, bbox, bins, width, height,
                              thresh if wire else None, raster=False)
        assert c_on == c3 == r.counts, (c_on, c3, r.counts)
        assert c_off["visits"] >= c_on["visits"]
        if not wire:
            share = occ_replay.skipped_share(c_on, c_off)
    return share


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4, 5])
def test_occlusion_skip_on_adversarial_cases(geometry, which):
    """Every case of ops/raster_cases.py with the skip, binned nearest
    first and with its own id-ordered bins: outputs bit-equal to the skip
    off and to the plain versions, counts equal to the replay's; the
    two-layer case spares over 30% of K2's evaluations."""
    dev = geometry[0].records.device
    case = raster_cases.adversarial_cases(dev)[which]
    occ = raster_cases.occlusion_case(case)
    shares = [_check_skip(c.setup, c.bbox, bins, c.width, c.height,
                          c.records)
              for c, bins in ((occ, occ.bins), (case, case.bins._replace(
                  bound=occ.bins.bound)))]
    if which == 4:
        assert shares[0] > 0.3, shares
    sq = raster_cases.occlusion_case(
        raster_cases.adversarial_cases(dev, square=True)[which])
    _check_skip(sq.setup, sq.bbox, sq.bins, sq.width, sq.width, depth=True)


def test_occlusion_skip_on_the_frame_grids(geometry):
    """The bench-like fixture with scope "1": K1 on the shadow grid, K2,
    K2w and K3 on the main grid, skip on against off and plain."""
    g, cfg = geometry
    st, sh = g.setup, g.shadow_setup
    assert g.shadow_bins.bound is not None     # the default scope
    _check_skip(sh.setup, sh.bbox, g.shadow_bins, cfg.shadow_dim,
                cfg.shadow_dim, depth=True)
    bins = bin_tiles(st.bbox, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile,
                     occ_bound=depth_bound(st.setup, st.bbox, cfg.tile_w,
                                           cfg.tile_h))
    _check_skip(st.setup, st.bbox, bins, cfg.width, cfg.height, g.records)


@pytest.mark.parametrize("n,interleave", [(8, False), (5, True)])
def test_band_kernels_match_plain(geometry, wire_geometry, n, interleave):
    """K2 and K2w on every row band (contiguous: 24 rows on 16-row tiles,
    binned on the band's own grid; interleaved: 3 tile rows of the full
    grid's bins, the last band's last row padding), bit-equal to their
    plain versions and to the whole frame's rows; each call counted as a
    band launch."""
    from kanirenderer_tpu_torch.ops.binning import interleave_bins
    from kanirenderer_tpu_torch.parallel.mesh import deinterleave_rows
    for g, cfg in (geometry, wire_geometry):
        W, H = cfg.width, cfg.height
        wire = cfg.mode == RenderMode.WIREFRAME
        st = g.setup
        whole = rc.rasterize_pixels(g.records, st.setup, st.bbox, g.bins, W,
                                    H, wire)
        tiles = -(-H // cfg.tile_h)
        band_h = -(-tiles // n) * cfg.tile_h if interleave else H // n
        bands = []
        for k in range(n):
            y0 = k * cfg.tile_h if interleave else k * band_h
            bins = interleave_bins(g.bins, k, n) if interleave else \
                bin_tiles(st.bbox, W, band_h, cfg.tile_w, cfg.tile_h,
                          cfg.max_chunks_per_tile, y0=y0)
            args = (g.records, st.setup, st.bbox, bins, W, H, wire, 0.7, y0,
                    n if interleave else 1, band_h)
            name = "rasterize_pixels_wireframe_band" if wire \
                else "rasterize_pixels_band"
            before = rc.launch_counts[name]
            k2 = rc.rasterize_pixels(*args)
            assert rc.launch_counts[name] == before + 1
            _assert_pixels_equal(k2, rc.rasterize_pixels_plain(*args))
            bands.append(k2)
        torch.cuda.synchronize()
        for f in ("tid", "z", "varyings"):
            got = torch.cat([getattr(b, f) for b in bands], -2)
            if interleave:
                got = deinterleave_rows(got.movedim(-2, 0), n, cfg.tile_h,
                                        H).movedim(0, -2)
            assert torch.equal(got, getattr(whole, f)), f


def test_depth_band_kernel_matches_plain(geometry):
    """K1 on map bands that do and do not start and end on tile rows,
    from the whole map's bins: bit-equal to the plain version and to the
    whole map's rows."""
    g, cfg = geometry
    st, D = g.shadow_setup, cfg.shadow_dim
    whole = rc.rasterize_depth(st.setup, st.bbox, g.shadow_bins, D)
    for y0, band_h in ((0, 40), (40, 100), (140, 116), (64, 64)):
        before = rc.launch_counts["rasterize_depth_band"]
        k1 = rc.rasterize_depth(st.setup, st.bbox, g.shadow_bins, D, y0,
                                band_h)
        assert rc.launch_counts["rasterize_depth_band"] == before + 1
        p1 = rc.rasterize_depth_plain(st.setup, st.bbox, g.shadow_bins, D,
                                      y0, band_h)
        torch.cuda.synchronize()
        assert torch.equal(k1, p1)
        assert torch.equal(k1, whole[y0:y0 + band_h])
    assert (whole < 1.0).any()


def test_dryrun_multichip_on_the_card():
    """``parallel.dryrun_multichip(2)``: the tiny banded frames (NCCL ranks
    where there are two cards, else the bands looped on card 0), each
    equal to the whole frame; the frames come back on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from kanirenderer_tpu_torch.parallel import dryrun_multichip
    frames = dryrun_multichip(2)
    image = frames["full"][0]
    assert image.shape == (32, 128, 3) and image.float().std() > 10.0


def _loop_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return sponza_standin_scene(target_tris=6000, num_materials=4,
                                tex_size=32, device=torch.device("cuda", 0))


class _Capture:
    def __init__(self):
        self.frames = []

    def present(self, frame):
        self.frames.append(frame.copy())

    def close(self):
        pass


@pytest.mark.parametrize("cache", [True, False])
def test_loop_launch_counts(cache):
    """Steady state: K2 and the shading kernel once per frame and K1 once
    in the run; with cache_shadow_map=False K1 once per frame too; Tab to
    WIREFRAME launches K2w and not the shading kernel."""
    from kanirenderer_tpu_torch.runtime.loop import Events, run_loop
    scene = _loop_scene()
    cfg = RenderConfig(width=256, height=192, shadow_dim=256,
                       cache_shadow_map=cache)
    rc.reset_launch_counts()
    events = [Events()] * 5 + [Events(pressed=frozenset(["tab"]))]
    stats = run_loop(scene, events, config=cfg, sink_kind="null")
    torch.cuda.synchronize()
    assert stats["frames"] == 6 and stats["healed"] == 0
    assert rc.launch_counts == {
        "rasterize_depth": 1 if cache else 5, "rasterize_pixels": 5,
        "rasterize_pixels_wireframe": 1, "rasterize_visibility": 0,
        "rasterize_depth_band": 0, "rasterize_pixels_band": 0,
        "rasterize_pixels_wireframe_band": 0, "shade_forward": 5}


def test_loop_steady_state_equals_fresh_frame():
    from kanirenderer_tpu_torch.core.types import default_camera
    from kanirenderer_tpu_torch.passes.frame import render_frame
    from kanirenderer_tpu_torch.runtime.loop import Events, run_loop
    scene = _loop_scene()
    dev = scene.device
    cfg = RenderConfig(width=256, height=192, shadow_dim=256, output_u8=True)
    sink = _Capture()
    run_loop(scene, [Events()] * 4, config=cfg, sink=sink)
    state = frame_state(scene, default_camera(device=dev),
                        default_lights(device=dev))
    fresh = render_frame(scene, state, cfg.with_(cache_shadow_map=False))
    want = fresh.image.cpu().numpy()
    assert want.std() > 5.0
    for frame in sink.frames[1:]:
        np.testing.assert_array_equal(frame, want)
    # a resized view: the presented crop against the exact-size frame
    sink = _Capture()
    stats = run_loop(scene, [Events(), Events(resize=(200, 150))],
                     config=cfg, sink=sink)
    assert stats["render_size"] == (256, 256)
    assert sink.frames[1].shape == (150, 200, 3)


def test_run_kanirenderer_on_the_card(tmp_path, monkeypatch):
    """The C ABI's run_kanirenderer through ctypes.PyDLL in this process,
    on a small written OBJ: api.run on the card, K2 once per frame and K1
    once (the cached shadow table)."""
    import ctypes
    import chip_smoke
    from kanirenderer_tpu_torch.io import native
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    path = chip_smoke.write_standin_obj(str(tmp_path), target_tris=6000,
                                        num_materials=4, tex_size=32)
    for k, v in dict(KANI_WIDTH="256", KANI_HEIGHT="192", KANI_FRAMES="4",
                     KANI_SINK="null", KANI_EMBED="in-process").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("KANI_DEVICE", raising=False)
    lib = ctypes.PyDLL(native.library_path())
    lib.run_kanirenderer.argtypes = [ctypes.c_char_p] * 3 + [ctypes.c_int]
    rc.reset_launch_counts()
    try:
        code = lib.run_kanirenderer(path.encode(), b"opengl", b"windowed", 0)
    finally:
        for k in [k for k in os.environ if k.startswith("KANI_ARG_")]:
            del os.environ[k]
    torch.cuda.synchronize()
    assert code == 0
    assert rc.launch_counts["rasterize_pixels"] == 4
    assert rc.launch_counts["rasterize_depth"] == 1
    assert rc.launch_counts["shade_forward"] == 4


@pytest.fixture(scope="module", params=["loop", "bench"])
def shade_inputs(request):
    """The small loop scene at 256x192 and the full-size stand-in at the
    bench pose at 1920x1080: (scene, state, geometry, PCF table,
    LIT_SHADOW config with the u8 surface)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from kanirenderer_tpu_torch import flythrough
    dev = torch.device("cuda", 0)
    if request.param == "loop":
        scene = _loop_scene()
        cam = camera_state([-900.0, 180.0, 0.0], 0.0, np.deg2rad(-5.0), dev)
        cfg = RenderConfig(width=256, height=192, shadow_dim=256,
                           output_u8=True)
    else:
        scene = sponza_standin_scene(device=dev)
        c0 = flythrough.BENCH_CAM0
        cam = camera_state(c0.position, c0.yaw, c0.pitch, dev)
        cfg = flythrough.BENCH_CONFIG
    state = frame_state(scene, cam, default_lights(device=dev))
    g = frame_geometry(scene, state, cfg)
    sh = g.shadow_setup
    table = build_shadow_table(rc.rasterize_depth(sh.setup, sh.bbox,
                                                  g.shadow_bins,
                                                  cfg.shadow_dim))
    return scene, state, g, table, cfg


def _edge_cases(pix):
    """u, v far outside [0, 1] (Repeat wrap), world positions whose shadow
    coordinates fall outside the map (clamp), and every seventh row
    uncovered."""
    vary = pix.varyings.clone()
    vary[15] = vary[15] * 3.0 - 1.3
    vary[16] = vary[16] * -2.0 + 0.7
    half = vary.shape[2] // 2
    vary[12, :, :half] += 4000.0
    vary[14, :, half:] -= 4000.0
    mask = pix.mask.clone()
    mask[::7] = False
    return pix._replace(varyings=vary, mask=mask)


def _check_surface(got, want, mask):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = 255.0 if got.dtype == torch.float16 else 1.0
    diff = (got.double() - want.double()).abs() * scale
    off = (diff > 0).double().mean().item()
    assert diff.max().item() <= 1.0, diff.max().item()
    assert off <= 1e-3, off
    assert torch.equal(got[~mask], want[~mask])
    return off


@pytest.mark.parametrize("hdr", [False, True])
@pytest.mark.parametrize("mode", [RenderMode.LIT, RenderMode.LIT_SHADOW])
def test_shade_kernel_matches_plain(shade_inputs, mode, hdr):
    """shade_surface against band_shade -> band_surface on the same
    PixelBuffer: one band and 3 contiguous bands, the default rig and 150
    spawned point lights, the edge cases of ``_edge_cases``."""
    scene, state, g, table, cfg = shade_inputs
    cfg = cfg.with_(mode=mode, hdr=hdr)
    tbl = table if mode == RenderMode.LIT_SHADOW else None
    dev = scene.device
    spawned = state._replace(lights=state.lights._replace(
        points=spawn_point_lights(50, device=dev)))
    assert spawned.lights.points.range.numel() == 150
    for n in (1, 3):
        band_h = cfg.height // n
        for k in range(n):
            y0 = k * band_h
            pix = band_pixels(g, cfg, band_bins(g, cfg, y0, band_h), y0,
                              band_h)
            assert pix.mask.any()
            for st, p in ((state, pix), (spawned, _edge_cases(pix))):
                before = rc.launch_counts["shade_forward"]
                got = shade_cuda.shade_surface(scene, st, cfg, p, tbl,
                                               g.light_vp)
                assert rc.launch_counts["shade_forward"] == before + 1
                want = shade_cuda.shade_surface_plain(scene, st, cfg, p, tbl,
                                                      g.light_vp)
                torch.cuda.synchronize()
                _check_surface(got, want, p.mask)
                scale = 255.0 if hdr else 1.0
                assert got.float().std().item() * scale > 0.1


def test_shade_wrapper_rejects_what_the_kernel_does_not_take(shade_inputs):
    scene, state, g, table, cfg = shade_inputs
    pix = band_pixels(g, cfg, g.bins, 0, cfg.height)
    for bad in (cfg.with_(mode=RenderMode.UNLIT), cfg.with_(deferred=True),
                cfg.with_(present_scale=2), cfg.with_(output_u8=False)):
        with pytest.raises(ValueError):
            shade_cuda.shade_surface(scene, state, bad, pix, table,
                                     g.light_vp)
    with pytest.raises(ValueError):   # LIT_SHADOW without its table
        shade_cuda.shade_surface(scene, state, cfg, pix, None, g.light_vp)
    with pytest.raises(ValueError):   # a table of another map size
        shade_cuda.shade_surface(scene, state, cfg, pix, table[:-1],
                                 g.light_vp)
    with pytest.raises(ValueError):
        shade_cuda.shade_surface(scene, state, cfg, pix._replace(
            varyings=pix.varyings[:16]), table, g.light_vp)
