"""Ablation timing of the raster kernels K1, K2, K2w and K3 on one GPU.

    python -m kanirenderer_tpu_torch.ops.raster_ablation [WORD ...]

Times the kernels as built from ``csrc/`` at the bench shapes (sponza
stand-in, bench pose, 2048² shadow map, 1920×1080; K3's wireframe variant
also on a few screen-sized triangles; K1 with the occlusion skip of the
default scope, as the frame runs it), then again from
temporary copies of ``csrc/`` in which one design element is taken out or
one constant changed by a textual edit, so that the share of each element
in the kernels' time can be read off.  A copy that no longer computes the
kernel's function is marked ``exact=False`` against the plain version;
its time is what the measurement is for.  An edit whose pattern is no
longer in the sources raises, so the list is kept in step with them.
With words on the command line, only the edits whose name holds one of
them are built.  With the word ``break-even`` alone it measures the
occlusion skip's break-even instead (``occ_break_even``).
Times are device times: 20 calls of the wrapper captured into a CUDA graph
and replayed between two events, so the host's work per call (about 0.04
ms, which an eager loop reads once a kernel is faster than that) is not in
them.  Nothing here is used by the renderer.
"""

from __future__ import annotations

import contextlib
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from kanirenderer_tpu_torch import flythrough
from kanirenderer_tpu_torch.core.types import (camera_state, default_lights,
                                               frame_state)
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import raster_cases
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.passes.frame import frame_geometry

# The occlusion skip's machinery with its tests made never to fire (depths
# lie in [0, 1]): what it costs where it skips nothing (occ_break_even).
OCC_NEVER_FIRES = "occlusion machinery, its tests never fire"

# (name, [(file, text, replacement), ...])
EDITS = [
    ("no per-warp rejection: every bbox hit is evaluated",
     [("raster_common.cuh", "lane < n && may_cover(tri[lane], rect)",
       "lane < n")]),
    ("warps take 32 pixels in raster order, not 8x4 patches",
     [("raster_common.cuh", "if ((tile_w & 7) == 0 && (tile_h & 3) == 0) {",
       "if (tile_w < 0) {")]),
    ("K1 without plane evaluation",
     [("raster_depth.cu",
       "if (kani::covers(t, X, Y, &z)) acc = fminf(acc, z);",
       "acc = fminf(acc, t.p2.w + 2.0f);")]),
    ("K1 cull only: no staging, no evaluation",
     [("raster_depth.cu", "kani::visit_hits<false, true, kCount>(",
       "if (s.count < 0) kani::visit_hits<false, true, kCount>("),
      ("raster_depth.cu", "kani::visit_hits<false, false, kCount>(",
       "if (s.count < 0) kani::visit_hits<false, false, kCount>(")]),
    ("K1 blocks load their slice and leave",
     [("raster_depth.cu", "if (tile >= 0) {",
       "if (tile >= 0 && entries < 0) {")]),
    ("K1 slices of 4 entries",
     [("raster_depth.cu", "kSlice = 8;", "kSlice = 4;")]),
    ("K1 slices of 16 entries",
     [("raster_depth.cu", "kSlice = 8;", "kSlice = 16;")]),
    ("K2, K2w, K3 without phase 1: K2's phase 2 writes the background",
     [("raster_common.cuh",
       "for (int i0 = 0; i0 < n; i0 += kRound) {",
       "for (int i0 = 0; i0 < n && n < 0; i0 += kRound) {")]),
    ("occlusion without the per-warp depth test (chunks still skipped)",
     [("raster_common.cuh",
       "keep = keep && !(depth_min(tri[lane], rect) > cut);", "")]),
    (OCC_NEVER_FIRES, [
        ("raster_common.cuh", "const bool skip = lane < n && cbound > zmax;",
         "const bool skip = lane < n && cbound > zmax + 4.f;"),
        ("raster_common.cuh",
         "keep = keep && !(depth_min(tri[lane], rect) > cut);",
         "keep = keep && !(depth_min(tri[lane], rect) > cut + 4.f);")]),
    ("K2 phase 1 only: pixels with a winner write their depth and stop",
     [("raster_pixels.cu", "  if (!any_won) {\n",
       "  if (won) return;\n  if (true) {\n")]),
    ("K2 phase 2 with two paths in a warp: the lanes without a winner "
     "store their defaults apart",
     [("raster_pixels.cu", "  if (!any_won) {\n", "  if (!won) {\n")]),
    ("K2 at four blocks per SM (64 registers)",
     [("raster_pixels.cu", "kBlocksK2 = 6", "kBlocksK2 = 4")]),
    ("K2 at five blocks per SM (48 registers)",
     [("raster_pixels.cu", "kBlocksK2 = 6", "kBlocksK2 = 5")]),
    ("K2w at four blocks per SM (64 registers)",
     [("raster_pixels.cu", "kBlocksK2w = 5", "kBlocksK2w = 4")]),
    ("K2w at six blocks per SM (40 registers)",
     [("raster_pixels.cu", "kBlocksK2w = 5", "kBlocksK2w = 6")]),
    ("K3 and K3w at four blocks per SM (64 registers)",
     [("raster_visibility.cu", "kBlocks = 6", "kBlocks = 4")]),
    ("K3 and K3w at eight blocks per SM (32 registers)",
     [("raster_visibility.cu", "kBlocks = 6", "kBlocks = 8")]),
    ("wireframe without the threshold rejection",
     [("raster_common.cuh", "keep = may_pass(tri[lane], g, rect, thresh);",
       "keep = true;")]),
    ("wireframe with g per evaluation: three 1/sqrt in every thread",
     [("raster_common.cuh", "t.p0.z, g.g0, X, Y)",
       "t.p0.z, edge_scale(t.p0.x, t.p0.y), X, Y)"),
      ("raster_common.cuh", "t.p1.y, g.g1, X, Y)",
       "t.p1.y, edge_scale(t.p0.w, t.p1.x), X, Y)"),
      ("raster_common.cuh", "t.p2.x, g.g2, X, Y)",
       "t.p2.x, edge_scale(t.p1.z, t.p1.w), X, Y)")]),
    ("wireframe with g = 1: no sqrt, no division (far fewer pixels pass "
     "the threshold, so K2w's phase 2 shrinks too)",
     [("raster_common.cuh", "return __fdiv_rn(1.f, __fsqrt_rn(n2));",
       "return n2 > 0.f ? 1.0f : 0.f;")]),
]


def patch_survivors(rows, bbox, tile, chunk, bins, wire_thresh=None):
    """The kernels' per-warp rejection in plain PyTorch, for the (tile,
    chunk) pairs given: (hit (P, 128), keep (P, 128, patches)), the
    triangles of each pair's chunk whose bbox meets its tile, and those of
    them a warp with 8x4 patch number ``patch`` (row-major in the tile)
    goes on to evaluate after raster_common.cuh's may_cover and, with
    ``wire_thresh``, may_pass.  Needs tiles that divide into 8x4 patches."""
    tw, th = bins.tile_w, bins.tile_h
    dev = rows.device
    tri, hit = rc._bbox_hits(bbox, tile, chunk, bins)
    r = rows[:, :12][tri][:, :, None]                      # (P, 128, 1, 12)
    tx0 = (tile % bins.tiles_x * tw).to(torch.float32)[:, None]
    ty0 = (tile // bins.tiles_x * th).to(torch.float32)[:, None]
    ox = torch.arange(0, tw, 8, device=dev).repeat(th // 4)
    oy = torch.arange(0, th, 4, device=dev).repeat_interleave(tw // 8)
    x0 = (tx0 + ox + 0.5)[:, None]                         # (P, 1, patches)
    y0 = (ty0 + oy + 0.5)[:, None]
    keep = hit[..., None].expand(-1, -1, ox.shape[0])
    far = torch.ones_like(keep)
    for k in (0, 3, 6):
        a, bb, cc = r[..., k], r[..., k + 1], r[..., k + 2]
        hi = (a * torch.where(a >= 0, x0 + 7, x0) + cc) \
            + bb * torch.where(bb >= 0, y0 + 3, y0)
        keep = keep & ~(hi < 0)
        if wire_thresh is not None:
            g = 1.0 / torch.sqrt(a * a + bb * bb + 1e-30)
            lo = (a * torch.where(a >= 0, x0, x0 + 7) + cc) * g \
                + (bb * torch.where(bb >= 0, y0, y0 + 3)) * g
            far = far & (lo > wire_thresh)
    if wire_thresh is not None:
        keep = keep & ~far
    return hit, keep


def warp_visits(rows, bbox, bins, wire_thresh=None):
    """((bbox hit, warp) pairs, those the warp evaluates) over all of the
    bins: what the per-warp rejection leaves of the kernels' work."""
    tile, chunk = rc._pairs(bins)
    hits = visits = 0
    for s in range(0, tile.shape[0], rc.PAIR_BATCH):
        hit, keep = patch_survivors(rows, bbox, tile[s:s + rc.PAIR_BATCH],
                                    chunk[s:s + rc.PAIR_BATCH], bins,
                                    wire_thresh)
        hits += int(hit.sum()) * keep.shape[-1]
        visits += int(keep.sum())
    return hits, visits


def ptxas_summary() -> str:
    """Registers and spill bytes of every kernel of the library just
    built, from nvcc's ``-Xptxas -v`` output: ``name registers/spill
    stores/spill loads``, the name with its mangled template arguments
    (``Lb`` wireframe, ``Li`` thread limit, ``Li`` blocks per SM)."""
    out = []
    for m in re.finditer(
            r"Compiling entry function '(\S+)' for.*?(\d+) bytes spill "
            r"stores, (\d+) bytes spill loads.*?Used (\d+) registers",
            rc.build_info.get("ptxas", ""), re.S):
        name = re.search(r"raster_[a-z]+_kernel(I(L[bi]\d+E)+E)?", m[1])
        out.append(f"{name[0] if name else m[1]} {m[4]}/{m[2]}/{m[3]}")
    return ", ".join(out)


@contextlib.contextmanager
def edited_kernels(edits):
    """The kernel library built from a temporary copy of ``csrc/`` with the
    textual ``edits`` [(file, text, replacement)] (each text must be in
    its file exactly once), loaded in place of the library as built for
    the ``with`` block."""
    source = rc.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "csrc"
        shutil.copytree(source, copy)
        for fname, old, new in edits:
            text = (copy / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{old!r} is not in {fname} exactly once")
            (copy / fname).write_text(text.replace(old, new))
        rc.CSRC, rc._lib = copy, None
        try:
            rc.load_kernels()
            yield
        finally:
            rc.CSRC, rc._lib = source, None


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call: ``reps`` calls captured into a CUDA
    graph and replayed, so the host's work per call is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def occ_break_even() -> float:
    """The share of K2's evaluations the occlusion skip must spare to pay
    on this card, from measured points: K2 at 1920x1080 (BENCH_CONFIG) on
    the sponza stand-in at the bench pose and on ``layered_scene(layers=L)``
    (L = 4, 8, 16) at the default camera, each with the skip (nearest-first bins with
    bounds) and without (id-ordered bins), outputs held equal.  Per point:
    the share spared (the kernel's own counts), the net time with the skip
    (on / off - 1), and, from a build whose tests never fire
    (OCC_NEVER_FIRES), the machinery's cost (never / off - 1) and what the
    skips save ((never - on) / off).  The break-even is where net crosses
    zero between the two measured points, adjacent in share, that bracket
    it (a straight line through those two); it is returned.  The least-
    squares line of net against share over all points is printed beside
    it; where no two points bracket zero, its crossing is returned, an
    extrapolation."""
    from kanirenderer_tpu_torch.core.types import (default_camera,
                                                   frame_state)
    from kanirenderer_tpu_torch.models.procedural import layered_scene
    from kanirenderer_tpu_torch.ops.binning import bin_tiles, depth_bound
    dev = torch.device("cuda", 0)
    cfg = flythrough.BENCH_CONFIG
    W, H = cfg.width, cfg.height
    scene = sponza_standin_scene(device=dev)
    cam0 = flythrough.BENCH_CAM0
    poses = [("bench pose", scene,
              camera_state(cam0.position, cam0.yaw, cam0.pitch, dev))]
    poses += [(f"layered {n}", layered_scene(layers=n, device=dev),
               default_camera(device=dev)) for n in (4, 8, 16)]
    calls = {}
    for name, sc, cam in poses:
        g = frame_geometry(sc, frame_state(sc, cam,
                                           default_lights(device=dev)), cfg)
        st = g.setup
        on = bin_tiles(st.bbox, W, H, cfg.tile_w, cfg.tile_h,
                       cfg.max_chunks_per_tile,
                       occ_bound=depth_bound(st.setup, st.bbox, cfg.tile_w,
                                             cfg.tile_h))
        off = bin_tiles(st.bbox, W, H, cfg.tile_w, cfg.tile_h,
                        cfg.max_chunks_per_tile)
        calls[name] = [
            lambda b, g=g, **kw: rc.rasterize_pixels(
                g.records, g.setup.setup, g.setup.bbox, b, W, H, **kw),
            on, off]
    rows = {}
    for name, (fn, on, off) in calls.items():
        c_on = torch.zeros(len(rc.OCC_COUNTS), dtype=torch.int64,
                           device=dev)
        c_off = torch.zeros_like(c_on)
        a, b = fn(on, counts=c_on), fn(off, counts=c_off)
        equal = torch.equal(a.z, b.z) and torch.equal(a.tid, b.tid)
        visits = dict(zip(rc.OCC_COUNTS, c_on.tolist()))["visits"]
        share = 1 - visits / max(dict(zip(rc.OCC_COUNTS,
                                          c_off.tolist()))["visits"], 1)
        rows[name] = dict(share=share, equal=equal,
                          on=device_ms(lambda: fn(on)),
                          off=device_ms(lambda: fn(off)))
    with edited_kernels(dict(EDITS)[OCC_NEVER_FIRES]):
        for name, (fn, on, _) in calls.items():
            rows[name]["never"] = device_ms(lambda: fn(on))
    for name, r in rows.items():
        r["net"] = r["on"] / r["off"] - 1
        print(f"K2 {name}: spared {r['share']:.4f}, skip on {r['on']:.4f} "
              f"ms, off {r['off']:.4f}, tests never firing "
              f"{r['never']:.4f}; net {r['net']:+.4f}, machinery "
              f"{r['never'] / r['off'] - 1:+.4f}, skips save "
              f"{(r['never'] - r['on']) / r['off']:.4f}; outputs on = off "
              f"{r['equal']}", flush=True)
    pts = sorted((r["share"], r["net"]) for r in rows.values())
    x = torch.tensor([p[0] for p in pts], dtype=torch.float64)
    y = torch.tensor([p[1] for p in pts], dtype=torch.float64)
    slope = ((x - x.mean()) * (y - y.mean())).sum() / (
        (x - x.mean()) ** 2).sum()
    at0 = y.mean() - slope * x.mean()
    fit = float(-at0 / slope) if slope < 0 else float("inf")
    even = next((x0 + y0 / (y0 - y1) * (x1 - x0)
                 for (x0, y0), (x1, y1) in zip(pts, pts[1:])
                 if y0 > 0 >= y1), fit)
    print(f"break-even: least squares net = {float(at0):+.4f} "
          f"{float(slope):+.4f} x share over {len(pts)} points (shares "
          f"{pts[0][0]:.4f} to {pts[-1][0]:.4f}) crosses zero at "
          f"{fit:.4f}; between the bracketing points at {even:.4f}: the "
          f"skip pays from a share of {even:.4f}", flush=True)
    return even


def main(words=()) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if list(words) == ["break-even"]:
        occ_break_even()
        return
    dev = torch.device("cuda", 0)
    cfg = flythrough.BENCH_CONFIG
    wcfg = flythrough.MODE_CONFIGS["wireframe"]
    scene = sponza_standin_scene(device=dev)
    cam0 = flythrough.BENCH_CAM0
    state = frame_state(scene, camera_state(cam0.position, cam0.yaw,
                                            cam0.pitch, dev),
                        default_lights(device=dev))
    g = frame_geometry(scene, state, cfg)
    gw = frame_geometry(scene, state, wcfg)
    W, H, D = cfg.width, cfg.height, cfg.shadow_dim
    sh = g.shadow_setup
    big = raster_cases.wire_interior_case(dev, W, H, scale=16)
    calls = {
        "K1": (rc.rasterize_depth, rc.rasterize_depth_plain,
               (sh.setup, sh.bbox, g.shadow_bins, D)),
        "K2": (rc.rasterize_pixels, rc.rasterize_pixels_plain,
               (g.records, g.setup.setup, g.setup.bbox, g.bins, W, H)),
        "K2w": (rc.rasterize_pixels, rc.rasterize_pixels_plain,
                (gw.records, gw.setup.setup, gw.setup.bbox, gw.bins, W, H,
                 True, wcfg.wire_thresh_px)),
        "K3": (rc.rasterize, rc.rasterize_plain,
               (g.setup.setup, g.setup.bbox, g.bins, W, H)),
        "K3w": (rc.rasterize, rc.rasterize_plain,
                (gw.setup.setup, gw.setup.bbox, gw.bins, W, H, True,
                 wcfg.wire_thresh_px)),
        # 75 triangles, three of them most of the screen: what the
        # wireframe rejection is for, and the bench scene has none of.
        "K3w large triangles": (rc.rasterize, rc.rasterize_plain,
                                (big.setup, big.bbox, big.bins, W, H, True,
                                 raster_cases.WIRE_THRESH)),
    }
    for k, st, bins in (("K1", sh, g.shadow_bins), ("K2", g.setup, g.bins),
                        ("K2w", gw.setup, gw.bins)):
        hits, visits = warp_visits(st.setup, st.bbox, bins)
        line = (f"{k}: {hits} (bbox hit, warp) pairs, {visits} visited "
                "after may_cover")
        if k == "K2w":
            wire = warp_visits(st.setup, st.bbox, bins, wcfg.wire_thresh_px)
            line += f", {wire[1]} after the wireframe rejection too"
        print(line, flush=True)
    plain = {k: p(*a) for k, (_, p, a) in calls.items()}
    print(f"empty-map fill alone (inside K1's wrapper): "
          f"{device_ms(lambda: torch.ones((D, D), device=dev)):.4f} ms",
          flush=True)

    def measure(name: str) -> None:
        parts = []
        for k, (fn, _, a) in calls.items():
            out = fn(*a)
            torch.cuda.synchronize()
            exact = torch.equal(out, plain[k]) if k == "K1" else all(
                torch.equal(x, y) for x, y in zip(out, plain[k])
                if x is not None)
            parts.append(f"{k} {device_ms(lambda: fn(*a)):.4f} ms "
                         f"exact={exact}")
        print(f"{name}: " + " | ".join(parts), flush=True)
        if not name.endswith("again") and not rc.build_info.get("cached"):
            print(f"  registers/spill stores/spill loads: {ptxas_summary()}",
                  flush=True)

    measure("as built")
    measure("as built, again")
    for name, edits in EDITS:
        if words and not any(w in name for w in words):
            continue
        with edited_kernels(edits):
            measure(name)


if __name__ == "__main__":
    main(sys.argv[1:])
