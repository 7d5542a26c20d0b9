"""Ablation timing of the raster kernels K1, K2 and K2w on one GPU.

    python -m kanirenderer_tpu_torch.ops.raster_ablation

Times the kernels as built from ``csrc/`` at the bench shapes (sponza
stand-in, bench pose, 2048² shadow map, 1920×1080), then again from
temporary copies of ``csrc/`` in which one design element is taken out or
one constant changed by a textual edit, so that the share of each element
in the kernels' time can be read off.  A copy that no longer computes the
kernel's function is marked ``exact=False`` against the plain version;
its time is what the measurement is for.  An edit whose pattern is no
longer in the sources raises, so the list is kept in step with them.
Times are device times: 20 calls of the wrapper captured into a CUDA graph
and replayed between two events, so the host's work per call (about 0.04
ms, which an eager loop reads once a kernel is faster than that) is not in
them.  Nothing here is used by the renderer.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from kanirenderer_tpu_torch import flythrough
from kanirenderer_tpu_torch.core.types import (camera_state, default_lights,
                                               frame_state)
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.passes.frame import frame_geometry

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
     [("raster_depth.cu", "kani::visit_hits(&s, setup, s.count, rect,",
       "if (s.count < 0) kani::visit_hits(&s, setup, s.count, rect,")]),
    ("K1 blocks load their slice and leave",
     [("raster_depth.cu", "if (tile >= 0) {",
       "if (tile >= 0 && entries < 0) {")]),
    ("K1 slices of 4 entries",
     [("raster_depth.cu", "kSlice = 8;", "kSlice = 4;")]),
    ("K1 slices of 16 entries",
     [("raster_depth.cu", "kSlice = 8;", "kSlice = 16;")]),
    ("K2 without phase 1: phase 2 writes the background",
     [("raster_pixels.cu", "for (int i0 = 0; i0 < n; i0 += kRound) {",
       "for (int i0 = 0; i0 < n && width < 0; i0 += kRound) {")]),
    ("K2 phase 1 only: covered pixels write their depth and stop",
     [("raster_pixels.cu", "  if (best < 0) {\n    for",
       "  if (best >= 0) return;\n  if (best < 0) {\n    for")]),
    ("K2 at four blocks per SM (64 registers)",
     [("raster_pixels.cu", "kWire ? 4 : 6>", "4>")]),
]


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
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
    calls = {
        "K1": (rc.rasterize_depth, rc.rasterize_depth_plain,
               (sh.setup, sh.bbox, g.shadow_bins, D)),
        "K2": (rc.rasterize_pixels, rc.rasterize_pixels_plain,
               (g.records, g.setup.setup, g.setup.bbox, g.bins, W, H)),
        "K2w": (rc.rasterize_pixels, rc.rasterize_pixels_plain,
                (gw.records, gw.setup.setup, gw.setup.bbox, gw.bins, W, H,
                 True, wcfg.wire_thresh_px)),
    }
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

    source = rc.CSRC
    measure("as built")
    measure("as built, again")
    for name, edits in EDITS:
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp) / "csrc"
            shutil.copytree(source, copy)
            for fname, old, new in edits:
                text = (copy / fname).read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} is not in {fname} "
                                       "exactly once")
                (copy / fname).write_text(text.replace(old, new))
            rc.CSRC, rc._lib = copy, None
            rc.load_kernels()
            measure(name)
    rc.CSRC, rc._lib = source, None


if __name__ == "__main__":
    main()
