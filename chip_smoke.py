#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kanirenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (phase 10 one per configuration, phase 12 one per
case); any failure exits non-zero:
  1. device: needs CUDA; prints the nvidia-smi name/power-limit line;
  2. build: compiles the raster kernels from csrc/ with nvcc (sm_90a), one
     compiler process per source, all started together;
  3. K1 (shadow depth raster) against its plain PyTorch version on the
     full-size sponza stand-in, 2048² map, bench pose, bit-equal; also the
     grid's chunks per tile and bbox hits per (tile, chunk) pair;
  4. K2 (fused raster + interpolation) against its plain version at
     1920×1080, same pose, bit-equal; the same counts of its grid; then
     the shading kernel (ops/shade_cuda.shade_surface) on K2's pixels and
     the PCF table of phase 3's map against band_shade -> band_surface on
     the card: at most SHADE_TOL level off, at most SHADE_OFF of the
     values off at all, uncovered pixels bit-equal;
  5. small frame: the whole LIT_SHADOW frame through the kernels against
     the plain path on the CPU (256×192, small stand-in), golden criterion;
  6. main path: 3 warm-up + 30 fly-through frames at 1920×1080 with a
     fresh 2048² shadow map, K1, K2 and the shading kernel launched once
     per frame;
  7. K2w (K2's wireframe variant) against its plain version at 1920×1080,
     bench pose, the camera setup without back-face culling, bit-equal;
  8. K3 (visibility raster) against its plain version at 1920×1080, with
     and without wireframe coverage, bit-equal;
  9. small frames: every other configuration of flythrough.MODE_CONFIGS
     through the kernels against the CPU path, golden criterion (HDR at
     255× its float16 values);
 10. every mode on the main path: 3 warm-up + 10 fly-through frames at
     1920×1080 per configuration, each launching exactly its kernels once
     per frame;
 11. the visibility entry (ops.raster_cuda.rasterize_config, which no
     frame path calls) over the same 10 poses, with and without wireframe;
 12. K1, K2, K2w and K3 (with and without wireframe) against their plain
     versions on the adversarial cases of ops/raster_cases.py (hit-list
     overflow, tiles at the 640-chunk cap with counted overflow, empty
     tiles, depth ties across chunks, a ragged raster, NaN planes,
     wireframe interiors, infinite and overflowing coefficients, two
     layers far one first, steep slivers below their vertex bound),
     bit-equal; then each case with the occlusion skip (binned nearest
     first, and in id order with the bounds): bit-equal, the kernels'
     counts equal to ops/occ_replay's;
 13. load: writes the full-size stand-in (257,040 triangles, 25 materials,
     256² textures) as OBJ + MTL + PNG files into a temporary directory
     and loads it through api.load_model_or_default, with the host
     library's parser, tangent frames and Morton order (io/native.py) and
     again with Python and numpy only: parse, textures and pack seconds of
     both, every scene array torch.equal; also a small scene whose first
     normal map is a 16-bit PNG (the separate texture tables);
 14. the application path, steady state: api.run on that OBJ at 1920×1080,
     LIT_SHADOW, scripted fly-through, cached PCF table: K2 once per frame,
     K1 exactly once in the run, no overflow warning;
 15. the same with cache_shadow_map=False: K1 and K2 once per frame; then
     flythrough.fly over the same scene and inputs, twice, and both loops
     once more in the reverse order, for comparison within one call;
 16. steady equals fresh: the loop's steady-state frame at the start pose
     against render_frame with a fresh map, bit-equal on the u8 surface;
 17. events at full size: Tab through all five modes, the sun rotated for
     three frames (no shadow pass while it turns, one once it has
     stopped), a resize to 1600×900 (render size 1920×1024 by the ladder),
     a depth pick, a dropped second OBJ, one frame through PngSink and
     back through decode_png;
 18. cli.main in-process at 256×256 on the card, PNG sink;
 19. the small 16-bit scene through render_frame on the card against the
     CPU, corner-major and vertex-major, golden criterion;
 20. row bands: K1 on 4 bands of the 2048² map, K2 and K2w on 4
     contiguous (270 rows) and 4 interleaved (17 tile rows) bands at
     1920×1080, bit-equal to their plain versions and reassembled to the
     whole raster; the same on every case of ops/raster_cases.py at n = 2
     and at an n whose bands are not whole tile rows;
 21. banded frames at 1920×1080 in one process (parallel/mesh with
     make_mesh(n)), n = 2 and 4, contiguous and interleaved (DEBUG
     contiguous only): LIT_SHADOW fresh (map in bands, table gathered),
     LIT_SHADOW with an external map, WIREFRAME, DEBUG with either
     texture, each reassembled torch.equal to render_frame's u8 surface
     and depth and launching its band kernels once per band;
 22. per-band stage times of the LIT_SHADOW frame on the one card, n = 2
     and 4, contiguous and interleaved: shadow band, raster, shade and
     surface (the shading kernel), K1, K2 and the shading kernel's device
     time, the replicated geometry, the imbalance and the bytes of each
     collective;
 23. the same frame over torch.distributed: 2 gloo ranks sharing the
     card (and 2 NCCL ranks where there are two cards), 2 frames, each
     rank's frame torch.equal to the one-process frame; then
     parallel.dryrun_multichip(2) (on one card: the bands looped on it);
 24. occlusion: K1 at the bench pose, whole and in 4 map bands, with the
     skip (the default scope's nearest-first bins) and without, K2, K2w,
     K3 and K3 wireframe on the layered scene (models/procedural, about
     260K triangles) at 1920x1080 and at the bench pose with scope "1" and
     "0": outputs bit-equal to each other and to the plain versions, the
     kernels' counts of chunks skipped and warp visits beside
     ops/occ_replay's, graph-replay times on and off; interleaved K2 and
     K2w bands of the layered scene with scope "1", reassembled to the
     whole frame, timed with the skip and without; the gate's break-even
     (K2 built with the skip's tests made never to fire, timed at the bench
     pose and on the layered scene); the gate (occ_replay.choose_occ_scope)
     on the stand-in and the layered scene, its decision, estimate and
     seconds; api.run on the layered scene written as OBJ + MTL with
     KANI_OCC=auto against KANI_OCC=0, frames bit-equal;
 25. the C ABI (include/kanirenderer_tpu.h) from the port's host library
     (csrc/kani_host.cpp, built with g++ at first use): examples/
     embed_demo.c compiled against it renders phase 13's stand-in at
     1920×1080, 5 LIT_SHADOW frames at a fixed 1/60 s step through the
     PNG sink, in-process (the interpreter it loads) and as a python3
     subprocess; run_kanirenderer through ctypes.PyDLL in this process
     launches K1 once and K2 once a frame; every last frame pixel-equal
     to api.run's called here with the same overrides.
Kernel times are CUDA-graph replays (mean, and the median of the
replays; the eager 20-call mean beside them).  Before and after the frame
phases 6, 10, 14-15 and 21-22 a "state" line gives the card's clocks,
throttle reasons, temperature and power and the host CPU's MHz.
Then a JSON line of per-kernel results (the band variants' rows averaged
over the bands of the bench's 4 contiguous bands; each row also with its
time with the occlusion skip off or on and its share of evaluations
spared, from phase 24, and its launches in the runs of phases 14, 15, 17
and 25), the card line, and last {"ok": true, "device":
{...}}.
"""

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

WARMUP, FRAMES = 3, 30
MODE_FRAMES = 10
LOOP_FRAMES = 33
EMBED_FRAMES = 5
STANDIN_TRIS, STANDIN_MATERIALS = 257_040, 25
# The application path's window and the size phase 17 drags it to.
APP_SIZE, RESIZE = (1920, 1080), (1600, 900)
# Kernel vs plain version, same inputs on the card.  Both evaluate every
# plane in the same order with no fused multiply-add, so every kernel must
# be bit-equal (tolerance 0: torch.equal on every output).
K1_TOL = K2_TOL = K3_TOL = 0.0
# The shading kernel sums the texture's and the PCF's non-zero lane terms
# in another order than the plain chain's reductions: on the u8 surface at
# most one level off, on at most 0.1% of the values.
SHADE_TOL, SHADE_OFF = 1, 1e-3
PIXEL_FIELDS = ("tid", "mask", "z", "varyings", "mat_id", "tex_w", "tex_h",
                "blk_base", "blk_w")
# The golden criterion (tests/test_golden.py:65-68).
GOLD_FRAC8, GOLD_MEAN = 0.01, 1.5
# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and FP32
# operations/s outside the tensor cores.
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
# FP32 operations per (triangle, pixel) evaluation, counted from the
# kernels' source: the five-plane coverage (4 planes of 2 mul + 2 add, and
# 1 − z) and the depth min or tournament compare, 18 in all; the wireframe
# edge distances where that coverage holds, 3 × ((a·X + c)·g + (b·Y)·g: 6)
# plus 2 min and the threshold compare, 21.  The edge scales g depend on
# the triangle only: 3 × (a² + b² + 1e-30: 4; sqrt, 1/x: 2) once per bbox
# hit of a tile, whatever computes them.
OPS_COVER, OPS_WIRE, OPS_SCALES = 18, 21, 18
# Per covered pixel after the tournament: K2's barycentrics (3 planes, 2
# divisions) and 17 varyings of 2 mul + 2 add; K3's 3 planes, 2 adds and
# 2 divisions.
OPS_K2_PIXEL, OPS_K3_PIXEL = 3 * 4 + 2 + 17 * 4, 3 * 4 + 2 + 2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` eager calls between two events: the plain
    versions' time (a kernel's wrapper costs ~0.04 ms of host time per
    call, which this reads once the kernel is faster: ``graph_ms``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int = 20, replays: int = 10) -> tuple:
    """(mean, median) device ms of one call: ``reps`` calls captured into
    a CUDA graph, the graph replayed ``replays`` times between two events
    each; the mean over all replays and the median of the replays'
    per-call times.  The host's work per call is not in them."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    del graph
    return statistics.mean(times), statistics.median(times)


def host_ms(fn, reps: int = 5) -> float:
    """Median ms on the host clock of ``reps`` calls, each ending in a
    device synchronisation."""
    import torch
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def device_state(label: str) -> None:
    """Print the card's SM and memory clocks, active throttle reasons,
    temperature and power draw (nvidia-smi) and the host CPU's MHz
    (/proc/cpuinfo): which state a run of frames was in."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
         "clocks_throttle_reasons.active,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "not readable"
    with open("/proc/cpuinfo") as f:
        mhz = [float(ln.split(":")[1]) for ln in f
               if ln.startswith("cpu MHz")]
    cpu = (f"mean {statistics.mean(mhz):.0f} min {min(mhz):.0f} max "
           f"{max(mhz):.0f} over {len(mhz)} cores" if mhz else "not readable")
    print(f"state {label}: card (sm MHz, mem MHz, throttle reasons, C, W) "
          f"{smi}; host CPU MHz {cpu}", flush=True)


def launches(**nonzero) -> dict:
    """Every wrapper's launch count: the given ones, 0 for the others."""
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    return {k: nonzero.get(k, 0) for k in rc.launch_counts}


def timing(mean: float, median: float, eager: float) -> str:
    return (f"{mean:.4f} ms (graph replay; median {median:.4f}, eager "
            f"{eager:.4f})")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pixels_differ(k, p) -> list:
    """Names of the PixelBuffer outputs on which kernel and plain version
    are not bit-equal."""
    import torch
    return [f for f in PIXEL_FIELDS
            if not torch.equal(getattr(k, f), getattr(p, f))]


def pixels_err(k, p) -> float:
    """max |kernel − plain| over depth and varyings."""
    return max((k.z - p.z).abs().max().item(),
               (k.varyings - p.varyings).abs().max().item())


def grid_stats(bins, hit_evals: int) -> str:
    """Chunks per tile and bbox hits per (tile, chunk) pair of a grid."""
    count = bins.count.float()
    pairs = int(bins.count.sum())
    hits = hit_evals // (bins.tile_w * bins.tile_h)
    return (f"chunks per tile max {int(count.max())} mean "
            f"{count.mean().item():.2f} ({int((count == 0).sum())} of "
            f"{count.numel()} tiles empty), bin pairs {pairs}, bbox hits "
            f"per pair {hits / max(pairs, 1):.2f} of 128")


def raster_work(rows, bbox, bins, width, height, wire_thresh=None, y0=0,
                y_stride=1, tile_rows=None):
    """(triangle, pixel) evaluations the kernel makes on these inputs: the
    bbox-hitting triangles of every (tile, chunk) pair × tile pixels, and
    with ``wire_thresh`` the evaluations whose five-plane coverage holds
    (where the kernel goes on to the edge distances) and those of them
    within the threshold of an edge.  ``y0``/``y_stride``: a band's bins
    (their tile row j at global rows y0 + j·y_stride·tile_h);
    ``tile_rows``: only the pairs of tile rows [r0, r1) (K1 on a band)."""
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    tile, chunk = rc._pairs(bins)
    if tile_rows is not None:
        row = tile // bins.tiles_x
        keep = (row >= tile_rows[0]) & (row < tile_rows[1])
        tile, chunk = tile[keep], chunk[keep]
    hits = covered = passed = 0
    for s in range(0, tile.shape[0], rc.PAIR_BATCH):
        t, c = tile[s:s + rc.PAIR_BATCH], chunk[s:s + rc.PAIR_BATCH]
        _, hit = rc._bbox_hits(bbox, t, c, bins, y0, y_stride)
        hits += int(hit.sum()) * bins.tile_w * bins.tile_h
        if wire_thresh is not None:
            cov, _, _ = rc._eval_pairs(rows, bbox, t, c, bins, width, height,
                                       None, y0, y_stride)
            covered += int(cov.sum())
            cov, _, _ = rc._eval_pairs(rows, bbox, t, c, bins, width, height,
                                       wire_thresh, y0, y_stride)
            passed += int(cov.sum())
    return hits, covered, passed


def chunk_rows_bytes(chunks, *tensors) -> int:
    """Bytes of the rows of ``tensors`` ((T, …), 128 rows a chunk) that
    belong to the distinct chunk ids in ``chunks``."""
    import torch
    used = int(torch.unique(chunks[chunks >= 0]).numel())
    return sum(used * 128 * t[0].numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    FP32 operations over the FP32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def golden_diff(a, b):
    """(fraction of values > 8 levels apart, mean difference) of two
    surfaces on the CPU; float16 (HDR) surfaces at 255× their values."""
    import torch
    scale = 255.0 if a.dtype == torch.float16 else 1.0
    diff = (a.double() - b.double()).abs() * scale
    return (diff > 8).double().mean().item(), diff.mean().item()


def image_std(img) -> float:
    import torch
    scale = 255.0 if img.dtype == torch.float16 else 1.0
    return img.float().std().item() * scale


def write_scene_obj(directory: str, textures, patches, name: str = "scene",
                    normal16: bool = False) -> str:
    """Write a procedural scene's host arrays (``textures``, ``patches``
    as models/procedural.standin_parts gives them) as ``<name>.obj`` +
    ``<name>.mtl`` + one PNG diffuse and one PNG normal map per material
    into ``directory``; returns the OBJ's path.  One ``g`` section per
    patch, floats as %.9g so that float32 values round-trip, textures
    through the port's ``encode_png``.  ``normal16``: the first material's
    normal map as a 16-bit PNG with values between the 8-bit levels, so
    that the loader keeps the separate texture tables.  No OBJ asset ships
    with the repository: the smoke run and the tests load what this
    writes."""
    import numpy as np
    from kanirenderer_tpu_torch.io.image import write_png

    mtl = []
    for i, t in enumerate(textures):
        normal = t.normal[..., :3]
        if normal16 and i == 0:
            normal = normal.astype(np.uint16) * 256 + 100
        write_png(os.path.join(directory, f"{name}_{i}_d.png"),
                  t.diffuse[..., :3])
        write_png(os.path.join(directory, f"{name}_{i}_n.png"), normal)
        mtl.append(f"newmtl {t.name}\nmap_Kd {name}_{i}_d.png\n"
                   f"map_Bump {name}_{i}_n.png\n")
    with open(os.path.join(directory, f"{name}.mtl"), "w") as f:
        f.write("".join(mtl))

    lines = [f"mtllib {name}.mtl"]
    for k, (pos, uv, nrm, tris, mats) in enumerate(patches):
        lines.append(f"g patch_{k}")
        lines += ["v %.9g %.9g %.9g" % tuple(p) for p in pos.tolist()]
        lines += ["vt %.9g %.9g" % tuple(p) for p in uv.tolist()]
        lines += ["vn %.9g %.9g %.9g" % tuple(p) for p in nrm.tolist()]
        lines.append(f"usemtl {textures[int(mats[0])].name}")
        lines += ["f %d/%d/%d %d/%d/%d %d/%d/%d" % (a, a, a, b, b, b, c, c, c)
                  for a, b, c in (tris + 1).tolist()]
    path = os.path.join(directory, f"{name}.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@contextlib.contextmanager
def python_host_load():
    """The loader without the host library: io/native.py's parse_obj
    refuses every text (io/obj.load_obj then takes the Python parser), and
    its compute_tbn and morton_order are the numpy versions."""
    from kanirenderer_tpu_torch.io import native, scene_loader
    saved = native.parse_obj, native.compute_tbn, native.morton_order
    native.parse_obj = lambda text: None
    native.compute_tbn = scene_loader.compute_tbn_plain
    native.morton_order = scene_loader.morton_order_plain
    try:
        yield
    finally:
        native.parse_obj, native.compute_tbn, native.morton_order = saved


def write_standin_obj(directory: str, name: str = "scene",
                      normal16: bool = False, **standin) -> str:
    """Write the sponza stand-in (models/procedural.standin_parts with the
    keywords ``standin``) through ``write_scene_obj``."""
    from kanirenderer_tpu_torch.models.procedural import standin_parts
    return write_scene_obj(directory, *standin_parts(**standin), name,
                           normal16)


def write_layered_obj(directory: str, name: str = "layered",
                      **layered) -> str:
    """Write the layered scene (models/procedural.layered_parts with the
    keywords ``layered``) through ``write_scene_obj``."""
    from kanirenderer_tpu_torch.models.procedural import layered_parts
    return write_scene_obj(directory, *layered_parts(**layered), name)


class CaptureSink:
    """Keeps a copy of every presented frame's shape and of the last
    frame (the loop's pinned buffers are reused two presents later)."""

    def __init__(self):
        self.shapes, self.last = [], None

    def present(self, frame):
        self.shapes.append(tuple(frame.shape))
        self.last = frame.copy()

    def close(self):
        pass


def timed_events(events, stamps, k1_counts=None):
    """``events`` with the host clock (and, where wanted, the K1 launch
    count so far) noted as the loop asks for each."""
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    for ev in events:
        stamps.append(time.perf_counter())
        if k1_counts is not None:
            k1_counts.append(rc.launch_counts["rasterize_depth"])
        yield ev


def application_path(tmp: str, card: str) -> dict:
    """Phases 13-19; returns the launch counts of the runs of phases 14,
    15 and 17."""
    import numpy as np
    import torch
    from kanirenderer_tpu_torch import api, cli, flythrough
    from kanirenderer_tpu_torch.core.types import (RenderConfig, RenderMode,
                                                   camera_state,
                                                   default_camera,
                                                   default_lights,
                                                   frame_state)
    from kanirenderer_tpu_torch.io.image import decode_png
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.passes.frame import render_frame
    from kanirenderer_tpu_torch.runtime import controllers
    from kanirenderer_tpu_torch.runtime.display import PngSink
    from kanirenderer_tpu_torch.runtime.loop import (Events, _bucket,
                                                     run_loop,
                                                     scripted_flythrough)

    dev = torch.device("cuda", 0)
    W, H = APP_SIZE

    # ---- phase 13: write and load ----
    t0 = time.perf_counter()
    path = write_standin_obj(tmp)
    small = write_standin_obj(tmp, name="deep", normal16=True,
                              target_tris=6000, num_materials=4, tex_size=32)
    extra = write_standin_obj(tmp, name="extra", target_tris=6000,
                              num_materials=2, tex_size=32)
    wrote = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
    scene, builder = api.load_model_or_default(path, device=dev)
    torch.cuda.synchronize()
    tris, mats = int(scene.tri_valid.sum()), scene.mat_blk_base.shape[0]
    lo, hi = scene.position.amin(0), scene.position.amax(0)
    secs = builder.load_seconds
    print(f"phase 13 load: wrote {len(os.listdir(tmp))} files, "
          f"{size / 1e6:.1f} MB in {wrote:.2f} s; loaded {tris} triangles, "
          f"{mats} materials, {scene.position.shape[0]} vertices, bounds "
          f"{[round(v, 1) for v in lo.tolist()]}.."
          f"{[round(v, 1) for v in hi.tolist()]}; parse "
          f"{secs['parse']:.2f} s, textures {secs['textures']:.2f} s, pack "
          f"{secs['pack']:.2f} s; scene on the card "
          f"{nbytes(*scene) / 1e6:.1f} MB, combined table "
          f"{tuple(scene.tex_combined.shape)}", flush=True)
    if (tris, mats) != (STANDIN_TRIS, STANDIN_MATERIALS) \
            or not torch.isfinite(torch.stack([lo, hi])).all() \
            or scene.tex_combined.shape[0] == 0:
        fail("the loaded scene is not the stand-in")
    with python_host_load():
        py_scene, py_builder = api.load_model_or_default(path, device=dev)
    torch.cuda.synchronize()
    py_secs = py_builder.load_seconds
    differ = [f for f in scene._fields
              if not torch.equal(getattr(scene, f), getattr(py_scene, f))]
    print(f"phase 13 load in Python and numpy only: parse "
          f"{py_secs['parse']:.2f} s, textures {py_secs['textures']:.2f} s, "
          f"pack {py_secs['pack']:.2f} s, against native parse "
          f"{secs['parse']:.2f} s, textures {secs['textures']:.2f} s, pack "
          f"{secs['pack']:.2f} s; scene arrays not torch.equal {differ}",
          flush=True)
    if differ:
        fail(f"the native and the Python load differ in {differ}")
    deep, _ = api.load_model_or_default(small, device=dev)
    if deep.tex_normal.dtype != torch.uint16 or deep.tex_combined.shape[0]:
        fail("the 16-bit normal map did not select the separate tables")
    del scene, builder, py_scene, py_builder

    # ---- phases 14, 15: the loop, steady state and fresh ----
    counts, medians = {}, {}
    device_state("before phase 14")
    for phase, run, cache in ((14, "loop_steady", True),
                              (15, "loop_fresh", False)):
        stamps, warned = [], io.StringIO()
        rc.reset_launch_counts()
        with contextlib.redirect_stderr(warned):
            stats = api.run(
                path, "opengl", width=W, height=H,
                mode=RenderMode.LIT_SHADOW, frames=LOOP_FRAMES, sink="null",
                events=timed_events(scripted_flythrough(LOOP_FRAMES + 1),
                                    stamps),
                verbose=False, cache_shadow_map=cache)
        torch.cuda.synchronize()
        counts[run] = dict(rc.launch_counts)
        ms = [(b - a) * 1e3 for a, b in zip(stamps[WARMUP:], stamps[WARMUP
                                                                    + 1:])]
        medians[run] = statistics.median(ms)
        print(f"phase {phase} {run}: {stats['frames']} frames {W}x{H} "
              f"LIT_SHADOW cache_shadow_map={cache}, launches "
              f"{counts[run]}, median {medians[run]:.2f} ms per frame (min "
              f"{min(ms):.2f}, max {max(ms):.2f}, after {WARMUP} warm-up "
              f"frames), statistics mean_ms {stats['mean_ms']:.2f} fps "
              f"{stats['fps']:.1f}, warnings {warned.getvalue()!r} on {card}",
              flush=True)
        n = LOOP_FRAMES
        want = launches(rasterize_depth=1 if cache else n,
                        rasterize_pixels=n, shade_forward=n)
        if stats["frames"] != n or counts[run] != want:
            fail(f"{run}: launch counts {counts[run]} != {want}")
        if "binning dropped" in warned.getvalue() or stats["healed"]:
            fail(f"{run}: overflow or a failed frame")
    # A second round in the reverse order, with fly() over the same scene
    # and scripted inputs between the two (each pose one loop frame's
    # median apart; the loop integrates the wall clock, so the poses are
    # about, not exactly, the loop's).  The host of a card is shared and
    # a run of frames can sit several ms above the next one of the same
    # code: read the two rounds side by side.
    scene, builder = api.load_model_or_default(path, device=dev)
    host_cam = controllers.HostCamera(
        np.array([0.0, 5.0, 10.0], np.float32), np.deg2rad(np.float32(-90)),
        np.deg2rad(np.float32(-20)))
    cams = flythrough.camera_path(
        LOOP_FRAMES, host_cam, controllers.CameraInputs(
            forward=1.0, rotate_dx=2.0, rotate_dy=0.3),
        dt=medians["loop_fresh"] / 1e3)
    second = {}
    for run in ("fly", "fly", "loop_fresh", "loop_steady"):
        if run == "fly":
            ms = [t for _, t in flythrough.fly(
                scene, flythrough.BENCH_CONFIG, cams)][WARMUP:]
        else:
            stamps = []
            run_loop(scene, timed_events(
                scripted_flythrough(LOOP_FRAMES + 1), stamps),
                config=flythrough.BENCH_CONFIG.with_(
                    cache_shadow_map=run == "loop_steady"),
                sink_kind="null", max_frames=LOOP_FRAMES, builder=builder)
            ms = [(b - a) * 1e3 for a, b in zip(stamps[WARMUP:],
                                                stamps[WARMUP + 1:])]
        second.setdefault(run, []).append(statistics.median(ms))
    print(f"phase 15 medians ms per frame, first / second round: loop "
          f"steady {medians['loop_steady']:.2f} / "
          f"{second['loop_steady'][0]:.2f}, loop fresh "
          f"{medians['loop_fresh']:.2f} / {second['loop_fresh'][0]:.2f}, "
          f"flythrough.fly fresh on the same scene and inputs "
          f"{second['fly'][0]:.2f} / {second['fly'][1]:.2f} on {card}",
          flush=True)
    device_state("after phase 15")

    # ---- phase 16: steady equals fresh ----
    cfg = RenderConfig(width=W, height=H, mode=RenderMode.LIT_SHADOW,
                       output_u8=True)
    sink = CaptureSink()
    rc.reset_launch_counts()
    run_loop(scene, [Events()] * 3, config=cfg, sink=sink, builder=builder)
    k1 = rc.launch_counts["rasterize_depth"]
    state = frame_state(scene, default_camera(device=dev),
                        default_lights(device=dev))
    fresh = render_frame(scene, state, cfg.with_(cache_shadow_map=False))
    steady = torch.from_numpy(sink.last)
    equal = torch.equal(steady, fresh.image.cpu())
    frac8, mean = golden_diff(steady, fresh.image.cpu())
    print(f"phase 16 steady equals fresh: bit-equal {equal} (>8 levels "
          f"{frac8:.5f}, mean {mean:.4f}), shadow passes in 3 loop frames "
          f"{k1}, image std {image_std(steady):.2f}, covered "
          f"{(fresh.depth < 1.0).float().mean().item():.3f}", flush=True)
    if not equal or k1 != 1 or image_std(steady) < 1.0:
        fail("the loop's steady-state frame is not the fresh frame")

    # ---- phase 17: events ----
    tab = Events(pressed=frozenset(["tab"]))
    turn = Events(held=frozenset(["r"]))
    events = [Events(), Events(), turn, turn, turn, Events(), Events(),
              Events(resize=RESIZE),
              Events(click_pos=(RESIZE[0] // 2, RESIZE[1] // 2)),
              Events(dropped_file=extra), tab, tab, tab, tab, tab, Events()]
    tris_before = sum(len(t) for t in builder.tri_idx)
    sink, k1_at, stamps = CaptureSink(), [], []
    rc.reset_launch_counts()
    stats = run_loop(scene, timed_events(events, stamps, k1_at), config=cfg,
                     sink=sink, builder=builder)
    torch.cuda.synchronize()
    counts["events"] = dict(rc.launch_counts)
    tris_after = sum(len(t) for t in builder.tri_idx)
    png = os.path.join(tmp, "present.png")
    PngSink(png).present(sink.last)
    with open(png, "rb") as f:
        back = decode_png(f.read())
    print(f"phase 17 events: {stats['frames']} frames, final mode "
          f"{stats['mode']}, K1 launches before each frame {k1_at}, launches "
          f"{counts['events']}, view {stats['view_size']} render "
          f"{stats['render_size']}, presented {sorted(set(sink.shapes))}, "
          f"picked {stats['picked']}, triangles {tris_before} -> "
          f"{tris_after}, PNG round trip equal "
          f"{np.array_equal(back, sink.last)}", flush=True)
    n = len(events)
    # frame 1 settles the table; frames 2-4 turn the sun; frame 5 finds it
    # still; the drop (frame 9) rebuilds; DEBUG (frame 11) rasterizes its
    # own map.  WIREFRAME, DEBUG and UNLIT (frames 10-12) shade without
    # the shading kernel.
    want_k1 = [0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 4]
    want = launches(rasterize_depth=4, rasterize_pixels=n - 1,
                    rasterize_pixels_wireframe=1, shade_forward=n - 3)
    picked = stats["picked"]
    if (stats["frames"] != n or stats["mode"] != "LIT_SHADOW"
            or k1_at != want_k1 or counts["events"] != want
            or stats["healed"]):
        fail(f"events: K1 schedule {k1_at} != {want_k1} or launches "
             f"{counts['events']} != {want}")
    # the ladder takes 1600x900 to a 1920x1024 render target
    padded = (_bucket(RESIZE[0]), _bucket(RESIZE[1]))
    if (stats["view_size"], stats["render_size"]) != (RESIZE, padded) \
            or sink.shapes != [(H, W, 3)] * 7 \
            + [(RESIZE[1], RESIZE[0], 3)] * (n - 7):
        fail("events: the resize did not present frames of the view's size")
    if len(picked) != 1 or not (cfg.znear <= picked[0][3] <= cfg.zfar
                                and 0.0 <= picked[0][2] <= 1.0):
        fail(f"events: depth pick {picked}")
    if tris_after <= tris_before or not np.array_equal(back, sink.last) \
            or image_std(torch.from_numpy(sink.last)) < 1.0:
        fail("events: file drop or PNG round trip")
    del scene, builder

    # ---- phase 18: the command line ----
    out = os.path.join(tmp, "cli_%d.png")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        code = cli.main([small, "opengl", "--width", "256", "--height",
                         "256", "--frames", "2", "--sink", "png", "--out",
                         out])
    with open(out % 1, "rb") as f:
        img = decode_png(f.read())
    print(f"phase 18 cli: exit {code}, {img.shape} {img.dtype} std "
          f"{img.std():.2f}; said {said.getvalue().splitlines()[-1]!r}",
          flush=True)
    if code != 0 or img.shape != (256, 256, 3) or img.std() < 5.0:
        fail("the command line did not write a plausible frame")

    # ---- phase 19: the 16-bit scene, card against CPU ----
    scfg = RenderConfig(width=256, height=192, shadow_dim=256,
                        output_u8=True)
    cam0 = flythrough.BENCH_CAM0
    images = {}
    for key, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        sc, _ = api.load_model_or_default(small, device=d)
        e = sc.corner_pos[:0, :0]
        bare = sc._replace(corner_pos=e, corner_uv=e, corner_normal=e,
                           corner_tangent=e, corner_bitangent=e,
                           tri_extra=sc.tri_extra[:0])
        for form, s in (("corner", sc), ("vertex", bare)):
            st = frame_state(s, camera_state(cam0.position, cam0.yaw,
                                             cam0.pitch, d),
                             default_lights(device=d))
            images[key, form] = render_frame(s, st, scfg).image.cpu()
    for form in ("corner", "vertex"):
        frac8, mean = golden_diff(images["cpu", form], images["cuda", form])
        print(f"phase 19 16-bit scene {form}-major cuda vs cpu: >8 levels "
              f"{frac8:.5f} (tol {GOLD_FRAC8}), mean {mean:.4f} (tol "
              f"{GOLD_MEAN}), std {image_std(images['cuda', form]):.2f}; "
              f"equal to the corner-major frame on the card "
              f"{torch.equal(images['cuda', form], images['cuda', 'corner'])}",
              flush=True)
        if not (frac8 < GOLD_FRAC8 and mean < GOLD_MEAN) \
                or image_std(images["cuda", form]) < 10.0:
            fail(f"16-bit scene, {form}-major: card and CPU disagree")
    return counts


def c_abi(tmp: str, card: str) -> dict:
    """Phase 25: the C ABI of include/kanirenderer_tpu.h from the port's
    host library (csrc/kani_host.cpp).  examples/embed_demo.c linked
    against it renders phase 13's stand-in at APP_SIZE, EMBED_FRAMES
    LIT_SHADOW frames at a fixed step (KANI_FIXED_DT) through the PNG
    sink, in-process and as a subprocess; then run_kanirenderer through
    ctypes.PyDLL in this process.  Every last frame is pixel-equal to the
    last frame of api.run called here with the same overrides, and the
    in-process call launches K1 once and K2 once a frame, as phase 14.
    Returns that call's launch counts."""
    import ctypes
    import sysconfig
    import numpy as np
    import torch
    from kanirenderer_tpu_torch import api
    from kanirenderer_tpu_torch.io import native
    from kanirenderer_tpu_torch.io.image import decode_png
    from kanirenderer_tpu_torch.ops import raster_cuda as rc

    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "scene.obj")
    t0 = time.perf_counter()
    lib = native.library_path()
    demo = os.path.join(tmp, "embed_demo")
    cc = subprocess.run(
        ["cc", os.path.join(repo, "examples", "embed_demo.c"), "-I",
         os.path.join(repo, "include"), "-o", demo, lib,
         f"-Wl,-rpath,{os.path.dirname(lib)}"], capture_output=True,
        text=True, timeout=120)
    print(f"phase 25 build: {os.path.basename(lib)} and embed_demo in "
          f"{time.perf_counter() - t0:.2f} s, cc exit {cc.returncode}",
          flush=True)
    if cc.returncode != 0:
        fail(f"embed_demo does not link against the host library:\n"
             f"{cc.stderr}")
    W, H = APP_SIZE
    n = EMBED_FRAMES
    env = dict(KANI_WIDTH=str(W), KANI_HEIGHT=str(H), KANI_FRAMES=str(n),
               KANI_SINK="png", KANI_FIXED_DT=str(1 / 60))
    # The interpreter a C host loads reads this interpreter's packages.
    paths = sysconfig.get_paths()
    pythonpath = os.pathsep.join(
        [repo, paths["purelib"], paths["platlib"]]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])

    def last_frame(pattern):
        with open(pattern % (n - 1), "rb") as f:
            return decode_png(f.read())

    frames = {}
    for run in ("in-process", "subprocess"):
        out = os.path.join(tmp, f"embed_{run}_%d.png")
        t0 = time.perf_counter()
        r = subprocess.run(
            [demo, path, "opengl", "windowed"], cwd=repo,
            env={**os.environ, **env, "KANI_OUT": out, "KANI_EMBED": run,
                 "PYTHONPATH": pythonpath},
            capture_output=True, text=True, timeout=600)
        said = [ln for ln in r.stdout.splitlines()
                if ln.startswith(("loaded", "rendered"))]
        print(f"phase 25 embed_demo KANI_EMBED={run}: exit {r.returncode} "
              f"in {time.perf_counter() - t0:.1f} s; said {said}",
              flush=True)
        if r.returncode != 0 or f"rendered {n} frames" not in r.stdout:
            fail(f"embed_demo, {run}: {r.stdout[-2000:]}\n"
                 f"{r.stderr[-4000:]}")
        frames[run] = last_frame(out)

    saved = {k: os.environ.get(k) for k in (*env, "KANI_OUT", "KANI_EMBED")}
    try:
        os.environ.update(env, KANI_OUT=os.path.join(tmp, "direct_%d.png"))
        t0 = time.perf_counter()
        stats = api.run(path, "opengl", verbose=False)
        direct_s = time.perf_counter() - t0
        frames["api.run"] = last_frame(os.environ["KANI_OUT"])
        os.environ.update(KANI_OUT=os.path.join(tmp, "pydll_%d.png"),
                          KANI_EMBED="in-process")
        pylib = ctypes.PyDLL(lib)
        pylib.run_kanirenderer.argtypes = [ctypes.c_char_p] * 3 \
            + [ctypes.c_int]
        said = io.StringIO()
        rc.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            code = pylib.run_kanirenderer(path.encode(), b"opengl",
                                          b"windowed", 0)
        torch.cuda.synchronize()
        counts = dict(rc.launch_counts)
        pydll_s = time.perf_counter() - t0
        frames["PyDLL"] = last_frame(os.environ["KANI_OUT"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k in [k for k in os.environ if k.startswith("KANI_ARG_")]:
            del os.environ[k]
    want = launches(rasterize_depth=1, rasterize_pixels=n, shade_forward=n)
    ref = frames["api.run"]
    equal = {run: bool(np.array_equal(img, ref)) for run, img in
             frames.items() if run != "api.run"}
    print(f"phase 25 api.run here {stats['frames']} frames in "
          f"{direct_s:.1f} s; run_kanirenderer through ctypes.PyDLL: "
          f"exit {code} in {pydll_s:.1f} s, launches {counts}, said "
          f"{said.getvalue().splitlines()}; last frame {ref.shape} std "
          f"{image_std(torch.from_numpy(ref)):.2f}, pixel-equal to "
          f"api.run's {equal} on {card}", flush=True)
    if code != 0 or counts != want or not all(equal.values()) \
            or stats["frames"] != n or image_std(torch.from_numpy(ref)) < 1.0:
        fail(f"the C ABI: exit {code}, launches {counts} != {want} or "
             f"frames differ {equal}")
    return counts


def split_bands(height: int, tile_h: int, n: int, interleave: bool) -> list:
    """[(y0, band_h, y_stride)] of n contiguous or interleaved row bands
    of ``height`` rows (parallel/mesh._band_geometry)."""
    if interleave:
        band_h = -(-(-(-height // tile_h)) // n) * tile_h
        return [(k * tile_h, band_h, n) for k in range(n)]
    return [(k * (height // n), height // n, 1) for k in range(n)]


def odd_split(height: int, tile_h: int) -> int:
    """The least n > 2 that divides ``height`` into bands that are not
    whole tile rows."""
    return next(n for n in range(3, height + 1)
                if height % n == 0 and (height // n) % tile_h)


def bins_of_band(bins, bbox, width, cap, y0, band_h, y_stride):
    """A band's bins: its tile rows of the full grid's ``bins`` when
    interleaved, its own grid's when contiguous."""
    from kanirenderer_tpu_torch.ops.binning import bin_tiles, interleave_bins
    if y_stride > 1:
        return interleave_bins(bins, y0 // bins.tile_h, y_stride)
    return bin_tiles(bbox, width, band_h, bins.tile_w, bins.tile_h, cap,
                     y0=y0)


def band_kernels(scene, state, cfg, wcfg, kernels) -> None:
    """Phase 20: K1, K2 and K2w on row bands against their plain versions
    (bit-equal) and against the whole raster's rows, at the bench shapes
    and on the cases of ops/raster_cases.py; their rows of the kernels
    line (graph-replay time, plain time and bound per band, averaged over
    the bands of the bench's n = 4 contiguous split)."""
    import torch
    from kanirenderer_tpu_torch.ops import raster_cases
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.parallel.mesh import deinterleave_rows
    from kanirenderer_tpu_torch.passes.frame import frame_geometry
    W, H, D = cfg.width, cfg.height, cfg.shadow_dim
    g = frame_geometry(scene, state, cfg)
    gw = frame_geometry(scene, state, wcfg)

    # K1: the map in 4 bands of 512 rows, from the whole map's bins.
    sh, sb = g.shadow_setup, g.shadow_bins
    whole = rc.rasterize_depth(sh.setup, sh.bbox, sb, D)
    n = 4
    bh = D // n
    runs = rc.band_entries(sb, [(k * bh, bh) for k in range(n)])
    rows = []
    for k, (e0, e1) in enumerate(runs):
        y0 = k * bh
        kb = rc.rasterize_depth(sh.setup, sh.bbox, sb, D, y0, bh, (e0, e1))
        pb = rc.rasterize_depth_plain(sh.setup, sh.bbox, sb, D, y0, bh)
        torch.cuda.synchronize()
        equal = torch.equal(kb, pb)
        part = torch.equal(kb, whole[y0:y0 + bh])
        ms, med = graph_ms(lambda: rc.rasterize_depth(
            sh.setup, sh.bbox, sb, D, y0, bh, (e0, e1)))
        pms = cuda_ms(lambda: rc.rasterize_depth_plain(
            sh.setup, sh.bbox, sb, D, y0, bh), 1)
        hits, _, _ = raster_work(sh.setup, sh.bbox, sb, D, D,
                                 tile_rows=(y0 // sb.tile_h,
                                            (y0 + bh) // sb.tile_h))
        b_ms, b_by = bound(
            chunk_rows_bytes(sb.chunk[e0:e1], sh.setup, sh.bbox)
            + nbytes(sb.pair_tile[e0:e1], sb.chunk[e0:e1], kb),
            hits * OPS_COVER)
        rows.append(dict(err=(kb - pb).abs().max().item(), ms=ms,
                         ms_median=med, plain_ms=pms, bound_ms=b_ms,
                         bound_by=b_by))
        print(f"phase 20 K1 band {k}/{n} map rows [{y0}, {y0 + bh}): "
              f"entries {e1 - e0}, bit-equal to plain {equal}, to the whole "
              f"map's rows {part}, covered "
              f"{(kb < 1.0).float().mean().item():.3f}, {ms:.4f} ms (graph "
              f"replay; median {med:.4f}) vs plain {pms:.1f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        if not (equal and part):
            fail(f"K1 band {k} disagrees")
    kernels["rasterize_depth_band"] = band_row(
        rows, "kanirenderer_tpu_torch/csrc/raster_depth.cu",
        "kanirenderer_tpu/ops/raster_pallas.py:1304")

    # K2 and K2w: 4 contiguous bands of 270 rows (not whole 16-row tiles)
    # and 4 interleaved bands of 17 tile rows.
    for wire, gg, name in ((False, g, "rasterize_pixels_band"),
                           (True, gw, "rasterize_pixels_wireframe_band")):
        st, thresh = gg.setup, wcfg.wire_thresh_px
        full = rc.rasterize_pixels(gg.records, st.setup, st.bbox, gg.bins, W,
                                   H, wire, thresh)
        for interleave in (False, True):
            rows, bands = [], []
            for k, (y0, bh, stride) in enumerate(
                    split_bands(H, cfg.tile_h, n, interleave)):
                bins = bins_of_band(gg.bins, st.bbox, W,
                                    cfg.max_chunks_per_tile, y0, bh, stride)
                args = (gg.records, st.setup, st.bbox, bins, W, H, wire,
                        thresh, y0, stride, bh)
                kb = rc.rasterize_pixels(*args)
                pb = rc.rasterize_pixels_plain(*args)
                torch.cuda.synchronize()
                differ = pixels_differ(kb, pb)
                bands.append(kb)
                ms, med = graph_ms(lambda: rc.rasterize_pixels(*args))
                pms = cuda_ms(lambda: rc.rasterize_pixels_plain(*args), 1)
                hits, cov, _ = raster_work(st.setup, st.bbox, bins, W, H,
                                           thresh if wire else None, y0,
                                           stride)
                ops = hits * OPS_COVER + int(kb.mask.sum()) * OPS_K2_PIXEL
                if wire:
                    ops += cov * OPS_WIRE \
                        + hits // (bins.tile_w * bins.tile_h) * OPS_SCALES
                _, used = rc._pairs(bins)         # the band's entries
                b_ms, b_by = bound(
                    chunk_rows_bytes(used, gg.records, st.setup, st.bbox)
                    + nbytes(bins.start, bins.count, kb.z, kb.varyings,
                             kb.mat_id) + 4 * used.numel()
                    + 5 * nbytes(kb.mat_id), ops)
                rows.append(dict(err=pixels_err(kb, pb), ms=ms,
                                 ms_median=med, plain_ms=pms, bound_ms=b_ms,
                                 bound_by=b_by))
                print(f"phase 20 {'K2w' if wire else 'K2'} "
                      f"{'interleaved' if interleave else 'contiguous'} band "
                      f"{k}/{n} (y0 {y0}, {bh} rows, stride {stride}): "
                      f"outputs not bit-equal to plain {differ}, covered "
                      f"{kb.mask.float().mean().item():.3f}, "
                      f"{grid_stats(bins, hits)}, overflow "
                      f"{int(bins.overflow)}, {ms:.4f} ms (graph replay; "
                      f"median {med:.4f}) vs plain {pms:.1f} ms, bound "
                      f"{b_ms:.4f} ms ({b_by})", flush=True)
                if differ:
                    fail(f"{name} band {k} disagrees with its plain version")
            together = {f: torch.cat([getattr(b, f) for b in bands], -2)
                        for f in ("tid", "z", "varyings")}
            if interleave:
                together = {f: deinterleave_rows(
                    t.movedim(-2, 0), n, cfg.tile_h, H).movedim(0, -2)
                    for f, t in together.items()}
            apart = [f for f, t in together.items()
                     if not torch.equal(t, getattr(full, f))]
            print(f"phase 20 {'K2w' if wire else 'K2'} "
                  f"{'interleaved' if interleave else 'contiguous'} bands "
                  f"reassembled: not equal to the whole raster {apart}",
                  flush=True)
            if apart:
                fail(f"{name}: bands do not reassemble to the whole raster")
            if not interleave:
                kernels[name] = band_row(
                    rows, "kanirenderer_tpu_torch/csrc/raster_pixels.cu",
                    "kanirenderer_tpu/ops/raster_pallas.py:1215")
        del full, bands

    # The adversarial cases in bands: n = 2 and an n whose bands are not
    # whole tile rows, contiguous and interleaved; K1 on the square cases.
    T = raster_cases.TILE
    for case, sq in zip(raster_cases.adversarial_cases(scene.device),
                        raster_cases.adversarial_cases(scene.device,
                                                       square=True)):
        differ = []
        for n in (2, odd_split(case.height, T)):
            for interleave in (False, True):
                for y0, bh, stride in split_bands(case.height, T, n,
                                                  interleave):
                    bins = bins_of_band(case.bins, case.bbox, case.width,
                                        640, y0, bh, stride)
                    for wire in (False, True):
                        args = (case.setup, case.bbox, bins, case.width,
                                case.height, wire, raster_cases.WIRE_THRESH,
                                y0, stride, bh)
                        kb = rc.rasterize_pixels(case.records, *args)
                        pb = rc.rasterize_pixels_plain(case.records, *args)
                        differ += [f"n{n}{'i' if interleave else 'c'}y{y0}"
                                   f"{'w' if wire else ''}.{f}"
                                   for f in pixels_differ(kb, pb)]
        for n in (2, odd_split(sq.height, T)):
            whole = rc.rasterize_depth(sq.setup, sq.bbox, sq.bins, sq.width)
            for y0, bh, _ in split_bands(sq.height, T, n, False):
                kb = rc.rasterize_depth(sq.setup, sq.bbox, sq.bins, sq.width,
                                        y0, bh)
                pb = rc.rasterize_depth_plain(sq.setup, sq.bbox, sq.bins,
                                              sq.width, y0, bh)
                if not (torch.equal(kb, pb)
                        and torch.equal(kb, whole[y0:y0 + bh])):
                    differ.append(f"K1 n{n} y{y0}")
        torch.cuda.synchronize()
        print(f"phase 20 {case.name}: bands n = 2 and "
              f"{odd_split(case.height, T)} ({case.height} rows), K1 n = 2 "
              f"and {odd_split(sq.height, T)} ({sq.height} rows), outputs "
              f"not bit-equal {differ}", flush=True)
        if differ:
            fail(f"phase 20 {case.name}: band kernels disagree")


def banded_frames(scene, state, kernels, card):
    """Phase 21: banded frames at full width in one process, reassembled
    and held ``torch.equal`` to ``render_frame``'s u8 surface and depth,
    each launching its band kernels once per band; returns the whole
    LIT_SHADOW frame."""
    import torch
    from kanirenderer_tpu_torch import flythrough
    from kanirenderer_tpu_torch.core.types import RenderMode
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.parallel.mesh import (deinterleave_rows,
                                                      make_mesh,
                                                      render_frame_sharded)
    from kanirenderer_tpu_torch.passes.frame import (SHADOW_MODES,
                                                     render_frame,
                                                     render_shadow_map)
    cfg, modes = flythrough.BENCH_CONFIG, flythrough.MODE_CONFIGS
    timed = state._replace(frame_times_ms=torch.linspace(
        2.0, 9.0, 256, device=scene.device))
    cases = [("LIT_SHADOW fresh", cfg, state, None),
             ("LIT_SHADOW external map", cfg, state,
              render_shadow_map(scene, state, cfg)),
             ("WIREFRAME", modes["wireframe"], state, None),
             ("DEBUG depth", modes["debug_depth"], timed, None),
             ("DEBUG shadow map", modes["debug_shadow"], timed, None)]
    total, wholes = launches(), {}
    for name, c, st, ext in cases:
        whole = wholes[name] = render_frame(scene, st, c, shadow_map=ext)
        wire = c.mode == RenderMode.WIREFRAME
        for n in (2, 4):
            for interleave in (False, True):
                if interleave and c.mode == RenderMode.DEBUG:
                    continue        # the reference's rule
                rc.reset_launch_counts()
                t0 = time.perf_counter()
                out = render_frame_sharded(scene, st, c, make_mesh(n),
                                           shadow_map=ext,
                                           interleave=interleave)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = dict(rc.launch_counts)
                image, depth = out.image, out.depth
                if interleave:
                    image, depth = (deinterleave_rows(t, n, c.tile_h,
                                                      c.height)
                                    for t in (image, depth))
                equal = torch.equal(image, whole.image) \
                    and torch.equal(depth, whole.depth)
                fresh = c.mode in SHADOW_MODES and ext is None
                want = launches(**{
                    "rasterize_pixels_wireframe_band" if wire
                    else "rasterize_pixels_band": n,
                    "rasterize_depth_band": n if fresh else 0,
                    "shade_forward":
                        n if c.mode == RenderMode.LIT_SHADOW else 0})
                print(f"phase 21 {name} in {n} "
                      f"{'interleaved' if interleave else 'contiguous'} "
                      f"bands: surface and depth equal to the whole frame "
                      f"{equal}, launches {counts}, overflow "
                      f"{int(out.raster_overflow)}, {ms:.1f} ms (one "
                      f"process, one card)", flush=True)
                if not equal or counts != want or int(out.raster_overflow):
                    fail(f"phase 21 {name}: banded frame or launch counts "
                         f"{counts} != {want}")
                for k in total:
                    total[k] += counts[k]
        if image_std(whole.image) < 1.0:
            fail(f"phase 21 {name}: implausible whole frame")
    for name in ("rasterize_depth_band", "rasterize_pixels_band",
                 "rasterize_pixels_wireframe_band"):
        kernels[name]["launches"] = total[name]
    return wholes["LIT_SHADOW fresh"]


def band_times(scene, state, card) -> None:
    """Phase 22: per-band stage times of the LIT_SHADOW bench frame on one
    card, each band's stages run in turn through passes/frame's stage
    functions, as render_band runs them: median host ms of each band's
    shadow stage (its run of the map's bins, its K1 band and its table
    rows), raster (binning and K2) and shade and surface (the shading
    kernel), the graph-replay device ms of its K1, K2 and shading
    launches, the replicated geometry, the imbalance max band / mean band
    and the bytes of each collective."""
    import torch
    from kanirenderer_tpu_torch import flythrough
    from kanirenderer_tpu_torch.ops.shade_cuda import shade_surface
    from kanirenderer_tpu_torch.parallel.mesh import _band_geometry
    from kanirenderer_tpu_torch.passes.frame import (ShadowGeometry,
                                                     band_bins, band_edges,
                                                     band_pixels,
                                                     frame_geometry,
                                                     shadow_band_map,
                                                     shadow_band_runs,
                                                     shadow_table_band)
    cfg = flythrough.BENCH_CONFIG
    W, D = cfg.width, cfg.shadow_dim
    for n in (2, 4):
        for interleave in (False, True):
            form = "interleaved" if interleave else "contiguous"
            band_h, step = _band_geometry(cfg, n, interleave)
            stride = n if interleave else 1
            geo_ms = host_ms(lambda: frame_geometry(
                scene, state, cfg, light_space=True, main_bins=interleave))
            g = frame_geometry(scene, state, cfg, light_space=True,
                               main_bins=interleave)
            sh, sb = ShadowGeometry(g.shadow_setup, g.shadow_bins), D // n
            runs = shadow_band_runs(sh, cfg, range(n), n)
            maps = [shadow_band_map(sh, cfg, k, n, runs[k]) for k in range(n)]
            edges = torch.stack([band_edges(m) for m in maps])
            table = torch.cat([shadow_table_band(maps[k], edges, k, n)
                               for k in range(n)])
            per = []
            for k in range(n):
                y0 = k * (step if interleave else band_h)
                k1_ms, _ = graph_ms(lambda: shadow_band_map(sh, cfg, k, n,
                                                            runs[k]))
                shadow_ms = host_ms(lambda: shadow_table_band(
                    shadow_band_map(sh, cfg, k, n,
                                    shadow_band_runs(sh, cfg, [k], n)[0]),
                    edges, k, n))
                bins = band_bins(g, cfg, y0, band_h, stride)
                k2_ms, _ = graph_ms(lambda: band_pixels(g, cfg, bins, y0,
                                                        band_h, stride))
                raster_ms = host_ms(lambda: band_pixels(
                    g, cfg, band_bins(g, cfg, y0, band_h, stride), y0,
                    band_h, stride))
                pix = band_pixels(g, cfg, bins, y0, band_h, stride)
                kernel_ms, _ = graph_ms(lambda: shade_surface(
                    scene, state, cfg, pix, table, g.light_vp))
                shade_ms = host_ms(lambda: shade_surface(
                    scene, state, cfg, pix, table, g.light_vp))
                per.append(dict(total=shadow_ms + raster_ms + shade_ms,
                                k2=k2_ms))
                print(f"phase 22 {n} {form} bands, band {k} (y0 {y0}): "
                      f"shadow {shadow_ms:.3f} ms (K1 {k1_ms:.4f}), raster "
                      f"{raster_ms:.3f} (K2 {k2_ms:.4f}), shade and surface "
                      f"{shade_ms:.3f} (kernel {kernel_ms:.4f}), in all "
                      f"{per[-1]['total']:.3f} ms", flush=True)
            tot = [p["total"] for p in per]
            k2s = [p["k2"] for p in per]
            tbl_band = table.shape[0] // n * table.shape[1] * 4
            print(f"phase 22 {n} {form} bands of {band_h} rows: geometry "
                  f"{geo_ms:.3f} ms (replicated); per band max "
                  f"{max(tot):.3f} mean {statistics.mean(tot):.3f} ms, "
                  f"imbalance {max(tot) / statistics.mean(tot):.3f} (K2 "
                  f"{max(k2s) / statistics.mean(k2s):.3f}); collectives "
                  f"per band: halo {3 * D * 4} B, table rows {tbl_band} B "
                  f"(gathered {n * tbl_band} B), frame assembly "
                  f"{band_h * W * 7} B (u8 surface + f32 depth); DEBUG adds "
                  f"its map band {sb * D * 4} B and depth band "
                  f"{band_h * W * 4} B; single-card band times, no "
                  f"multi-card time measured, on {card}", flush=True)


def rank_frames(rank: int, n: int, frames: int) -> dict:
    """Phase 23, one rank of ``n``: the full-size stand-in at the bench
    pose, ``frames`` LIT_SHADOW frames (fresh map in bands, its table
    assembled over the group) through ``render_frame_sharded`` on this
    rank's card; the last frame, host ms per frame and launches per
    frame."""
    import torch
    from kanirenderer_tpu_torch import flythrough
    from kanirenderer_tpu_torch.core.types import (camera_state,
                                                   default_lights,
                                                   frame_state)
    from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.parallel.mesh import (make_mesh,
                                                      render_frame_sharded)
    dev = torch.device("cuda", torch.cuda.current_device())
    scene = sponza_standin_scene(device=dev)
    cam0 = flythrough.BENCH_CAM0
    state = frame_state(scene, camera_state(cam0.position, cam0.yaw,
                                            cam0.pitch, dev),
                        default_lights(device=dev))
    mesh = make_mesh()
    ms, counts = [], []
    for _ in range(frames):
        rc.reset_launch_counts()
        t0 = time.perf_counter()
        out = render_frame_sharded(scene, state, flythrough.BENCH_CONFIG,
                                   mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(dict(rc.launch_counts))
    return dict(image=out.image.cpu(), depth=out.depth.cpu(), ms=ms,
                counts=counts, device=str(dev))


def distributed_form(whole, card, forms) -> None:
    """Phase 23: the banded frame over ``torch.distributed``, for each
    (backend, ranks, label) of ``forms``; each rank's assembled frame
    against the whole frame ``whole``, ``torch.equal``."""
    import torch
    from kanirenderer_tpu_torch.parallel.mesh import run_ranks
    want = launches(rasterize_depth_band=1, rasterize_pixels_band=1,
                    shade_forward=1)
    frames = 2
    for backend, n, label in forms:
        t0 = time.perf_counter()
        ranks = run_ranks(n, rank_frames, (frames,), backend)
        secs = time.perf_counter() - t0
        equal = all(torch.equal(r["image"], whole.image.cpu())
                    and torch.equal(r["depth"], whole.depth.cpu())
                    for r in ranks)
        counted = all(c == want for r in ranks for c in r["counts"])
        print(f"phase 23 {label}: {frames} frames LIT_SHADOW 1920x1080 "
              f"fresh banded map; each rank's frame equal to the one-process "
              f"frame {equal}; launches per rank and frame as wanted "
              f"{counted} ({ranks[0]['counts'][-1]}); host ms per frame "
              f"{[[round(m, 1) for m in r['ms']] for r in ranks]} on "
              f"{[r['device'] for r in ranks]}; {secs:.1f} s with the "
              f"processes' start on {card}", flush=True)
        if not (equal and counted):
            fail(f"phase 23 {label}: ranks disagree with one process")


def occ_counts(fn) -> tuple:
    """(output, the kernel's occlusion counts) of one call
    ``fn(counts=...)``."""
    import torch
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    counts = torch.zeros(len(rc.OCC_COUNTS), dtype=torch.int64,
                         device="cuda")
    out = fn(counts=counts)
    torch.cuda.synchronize()
    return out, dict(zip(rc.OCC_COUNTS, counts.tolist()))


def share(on: dict, off: dict) -> float:
    """The share of the warp visits without the skip that it spares."""
    return 1.0 - on["visits"] / off["visits"] if off["visits"] else 0.0


def occ_line(label: str, c_on: dict, c_off: dict, r_on: dict, r_off: dict,
             on_ms, off_ms, equal: bool, card: str) -> dict:
    """Print one phase-24 line and return its numbers."""
    k_share, r_share = share(c_on, c_off), share(r_on, r_off)
    print(f"phase 24 {label}: outputs on = off = plain {equal}; kernel "
          f"{json.dumps(c_on)} (off: visits {c_off['visits']}), spared "
          f"{k_share:.4f} of the evaluations; replay {json.dumps(r_on)}, "
          f"spared {r_share:.4f}; skip on {on_ms[0]:.4f} ms (median "
          f"{on_ms[1]:.4f}), off {off_ms[0]:.4f} ms (median "
          f"{off_ms[1]:.4f}) on {card}", flush=True)
    return dict(share=k_share, replay_share=r_share, ms_on=on_ms[0],
                ms_off=off_ms[0], counts=c_on)


def occ_main_grid(label, g, cfg, wire, card, y0=0, y_stride=1,
                  band_h=None) -> dict:
    """Phase 24 on a main grid: K2 (K2w with ``wire``) and K3 of the same
    coverage, skip on (nearest-first bins with bounds) and off (id-ordered
    bins without), each bit-equal to the plain versions; counts from the
    kernels and from ops/occ_replay; graph-replay times of K2/K2w."""
    import torch
    from kanirenderer_tpu_torch.ops import occ_replay
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.ops.binning import bin_tiles, depth_bound
    W, H = cfg.width, cfg.height
    st = g.setup
    thresh = cfg.wire_thresh_px
    bins_on = bin_tiles(st.bbox, W, H, cfg.tile_w, cfg.tile_h,
                        cfg.max_chunks_per_tile,
                        occ_bound=depth_bound(st.setup, st.bbox, cfg.tile_w,
                                              cfg.tile_h))
    bins_off = bin_tiles(st.bbox, W, H, cfg.tile_w, cfg.tile_h,
                         cfg.max_chunks_per_tile)
    out = {}
    for name, fn in (("K2w" if wire else "K2", lambda b, **kw:
                      rc.rasterize_pixels(g.records, st.setup, st.bbox, b,
                                          W, H, wire, thresh, **kw)),
                     ("K3w" if wire else "K3", lambda b, **kw:
                      rc.rasterize(st.setup, st.bbox, b, W, H, wire, thresh,
                                   **kw))):
        k_on, c_on = occ_counts(lambda counts: fn(bins_on, counts=counts))
        k_off, c_off = occ_counts(lambda counts: fn(bins_off,
                                                    counts=counts))
        if name.startswith("K2"):
            p = rc.rasterize_pixels_plain(g.records, st.setup, st.bbox,
                                          bins_on, W, H, wire, thresh)
            equal = not pixels_differ(k_on, p) and not pixels_differ(k_off,
                                                                     p)
        else:
            p = rc.rasterize_plain(st.setup, st.bbox, bins_on, W, H, wire,
                                   thresh)
            equal = all(torch.equal(a, c) and torch.equal(b, c)
                        for a, b, c in zip(k_on, k_off, p))
        r_on = occ_replay.replay(st.setup, st.bbox, bins_on, W, H,
                                 thresh if wire else None,
                                 raster=False).counts
        r_off = occ_replay.replay(st.setup, st.bbox, bins_off, W, H,
                                  thresh if wire else None,
                                  raster=False).counts
        on_ms = graph_ms(lambda: fn(bins_on))
        off_ms = graph_ms(lambda: fn(bins_off))
        out[name] = occ_line(f"{name} {label}", c_on, c_off, r_on, r_off,
                             on_ms, off_ms, equal, card)
        if not equal:
            fail(f"phase 24 {name} {label}: the skip changes the outputs")
        if c_on != r_on:
            fail(f"phase 24 {name} {label}: kernel counts {c_on} are not "
                 f"the replay's {r_on}")
        del k_on, k_off, p
    return out


def occ_cases(case, sq, card) -> None:
    """Phase 12's occlusion lines: the case binned nearest first, and with
    its own id-ordered bins and the bounds, through K2, K2w, K3 (both
    coverages) and K1 (the square case) with the skip: bit-equal to the
    plain versions, counts equal to ops/occ_replay's (K1: at least its
    skips and drops)."""
    import torch
    from kanirenderer_tpu_torch.ops import occ_replay, raster_cases
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    occ = raster_cases.occlusion_case(case)
    sq_occ = raster_cases.occlusion_case(sq)
    shares, differ = [], []
    for form, bins in (("nearest first", occ.bins),
                       ("id order", case.bins._replace(
                           bound=occ.bins.bound))):
        off = bins._replace(bound=None)
        for wire in (False, True):
            args = (case.width, case.height, wire, raster_cases.WIRE_THRESH)
            k, c_on = occ_counts(lambda counts: rc.rasterize_pixels(
                case.records, case.setup, case.bbox, bins, *args,
                counts=counts))
            _, c_off = occ_counts(lambda counts: rc.rasterize_pixels(
                case.records, case.setup, case.bbox, off, *args,
                counts=counts))
            p = rc.rasterize_pixels_plain(case.records, case.setup,
                                          case.bbox, bins, *args)
            v, c3 = occ_counts(lambda counts: rc.rasterize(
                case.setup, case.bbox, bins, *args, counts=counts))
            vp = rc.rasterize_plain(case.setup, case.bbox, bins, *args)
            r = occ_replay.replay(case.setup, case.bbox, bins, case.width,
                                  case.height,
                                  raster_cases.WIRE_THRESH if wire else None,
                                  raster=False).counts
            tag = f"{form} {'K2w/K3w' if wire else 'K2/K3'}"
            differ += [f"{tag}.{f}" for f in pixels_differ(k, p)]
            differ += [f"{tag}.{f}" for f, a, b in zip(vp._fields, v, vp)
                       if not torch.equal(a, b)]
            if not c_on == c3 == r:
                differ.append(f"{tag} counts {c_on} {c3} replay {r}")
            shares.append(share(c_on, c_off))
    m, c1 = occ_counts(lambda counts: rc.rasterize_depth(
        sq.setup, sq.bbox, sq_occ.bins, sq.width, counts=counts))
    r1 = occ_replay.replay(sq.setup, sq.bbox, sq_occ.bins, sq.width,
                           sq.width, depth_only=True, raster=False).counts
    if not torch.equal(m, rc.rasterize_depth_plain(sq.setup, sq.bbox,
                                                   sq_occ.bins, sq.width)):
        differ.append("K1")
    if (c1["chunks_skipped"] < r1["chunks_skipped"]
            or c1["visits"] > r1["visits"]):
        differ.append(f"K1 counts {c1} replay {r1}")
    print(f"phase 12 {case.name} with the occlusion skip: evaluations "
          f"spared (nearest first / id order; K2, K2w) "
          f"{[round(x, 4) for x in shares]}, K1 {json.dumps(c1)}, outputs "
          f"or counts that disagree {differ}", flush=True)
    if differ:
        fail(f"phase 12 {case.name}: the occlusion skip disagrees")


def occlusion(scene, state, g, cfg, wcfg, card, tmp) -> dict:
    """Phase 24: the occlusion skip.  K1 at the bench pose, whole and in 4
    bands; K2, K2w, K3 on the layered scene at 1920x1080 and at the bench
    pose; interleaved K2 and K2w bands with scope "1"; the gate on the
    stand-in and on layered scenes of 4 and 8 walls, and api.run with
    KANI_OCC=auto on both layered scenes written as OBJ."""
    import torch
    from kanirenderer_tpu_torch import api
    from kanirenderer_tpu_torch.core.types import (RenderMode,
                                                   default_camera,
                                                   default_lights,
                                                   frame_state)
    from kanirenderer_tpu_torch.models.procedural import layered_scene
    from kanirenderer_tpu_torch.ops import occ_replay
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.ops.binning import bin_tiles, interleave_bins
    from kanirenderer_tpu_torch.passes.frame import frame_geometry
    from kanirenderer_tpu_torch.runtime.loop import Events
    dev = torch.device("cuda", 0)
    D, W, H = cfg.shadow_dim, cfg.width, cfg.height
    res = {}

    # K1 at the bench pose: the frame's own nearest-first shadow bins
    # (scope "shadow", the default) against id-ordered bins without bounds.
    sh, sb = g.shadow_setup, g.shadow_bins
    if sb.bound is None:
        fail("phase 24: the default scope does not skip in K1")
    sb_off = bin_tiles(sh.bbox, D, D, cfg.tile_w, cfg.shadow_tile_h,
                       cfg.shadow_chunks_per_tile)
    bands = [(k * D // 4, D // 4) for k in range(4)]
    runs_on = rc.band_entries(sb, bands)
    runs_off = rc.band_entries(sb_off, bands)
    for label, y0, bh, e_on, e_off in (
            [("K1", 0, D, (0, sb.chunk.shape[0]),
              (0, sb_off.chunk.shape[0]))]
            + [(f"K1 band {k}/4", y0, bh, runs_on[k], runs_off[k])
               for k, (y0, bh) in enumerate(bands)]):
        def k1(bins, entries, **kw):
            return rc.rasterize_depth(sh.setup, sh.bbox, bins, D, y0, bh,
                                      entries, **kw)
        m_on, c_on = occ_counts(lambda counts: k1(sb, e_on, counts=counts))
        m_off, c_off = occ_counts(lambda counts: k1(sb_off, e_off,
                                                    counts=counts))
        p = rc.rasterize_depth_plain(sh.setup, sh.bbox, sb, D, y0, bh)
        equal = torch.equal(m_on, p) and torch.equal(m_off, p)
        r_on = occ_replay.replay(sh.setup, sh.bbox, sb, D, D,
                                 depth_only=True, y0=y0, band_h=bh,
                                 entries=e_on, raster=False).counts
        r_off = occ_replay.replay(sh.setup, sh.bbox, sb_off, D, D,
                                  depth_only=True, y0=y0, band_h=bh,
                                  entries=e_off, raster=False).counts
        res[label] = occ_line(label + " bench pose", c_on, c_off, r_on,
                              r_off, graph_ms(lambda: k1(sb, e_on)),
                              graph_ms(lambda: k1(sb_off, e_off)), equal,
                              card)
        if not equal:
            fail(f"phase 24 {label}: the skip changes the map")
        del m_on, m_off, p

    # K2, K2w, K3 on the layered scene and at the bench pose.
    lay = layered_scene(device=dev)
    lstate = frame_state(lay, default_camera(device=dev),
                         default_lights(device=dev))
    lcfg = cfg.with_(occ_scope="1")
    gl = frame_geometry(lay, lstate, lcfg)
    glw = frame_geometry(lay, lstate, lcfg.with_(mode=RenderMode.WIREFRAME))
    print(f"phase 24 layered scene: {int(lay.tri_valid.sum())} triangles, "
          f"{W}x{H}, main-grid chunks per tile max "
          f"{int(gl.bins.count.max())} mean "
          f"{gl.bins.count.float().mean().item():.2f}", flush=True)
    gw = frame_geometry(scene, state, wcfg)
    for label, gg, wire in (("layered", gl, False), ("layered", glw, True),
                            ("bench pose", g, False),
                            ("bench pose", gw, True)):
        out = occ_main_grid(label, gg, cfg, wire, card)
        res.update({f"{name} {label}": v for name, v in out.items()})
    if res["K2 layered"]["share"] < 0.3:
        fail("phase 24: K2 spares under 30% of the evaluations on the "
             "layered scene")

    # Interleaved K2 and K2w bands with scope "1" on the layered scene:
    # reassembled to the whole frame, and per band with the skip and
    # without (the same bins without bounds).
    n, th = 4, gl.bins.tile_h
    J = -(-gl.bins.tiles_y // n)
    for name, gg, wire in (("K2", gl, False), ("K2w", glw, True)):
        st = gg.setup

        def band(k, bins, **kw):
            return rc.rasterize_pixels(
                gg.records, st.setup, st.bbox, bins, W, H, wire,
                cfg.wire_thresh_px, y0=k * th, y_stride=n, band_h=J * th,
                **kw)

        whole = rc.rasterize_pixels(gg.records, st.setup, st.bbox, gg.bins,
                                    W, H, wire, cfg.wire_thresh_px)
        z = torch.empty((J * n * th, W), device=dev)
        tid = torch.empty((J * n * th, W), dtype=torch.int32, device=dev)
        rows_on = []
        for k in range(n):
            on_bins = interleave_bins(gg.bins, k, n)
            off_bins = on_bins._replace(bound=None)
            b, c_on = occ_counts(lambda counts: band(k, on_bins,
                                                     counts=counts))
            _, c_off = occ_counts(lambda counts: band(k, off_bins,
                                                      counts=counts))
            rows_on.append((graph_ms(lambda: band(k, on_bins))[0],
                            graph_ms(lambda: band(k, off_bins))[0],
                            share(c_on, c_off)))
            for j in range(J):
                rows = slice((j * n + k) * th, (j * n + k + 1) * th)
                z[rows], tid[rows] = b.z[j * th:(j + 1) * th], \
                    b.tid[j * th:(j + 1) * th]
        torch.cuda.synchronize()
        equal = torch.equal(z[:H], whole.z) \
            and torch.equal(tid[:H], whole.tid)
        on_ms, off_ms, spared = (statistics.mean(r[i] for r in rows_on)
                                 for i in range(3))
        res[f"{name} band layered"] = dict(ms_on=on_ms, ms_off=off_ms,
                                           share=spared)
        print(f"phase 24 interleaved {name} bands of the layered scene, "
              f"scope 1, n = {n}: reassembled bit-equal to the whole frame "
              f"{equal}; per band, mean: skip on {on_ms:.4f} ms, off "
              f"{off_ms:.4f} ms, evaluations spared {spared:.4f} on {card}",
              flush=True)
        if not equal:
            fail(f"phase 24: interleaved {name} bands with the skip differ")
        del whole, z, tid

    # The gate on the bench scene and pose and on layered scenes of 4 and 8
    # walls, and api.run on those scenes written as OBJ + MTL,
    # KANI_OCC=auto against KANI_OCC=0 (8 walls: past the break-even, so
    # the main-grid skip runs in the loop).
    del gl, glw
    lay8 = layered_scene(layers=8, device=dev)
    for name, sc, st in (("sponza stand-in, default camera", scene,
                          frame_state(scene, default_camera(device=dev),
                                      default_lights(device=dev))),
                         ("sponza stand-in, bench pose", scene, state),
                         ("layered scene", lay, lstate),
                         ("layered scene of 8 walls", lay8,
                          frame_state(lay8, default_camera(device=dev),
                                      default_lights(device=dev)))):
        t0 = time.perf_counter()
        scope, est = occ_replay.choose_occ_scope(sc, st, cfg)
        print(f"phase 24 gate on the {name}: scope {scope} in "
              f"{time.perf_counter() - t0:.2f} s, estimate "
              f"{json.dumps(est)} (threshold "
              f"{occ_replay.EVAL_DROP_THRESHOLD})", flush=True)
        res[f"gate {name}"] = scope
        if scope != ("1" if est["eval_drop"] >= occ_replay.EVAL_DROP_THRESHOLD
                     else "shadow"):
            fail(f"phase 24: the gate's decision on the {name}")
    del lay, lay8
    for layers in (4, 8):
        path = write_layered_obj(tmp, name=f"layered{layers}", layers=layers)
        frames, said = {}, ""
        for occ in ("auto", "0"):
            os.environ["KANI_OCC"] = occ
            buf = io.StringIO()
            t0 = time.perf_counter()
            out = os.path.join(tmp, f"occ{layers}_{occ}_%d.png")
            with contextlib.redirect_stdout(buf):
                stats = api.run(path, width=W, height=H, frames=2,
                                sink="png", out=out,
                                events=[Events(), Events()])
            said += buf.getvalue()
            frames[occ] = [open(out % i, "rb").read() for i in range(2)]
            print(f"phase 24 api.run layered OBJ of {layers} walls "
                  f"KANI_OCC={occ}: {stats['frames']} frames in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        del os.environ["KANI_OCC"]
        gate = [ln for ln in said.splitlines() if ln.startswith("occlusion")]
        equal = frames["auto"] == frames["0"]
        print(f"phase 24 api.run {layers} walls KANI_OCC=auto: {gate}; "
              f"frames bit-equal to KANI_OCC=0 {equal}", flush=True)
        if len(gate) != 1 or not equal:
            fail(f"phase 24: api.run with KANI_OCC=auto, {layers} walls")
    return res


def band_row(rows: list, source: str, replaces: str) -> dict:
    """A band kernel's row of the kernels line: each number the mean over
    the bands, the error their maximum, bound_by that of the band with the
    largest bound."""
    return dict(source=source, replaces=replaces,
                max_abs_err=max(r["err"] for r in rows),
                **{f: statistics.mean(r[f] for r in rows)
                   for f in ("ms", "ms_median", "plain_ms", "bound_ms")},
                bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
                bands=len(rows))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    import dataclasses
    from kanirenderer_tpu_torch import flythrough
    from kanirenderer_tpu_torch.core.types import (RenderConfig, RenderMode,
                                                   camera_state,
                                                   default_lights,
                                                   frame_state)
    from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.ops import shade_cuda
    from kanirenderer_tpu_torch.ops.sampling import build_shadow_table
    from kanirenderer_tpu_torch.passes.frame import (SHADOW_MODES,
                                                     frame_geometry,
                                                     render_frame)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})", flush=True)
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rc.load_kernels()
    regs = [ln.strip() for ln in rc.build_info.get("ptxas", "").splitlines()
            if "registers" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
          f"(cached={rc.build_info['cached']}) ptxas: {regs}", flush=True)

    cfg = flythrough.BENCH_CONFIG
    scene = sponza_standin_scene(device=dev)
    lights = default_lights(device=dev)
    cam0 = flythrough.BENCH_CAM0
    state = frame_state(scene, camera_state(cam0.position, cam0.yaw,
                                            cam0.pitch, dev), lights)
    g = frame_geometry(scene, state, cfg)
    D, W, H = cfg.shadow_dim, cfg.width, cfg.height
    kernels = {}

    # ---- phase 3: K1 against its plain version ----
    sh = g.shadow_setup
    k1 = rc.rasterize_depth(sh.setup, sh.bbox, g.shadow_bins, D)
    p1 = rc.rasterize_depth_plain(sh.setup, sh.bbox, g.shadow_bins, D)
    torch.cuda.synchronize()
    err1 = (k1 - p1).abs().max().item()
    covered1 = (k1 < 1.0).float().mean().item()
    eager1 = cuda_ms(lambda: rc.rasterize_depth(sh.setup, sh.bbox,
                                                g.shadow_bins, D), 20)
    ms1, med1 = graph_ms(lambda: rc.rasterize_depth(sh.setup, sh.bbox,
                                                    g.shadow_bins, D))
    pms1 = cuda_ms(lambda: rc.rasterize_depth_plain(sh.setup, sh.bbox,
                                                    g.shadow_bins, D), 2)
    hits1, _, _ = raster_work(sh.setup, sh.bbox, g.shadow_bins, D, D)
    b = g.shadow_bins
    print(f"phase 3 K1 {D}x{D}: max|kernel-plain| {err1:.3g} "
          f"(tol {K1_TOL}), bit-equal {torch.equal(k1, p1)}, covered "
          f"{covered1:.3f}, {grid_stats(b, hits1)}, "
          f"{timing(ms1, med1, eager1)} vs plain {pms1:.1f} ms", flush=True)
    if not torch.equal(k1, p1) or covered1 <= 0.0:
        fail("K1 disagrees with its plain version")
    kernels["rasterize_depth"] = dict(
        source="kanirenderer_tpu_torch/csrc/raster_depth.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:410",
        max_abs_err=err1, ms=ms1, ms_median=med1, ms_eager=eager1,
        plain_ms=pms1,
        bytes=nbytes(sh.setup, sh.bbox, b.pair_tile, b.chunk, k1),
        ops=hits1 * OPS_COVER)

    # ---- phase 4: K2 against its plain version ----
    cs = g.setup
    k2 = rc.rasterize_pixels(g.records, cs.setup, cs.bbox, g.bins, W, H)
    p2 = rc.rasterize_pixels_plain(g.records, cs.setup, cs.bbox, g.bins, W,
                                   H)
    torch.cuda.synchronize()
    differ = pixels_differ(k2, p2)
    err2 = pixels_err(k2, p2)
    eager2 = cuda_ms(lambda: rc.rasterize_pixels(
        g.records, cs.setup, cs.bbox, g.bins, W, H), 20)
    ms2, med2 = graph_ms(lambda: rc.rasterize_pixels(
        g.records, cs.setup, cs.bbox, g.bins, W, H))
    pms2 = cuda_ms(lambda: rc.rasterize_pixels_plain(
        g.records, cs.setup, cs.bbox, g.bins, W, H), 2)
    hits2, _, _ = raster_work(cs.setup, cs.bbox, g.bins, W, H)
    b = g.bins
    print(f"phase 4 K2 {W}x{H}: outputs not bit-equal {differ} (tol "
          f"{K2_TOL}), max|kernel-plain| {err2:.3g}, covered "
          f"{k2.mask.float().mean().item():.3f}, {grid_stats(b, hits2)}, "
          f"{timing(ms2, med2, eager2)} vs plain {pms2:.1f} ms", flush=True)
    if differ or not k2.mask.any():
        fail("K2 disagrees with its plain version")
    px_out = nbytes(k2.z, k2.varyings, k2.mat_id) + 5 * nbytes(k2.mat_id)
    kernels["rasterize_pixels"] = dict(
        source="kanirenderer_tpu_torch/csrc/raster_pixels.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:759",
        max_abs_err=err2, ms=ms2, ms_median=med2, ms_eager=eager2,
        plain_ms=pms2,
        bytes=nbytes(g.records, cs.setup, cs.bbox, b.start, b.count, b.chunk)
        + px_out,
        ops=hits2 * OPS_COVER + int(k2.mask.sum()) * OPS_K2_PIXEL)

    # ---- phase 4: the shading kernel on K2's pixels ----
    shade_args = (scene, state, cfg, k2, build_shadow_table(k1), g.light_vp)
    ks = shade_cuda.shade_surface(*shade_args)
    ps = shade_cuda.shade_surface_plain(*shade_args)
    torch.cuda.synchronize()
    diff = (ks.int() - ps.int()).abs()
    errs, off = int(diff.max()), (diff > 0).double().mean().item()
    clear_equal = torch.equal(ks[~k2.mask], ps[~k2.mask])
    eagers = cuda_ms(lambda: shade_cuda.shade_surface(*shade_args), 20)
    mss, meds = graph_ms(lambda: shade_cuda.shade_surface(*shade_args))
    pmss = cuda_ms(lambda: shade_cuda.shade_surface_plain(*shade_args), 2)
    print(f"phase 4 shade kernel {W}x{H}: max|kernel-plain| {errs} levels "
          f"(tol {SHADE_TOL}), values off {off:.2e} (tol {SHADE_OFF}), "
          f"uncovered pixels bit-equal {clear_equal}, "
          f"{timing(mss, meds, eagers)} vs plain {pmss:.1f} ms", flush=True)
    if errs > SHADE_TOL or off > SHADE_OFF or not clear_equal:
        fail("the shading kernel disagrees with the plain chain")
    # Its bound: each pixel's planes read once and the surface written.
    kernels["shade_forward"] = dict(
        source="kanirenderer_tpu_torch/csrc/shade_forward.cu",
        replaces="none: plain tensor code (kanirenderer_tpu/shade/"
        "forward.py shade_lit, the encode of passes/frame.py render_band)",
        max_abs_err=errs, ms=mss, ms_median=meds, ms_eager=eagers,
        plain_ms=pmss,
        bytes=nbytes(k2.varyings, k2.tex_w, k2.tex_h, k2.blk_base, k2.blk_w,
                     k2.mask, ks),
        ops=0)
    del k1, p1, k2, p2, ks, ps, shade_args

    # ---- phase 5: small frame, kernels against the plain CPU path ----
    small_cfg = RenderConfig(width=256, height=192, shadow_dim=256,
                             output_u8=True)
    small_scenes = {}
    for key, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        sc = sponza_standin_scene(target_tris=6000, num_materials=4,
                                  tex_size=32, device=d)
        small_scenes[key] = (sc, frame_state(
            sc, camera_state(cam0.position, cam0.yaw, cam0.pitch, d),
            default_lights(device=d)))

    def small_frame(c):
        imgs = {k: render_frame(sc, st, c).image.cpu()
                for k, (sc, st) in small_scenes.items()}
        return golden_diff(imgs["cpu"], imgs["cuda"])

    frac8, mean = small_frame(small_cfg)
    print(f"phase 5 small frame cuda vs cpu: >8 levels {frac8:.5f} "
          f"(tol {GOLD_FRAC8}), mean {mean:.4f} (tol {GOLD_MEAN})",
          flush=True)
    if not (frac8 < GOLD_FRAC8 and mean < GOLD_MEAN):
        fail("small frame through the kernels disagrees with the CPU path")

    # ---- phase 6: the main path ----
    device_state("before phase 6")
    cams = flythrough.camera_path(WARMUP + FRAMES)
    rc.reset_launch_counts()
    ms, overflow, out = [], 0, None
    for out, t in flythrough.fly(scene, cfg, cams, lights):
        ms.append(t)
        overflow = max(overflow, int(out.raster_overflow))
    counts = dict(rc.launch_counts)
    n = WARMUP + FRAMES
    img = out.image
    covered = (out.depth < 1.0).float().mean().item()
    std = img.float().std().item()
    med = statistics.median(ms[WARMUP:])
    print(f"phase 6 main path: {n} frames {W}x{H} LIT_SHADOW fresh {D}² "
          f"shadow, launches {counts}, overflow {overflow}, "
          f"image {tuple(img.shape)} {img.dtype} std {std:.2f}, "
          f"covered {covered:.3f}", flush=True)
    if counts != launches(rasterize_depth=n, rasterize_pixels=n,
                          shade_forward=n):
        fail(f"launch counts {counts} != {n} per kernel")
    if overflow:
        fail(f"binning dropped {overflow} chunks")
    if (tuple(img.shape) != (H, W, 3) or img.dtype != torch.uint8
            or std < 1.0 or not 0.2 <= covered <= 1.0):
        fail("implausible frame")
    print(f"median frame {med:.2f} ms over {FRAMES} frames "
          f"(min {min(ms[WARMUP:]):.2f}, max {max(ms[WARMUP:]):.2f}) "
          f"on {card}", flush=True)
    device_state("after phase 6")
    kernels["rasterize_depth"]["launches"] = counts["rasterize_depth"]
    kernels["rasterize_pixels"]["launches"] = counts["rasterize_pixels"]
    kernels["shade_forward"]["launches"] = counts["shade_forward"]

    # ---- phase 7: K2w against its plain version ----
    wcfg = flythrough.MODE_CONFIGS["wireframe"]
    gw = frame_geometry(scene, state, wcfg)
    thresh = wcfg.wire_thresh_px
    max_chunks = int(gw.bins.count.max())
    ws = gw.setup
    k2w = rc.rasterize_pixels(gw.records, ws.setup, ws.bbox, gw.bins, W, H,
                              True, thresh)
    p2w = rc.rasterize_pixels_plain(gw.records, ws.setup, ws.bbox, gw.bins,
                                    W, H, True, thresh)
    torch.cuda.synchronize()
    differ = pixels_differ(k2w, p2w)
    err2w = pixels_err(k2w, p2w)
    eager2w = cuda_ms(lambda: rc.rasterize_pixels(
        gw.records, ws.setup, ws.bbox, gw.bins, W, H, True, thresh), 20)
    ms2w, med2w = graph_ms(lambda: rc.rasterize_pixels(
        gw.records, ws.setup, ws.bbox, gw.bins, W, H, True, thresh))
    pms2w = cuda_ms(lambda: rc.rasterize_pixels_plain(
        gw.records, ws.setup, ws.bbox, gw.bins, W, H, True, thresh), 2)
    hits2w, cov2w, pass2w = raster_work(ws.setup, ws.bbox, gw.bins, W, H,
                                        thresh)
    b = gw.bins
    tile_hits2w = hits2w // (b.tile_w * b.tile_h)
    print(f"phase 7 K2w {W}x{H}: outputs not bit-equal {differ} (tol "
          f"{K2_TOL}), max|kernel-plain| {err2w:.3g}, covered "
          f"{k2w.mask.float().mean().item():.3f}, {grid_stats(b, hits2w)}, "
          f"largest tile {max_chunks} chunks (cap "
          f"{wcfg.max_chunks_per_tile}), overflow {int(b.overflow)}, of "
          f"{hits2w} bbox-hit evaluations {cov2w} pass the five planes and "
          f"{pass2w} the threshold too, "
          f"{timing(ms2w, med2w, eager2w)} vs plain {pms2w:.1f} ms",
          flush=True)
    if differ or not k2w.mask.any():
        fail("K2w disagrees with its plain version")
    if int(b.overflow):
        fail("wireframe binning dropped chunks")
    kernels["rasterize_pixels_wireframe"] = dict(
        source="kanirenderer_tpu_torch/csrc/raster_pixels.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:831",
        max_abs_err=err2w, ms=ms2w, ms_median=med2w, ms_eager=eager2w,
        plain_ms=pms2w,
        bytes=nbytes(gw.records, ws.setup, ws.bbox, b.start, b.count,
                     b.chunk) + px_out,
        ops=hits2w * OPS_COVER + cov2w * OPS_WIRE + tile_hits2w * OPS_SCALES
        + int(k2w.mask.sum()) * OPS_K2_PIXEL)
    del k2w, p2w

    # ---- phase 8: K3 against its plain version ----
    k3_err = 0.0
    for wire, gg in ((False, g), (True, gw)):
        st = gg.setup
        k3 = rc.rasterize(st.setup, st.bbox, gg.bins, W, H, wire, thresh)
        p3 = rc.rasterize_plain(st.setup, st.bbox, gg.bins, W, H, wire,
                                thresh)
        torch.cuda.synchronize()
        differ = [f for f, a, b in zip(k3._fields, k3, p3)
                  if not torch.equal(a, b)]
        err3 = max((k3.z - p3.z).abs().max().item(),
                   (k3.bary - p3.bary).abs().max().item())
        eager3 = cuda_ms(lambda: rc.rasterize(
            st.setup, st.bbox, gg.bins, W, H, wire, thresh), 20)
        ms3, med3 = graph_ms(lambda: rc.rasterize(
            st.setup, st.bbox, gg.bins, W, H, wire, thresh))
        pms3 = cuda_ms(lambda: rc.rasterize_plain(
            st.setup, st.bbox, gg.bins, W, H, wire, thresh), 2)
        print(f"phase 8 K3 {W}x{H} wireframe={wire}: outputs not bit-equal "
              f"{differ} (tol {K3_TOL}), max|kernel-plain| {err3:.3g}, "
              f"covered {(k3.tri >= 0).float().mean().item():.3f}, "
              f"{timing(ms3, med3, eager3)} vs plain {pms3:.1f} ms",
              flush=True)
        if differ or not (k3.tri >= 0).any():
            fail(f"K3 (wireframe={wire}) disagrees with its plain version")
        k3_err = max(k3_err, err3)
        bb = gg.bins
        bytes3 = nbytes(st.setup, st.bbox, bb.start, bb.count, bb.chunk,
                        k3.tri, k3.z, k3.bary)
        ops3 = int((k3.tri >= 0).sum()) * OPS_K3_PIXEL
        if wire:  # gw's bins: the work counted in phase 7
            ops3 += hits2w * OPS_COVER + cov2w * OPS_WIRE \
                + tile_hits2w * OPS_SCALES
            b_ms, b_by = bound(bytes3, ops3)
            kernels["rasterize_visibility"].update(
                ms_wireframe=ms3, ms_median_wireframe=med3,
                ms_eager_wireframe=eager3, plain_ms_wireframe=pms3,
                bound_ms_wireframe=b_ms, bound_by_wireframe=b_by)
        else:     # g's bins: phase 4
            kernels["rasterize_visibility"] = dict(
                source="kanirenderer_tpu_torch/csrc/raster_visibility.cu",
                replaces="kanirenderer_tpu/ops/raster_pallas.py:410",
                ms=ms3, ms_median=med3, ms_eager=eager3, plain_ms=pms3,
                bytes=bytes3,
                ops=ops3 + hits2 * OPS_COVER)
        del k3, p3
    kernels["rasterize_visibility"]["max_abs_err"] = k3_err

    # ---- phase 9: small frame of every other configuration ----
    for name, mcfg in flythrough.MODE_CONFIGS.items():
        frac8, mean = small_frame(dataclasses.replace(
            mcfg, width=256, height=192, shadow_dim=256))
        print(f"phase 9 small frame {name} cuda vs cpu: >8 levels "
              f"{frac8:.5f} (tol {GOLD_FRAC8}), mean {mean:.4f} "
              f"(tol {GOLD_MEAN})", flush=True)
        if not (frac8 < GOLD_FRAC8 and mean < GOLD_MEAN):
            fail(f"small {name} frame through the kernels disagrees with "
                 "the CPU path")

    # ---- phase 10: every mode on the main path ----
    device_state("before phase 10")
    n = WARMUP + MODE_FRAMES
    cams = flythrough.camera_path(n)
    medians = {}
    for name, mcfg in flythrough.MODE_CONFIGS.items():
        rc.reset_launch_counts()
        ms, overflow = [], 0
        for out, t in flythrough.fly(scene, mcfg, cams, lights):
            ms.append(t)
            overflow = max(overflow, int(out.raster_overflow))
        counts = dict(rc.launch_counts)
        wire = mcfg.mode == RenderMode.WIREFRAME
        # The shading kernel: LIT and HDR; the others keep the plain chain.
        want = launches(rasterize_depth=n * (mcfg.mode in SHADOW_MODES),
                        rasterize_pixels=0 if wire else n,
                        rasterize_pixels_wireframe=n if wire else 0,
                        shade_forward=n if name in ("lit", "hdr") else 0)
        img = out.image
        p = mcfg.present_scale
        dtype = torch.float16 if mcfg.hdr else torch.uint8
        std = image_std(img)
        medians[name] = statistics.median(ms[WARMUP:])
        print(f"phase 10 {name}: median {medians[name]:.2f} ms (min "
              f"{min(ms[WARMUP:]):.2f}, max {max(ms[WARMUP:]):.2f}) over "
              f"{MODE_FRAMES} frames, launches {counts}, overflow "
              f"{overflow}, image {tuple(img.shape)} {img.dtype} std "
              f"{std:.2f}", flush=True)
        if counts != want:
            fail(f"{name}: launch counts {counts} != {want}")
        if overflow:
            fail(f"{name}: binning dropped {overflow} chunks")
        if (tuple(img.shape) != (H // p, W // p, 3) or img.dtype != dtype
                or std < 1.0):
            fail(f"{name}: implausible frame")
        if wire:
            kernels["rasterize_pixels_wireframe"]["launches"] = \
                counts["rasterize_pixels_wireframe"]
    print(f"per-mode frame medians ms {json.dumps(medians)} on {card}",
          flush=True)
    device_state("after phase 10")

    # ---- phase 11: the visibility entry ----
    rc.reset_launch_counts()
    covered = []
    for cam in cams[WARMUP:]:
        st_cam = frame_state(scene, camera_state(cam.position, cam.yaw,
                                                 cam.pitch, dev), lights)
        for mcfg in (cfg, wcfg):
            st = frame_geometry(scene, st_cam, mcfg).setup
            vis = rc.rasterize_config(st, mcfg,
                                      mcfg.mode == RenderMode.WIREFRAME)
            covered.append((vis.tri >= 0).float().mean().item())
    torch.cuda.synchronize()
    counts = dict(rc.launch_counts)
    print(f"phase 11 rasterize_config: {MODE_FRAMES} poses x wireframe "
          f"False/True, launches {counts}, covered "
          f"{min(covered):.3f}-{max(covered):.3f}", flush=True)
    if counts["rasterize_visibility"] != 2 * MODE_FRAMES \
            or min(covered) <= 0.0:
        fail("the visibility entry did not rasterize through K3")
    kernels["rasterize_visibility"]["launches"] = \
        counts["rasterize_visibility"]

    # ---- phase 12: adversarial cases, kernels against plain versions ----
    from kanirenderer_tpu_torch.ops import raster_cases
    for case, sq in zip(raster_cases.adversarial_cases(dev),
                        raster_cases.adversarial_cases(dev, square=True)):
        differ = []
        for wire in (False, True):
            args = (case.setup, case.bbox, case.bins, case.width,
                    case.height, wire, raster_cases.WIRE_THRESH)
            k = rc.rasterize_pixels(case.records, *args)
            p = rc.rasterize_pixels_plain(case.records, *args)
            k3, p3 = rc.rasterize(*args), rc.rasterize_plain(*args)
            torch.cuda.synchronize()
            differ += [f"{'K2w' if wire else 'K2'}.{f}"
                       for f in pixels_differ(k, p)]
            differ += [f"{'K3w' if wire else 'K3'}.{f}"
                       for f, a, b in zip(k3._fields, k3, p3)
                       if not torch.equal(a, b)]
            won = k.tid[k.mask].to(torch.int64)
            if not k.mask.any() or not case.kept[won].all():
                fail(f"phase 12 {case.name}: implausible winners")
        k1 = rc.rasterize_depth(sq.setup, sq.bbox, sq.bins, sq.width)
        p1 = rc.rasterize_depth_plain(sq.setup, sq.bbox, sq.bins, sq.width)
        torch.cuda.synchronize()
        if not torch.equal(k1, p1):
            differ.append("K1")
        b = case.bins
        print(f"phase 12 {case.name}: {case.width}x{case.height} (K1 "
              f"{sq.width}²), {case.setup.shape[0]} triangles, chunks per "
              f"tile max {int(b.count.max())}, "
              f"{int((b.count == 0).sum())} of {b.count.numel()} tiles "
              f"empty, overflow {int(b.overflow)}, rows with NaN "
              f"{int(case.setup.isnan().any(1).sum())}, with infinities "
              f"{int(case.setup.isinf().any(1).sum())}, wireframe covered "
              f"{k.mask.float().mean().item():.3f}, outputs not bit-equal "
              f"{differ}", flush=True)
        if differ:
            fail(f"phase 12 {case.name}: kernels disagree with their plain "
                 "versions")
        occ_cases(case, sq, card)


    # ---- phases 13-19: the application path (its files kept for 25) ----
    app_dir = tempfile.mkdtemp(prefix="kani_smoke_")
    try:
        app_counts = application_path(app_dir, card)
        for name, k in kernels.items():
            k.update({f"launches_{run}": c[name]
                      for run, c in app_counts.items()})

        # ---- phases 20-23: row bands ----
        band_kernels(scene, state, cfg, flythrough.MODE_CONFIGS["wireframe"],
                     kernels)
        device_state("before phase 21")
        whole = banded_frames(scene, state, kernels, card)
        band_times(scene, state, card)
        device_state("after phase 22")
        forms = [("gloo", 2, "2 gloo ranks sharing card 0")]
        if torch.cuda.device_count() >= 2:
            forms.append(("nccl", 2, "2 NCCL ranks, a card each"))
        else:
            print("phase 23 NCCL: not run, this host has one card", flush=True)
        distributed_form(whole, card, forms)
        from kanirenderer_tpu_torch.parallel.mesh import dryrun_multichip
        dryrun_multichip(2)

        # ---- phase 24: occlusion ----
        tmp = tempfile.mkdtemp(prefix="kani_smoke_occ_")
        try:
            occ = occlusion(scene, state, g, cfg,
                            flythrough.MODE_CONFIGS["wireframe"], card, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        kernels["rasterize_depth"].update(
            ms_skip_off=occ["K1"]["ms_off"], skipped_share=occ["K1"]["share"])
        kernels["rasterize_depth_band"].update(
            ms_skip_off=statistics.mean(occ[f"K1 band {k}/4"]["ms_off"]
                                        for k in range(4)),
            skipped_share=statistics.mean(occ[f"K1 band {k}/4"]["share"]
                                          for k in range(4)))
        for name, key in (("rasterize_pixels_band", "K2 band"),
                          ("rasterize_pixels_wireframe_band", "K2w band")):
            kernels[name].update(
                ms_skip_on_layered=occ[f"{key} layered"]["ms_on"],
                ms_skip_off_layered=occ[f"{key} layered"]["ms_off"],
                skipped_share_layered=occ[f"{key} layered"]["share"])
        for name, key in (("rasterize_pixels", "K2"),
                          ("rasterize_pixels_wireframe", "K2w"),
                          ("rasterize_visibility", "K3"),
                          ("rasterize_visibility", "K3w")):
            sfx = "_wireframe" if key == "K3w" else ""
            for where in ("bench pose", "layered"):
                w = where.split()[0]
                kernels[name].update({
                    f"ms_skip_on_{w}{sfx}": occ[f"{key} {where}"]["ms_on"],
                    f"ms_skip_off_{w}{sfx}": occ[f"{key} {where}"]["ms_off"],
                    f"skipped_share_{w}{sfx}": occ[f"{key} {where}"]["share"]})
        if not (kernels["rasterize_depth"]["launches_loop_steady"]
                and kernels["rasterize_pixels"]["launches_loop_steady"]
                and kernels["rasterize_pixels_wireframe"]["launches_events"]):
            fail("a kernel of the application path was never launched on it")

        # ---- phase 25: the C ABI ----
        abi_counts = c_abi(app_dir, card)
        for name, k in kernels.items():
            k["launches_c_abi"] = abi_counts[name]
    finally:
        shutil.rmtree(app_dir, ignore_errors=True)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    rows = []
    for name, k in kernels.items():
        if "bytes" in k:    # the band rows carry their bands' mean bound
            k["bound_ms"], k["bound_by"] = bound(k.pop("bytes"),
                                                 k.pop("ops"))
        # No single PyTorch call rasterizes triangles.
        k.update(name=name, route="cuda", library_ms=None)
        if not k.get("launches"):
            fail(f"{name} was never launched on its path")
        # K3's row also carries its wireframe variant's numbers; every
        # row the launches of the application path's runs (phases 14, 15
        # and 17).
        rows.append({f: k[f] for f in (*order, *(
            f for f in k if f.endswith("_wireframe") or f == "bands"
            or f.startswith(("launches_", "ms_", "skipped_share"))
            and f not in order))})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
