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
     1920×1080, same pose, bit-equal; the same counts of its grid;
  5. small frame: the whole LIT_SHADOW frame through the kernels against
     the plain path on the CPU (256×192, small stand-in), golden criterion;
  6. main path: 3 warm-up + 30 fly-through frames at 1920×1080 with a
     fresh 2048² shadow map, both kernels launched once per frame;
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
     wireframe interiors, infinite and overflowing coefficients),
     bit-equal.
Then a JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

WARMUP, FRAMES = 3, 30
MODE_FRAMES = 10
# Kernel vs plain version, same inputs on the card.  Both evaluate every
# plane in the same order with no fused multiply-add, so every kernel must
# be bit-equal (tolerance 0: torch.equal on every output).
K1_TOL = K2_TOL = K3_TOL = 0.0
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


def raster_work(rows, bbox, bins, width, height, wire_thresh=None):
    """(triangle, pixel) evaluations the kernel makes on these inputs: the
    bbox-hitting triangles of every (tile, chunk) pair × tile pixels, and
    with ``wire_thresh`` the evaluations whose five-plane coverage holds
    (where the kernel goes on to the edge distances) and those of them
    within the threshold of an edge."""
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    tile, chunk = rc._pairs(bins)
    hits = covered = passed = 0
    for s in range(0, tile.shape[0], rc.PAIR_BATCH):
        t, c = tile[s:s + rc.PAIR_BATCH], chunk[s:s + rc.PAIR_BATCH]
        _, hit = rc._bbox_hits(bbox, t, c, bins)
        hits += int(hit.sum()) * bins.tile_w * bins.tile_h
        if wire_thresh is not None:
            cov, _, _ = rc._eval_pairs(rows, bbox, t, c, bins, width, height)
            covered += int(cov.sum())
            cov, _, _ = rc._eval_pairs(rows, bbox, t, c, bins, width, height,
                                       wire_thresh)
            passed += int(cov.sum())
    return hits, covered, passed


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
    ms1 = cuda_ms(lambda: rc.rasterize_depth(sh.setup, sh.bbox,
                                             g.shadow_bins, D), 20)
    pms1 = cuda_ms(lambda: rc.rasterize_depth_plain(sh.setup, sh.bbox,
                                                    g.shadow_bins, D), 2)
    hits1, _, _ = raster_work(sh.setup, sh.bbox, g.shadow_bins, D, D)
    b = g.shadow_bins
    print(f"phase 3 K1 {D}x{D}: max|kernel-plain| {err1:.3g} "
          f"(tol {K1_TOL}), bit-equal {torch.equal(k1, p1)}, covered "
          f"{covered1:.3f}, {grid_stats(b, hits1)}, "
          f"{ms1:.3f} ms vs plain {pms1:.1f} ms", flush=True)
    if not torch.equal(k1, p1) or covered1 <= 0.0:
        fail("K1 disagrees with its plain version")
    kernels["rasterize_depth"] = dict(
        source="kanirenderer_tpu_torch/csrc/raster_depth.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:410",
        max_abs_err=err1, ms=ms1, plain_ms=pms1,
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
    ms2 = cuda_ms(lambda: rc.rasterize_pixels(g.records, cs.setup, cs.bbox,
                                              g.bins, W, H), 20)
    pms2 = cuda_ms(lambda: rc.rasterize_pixels_plain(
        g.records, cs.setup, cs.bbox, g.bins, W, H), 2)
    hits2, _, _ = raster_work(cs.setup, cs.bbox, g.bins, W, H)
    b = g.bins
    print(f"phase 4 K2 {W}x{H}: outputs not bit-equal {differ} (tol "
          f"{K2_TOL}), max|kernel-plain| {err2:.3g}, covered "
          f"{k2.mask.float().mean().item():.3f}, {grid_stats(b, hits2)}, "
          f"{ms2:.3f} ms vs plain {pms2:.1f} ms", flush=True)
    if differ or not k2.mask.any():
        fail("K2 disagrees with its plain version")
    px_out = nbytes(k2.z, k2.varyings, k2.mat_id) + 5 * nbytes(k2.mat_id)
    kernels["rasterize_pixels"] = dict(
        source="kanirenderer_tpu_torch/csrc/raster_pixels.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:759",
        max_abs_err=err2, ms=ms2, plain_ms=pms2,
        bytes=nbytes(g.records, cs.setup, cs.bbox, b.start, b.count, b.chunk)
        + px_out,
        ops=hits2 * OPS_COVER + int(k2.mask.sum()) * OPS_K2_PIXEL)
    del k1, p1, k2, p2

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
    if counts != {"rasterize_depth": n, "rasterize_pixels": n,
                  "rasterize_pixels_wireframe": 0,
                  "rasterize_visibility": 0}:
        fail(f"launch counts {counts} != {n} per kernel")
    if overflow:
        fail(f"binning dropped {overflow} chunks")
    if (tuple(img.shape) != (H, W, 3) or img.dtype != torch.uint8
            or std < 1.0 or not 0.2 <= covered <= 1.0):
        fail("implausible frame")
    print(f"median frame {med:.2f} ms over {FRAMES} frames "
          f"(min {min(ms[WARMUP:]):.2f}, max {max(ms[WARMUP:]):.2f}) "
          f"on {card}", flush=True)
    kernels["rasterize_depth"]["launches"] = counts["rasterize_depth"]
    kernels["rasterize_pixels"]["launches"] = counts["rasterize_pixels"]

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
    ms2w = cuda_ms(lambda: rc.rasterize_pixels(
        gw.records, ws.setup, ws.bbox, gw.bins, W, H, True, thresh), 20)
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
          f"{ms2w:.3f} ms vs plain {pms2w:.1f} ms", flush=True)
    if differ or not k2w.mask.any():
        fail("K2w disagrees with its plain version")
    if int(b.overflow):
        fail("wireframe binning dropped chunks")
    kernels["rasterize_pixels_wireframe"] = dict(
        source="kanirenderer_tpu_torch/csrc/raster_pixels.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:831",
        max_abs_err=err2w, ms=ms2w, plain_ms=pms2w,
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
        ms3 = cuda_ms(lambda: rc.rasterize(
            st.setup, st.bbox, gg.bins, W, H, wire, thresh), 20)
        pms3 = cuda_ms(lambda: rc.rasterize_plain(
            st.setup, st.bbox, gg.bins, W, H, wire, thresh), 2)
        print(f"phase 8 K3 {W}x{H} wireframe={wire}: outputs not bit-equal "
              f"{differ} (tol {K3_TOL}), max|kernel-plain| {err3:.3g}, "
              f"covered {(k3.tri >= 0).float().mean().item():.3f}, "
              f"{ms3:.3f} ms vs plain {pms3:.1f} ms", flush=True)
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
                ms_wireframe=ms3, plain_ms_wireframe=pms3,
                bound_ms_wireframe=b_ms, bound_by_wireframe=b_by)
        else:     # g's bins: phase 4
            kernels["rasterize_visibility"] = dict(
                source="kanirenderer_tpu_torch/csrc/raster_visibility.cu",
                replaces="kanirenderer_tpu/ops/raster_pallas.py:410",
                ms=ms3, plain_ms=pms3, bytes=bytes3,
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
        want = {"rasterize_depth": n * (mcfg.mode in SHADOW_MODES),
                "rasterize_pixels": 0 if wire else n,
                "rasterize_pixels_wireframe": n if wire else 0,
                "rasterize_visibility": 0}
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

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    rows = []
    for name, k in kernels.items():
        k["bound_ms"], k["bound_by"] = bound(k.pop("bytes"), k.pop("ops"))
        # No single PyTorch call rasterizes triangles.
        k.update(name=name, route="cuda", library_ms=None)
        if not k.get("launches"):
            fail(f"{name} was never launched on its path")
        # K3's row also carries its wireframe variant's numbers.
        rows.append({f: k[f] for f in (*order, *(
            f for f in k if f.endswith("_wireframe")))})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
