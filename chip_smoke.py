#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kanirenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device: needs CUDA; prints the nvidia-smi name/power-limit line;
  2. build: compiles the raster kernels from csrc/ with nvcc (sm_90a);
  3. K1 (shadow depth raster) against its plain PyTorch version on the
     full-size sponza stand-in, 2048² map, bench pose;
  4. K2 (fused raster + interpolation) against its plain version at
     1920×1080, same pose;
  5. small frame: the whole frame through the kernels against the plain
     path on the CPU (256×192, small stand-in), golden criterion;
  6. main path: 3 warm-up + 30 fly-through frames at 1920×1080 with a
     fresh 2048² shadow map, both kernels launched once per frame.
Then a JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

WARMUP, FRAMES = 3, 30
# Kernel vs plain version, same inputs on the card.  Both evaluate every
# plane in the same order with no fused multiply-add, so K1 and the K2
# depth are expected bit-equal; the K2 bounds are the parity bounds the
# reference's own raster tests use (test_binning_pallas.py:79-84).
K1_TOL = 0.0
K2_TID_FRAC, K2_Z_TOL, K2_VARY_TOL = 0.002, 1e-6, 1e-4


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    from kanirenderer_tpu_torch import flythrough
    from kanirenderer_tpu_torch.core.types import (RenderConfig,
                                                   camera_state,
                                                   default_lights,
                                                   frame_state)
    from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
    from kanirenderer_tpu_torch.ops import raster_cuda as rc
    from kanirenderer_tpu_torch.passes.frame import (frame_geometry,
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
    kernels = []

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
    print(f"phase 3 K1 {D}x{D}: max|kernel-plain| {err1:.3g} "
          f"(tol {K1_TOL}), covered {covered1:.3f}, "
          f"bin pairs {int(g.shadow_bins.count.sum())}, "
          f"{ms1:.3f} ms vs plain {pms1:.1f} ms", flush=True)
    if not err1 <= K1_TOL or covered1 <= 0.0:
        fail("K1 disagrees with its plain version")
    kernels.append(dict(
        name="rasterize_depth", route="cuda",
        source="kanirenderer_tpu_torch/csrc/raster_depth.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:410",
        max_abs_err=err1, ms=ms1, plain_ms=pms1))

    # ---- phase 4: K2 against its plain version ----
    k2 = rc.rasterize_pixels(g.records, g.setup.bbox, g.bins, W, H)
    p2 = rc.rasterize_pixels_plain(g.records, g.setup.bbox, g.bins, W, H)
    torch.cuda.synchronize()
    if not torch.equal(k2.mask, p2.mask):
        fail("K2 coverage mask differs from its plain version")
    same = k2.tid == p2.tid
    tid_frac = 1.0 - same.float().mean().item()
    z_err = (k2.z - p2.z)[same].abs().max().item()
    v_err = (k2.varyings - p2.varyings)[:, same].abs().max().item()
    ints_ok = all(torch.equal(getattr(k2, f)[same], getattr(p2, f)[same])
                  for f in ("mat_id", "tex_w", "tex_h", "blk_base", "blk_w"))
    ms2 = cuda_ms(lambda: rc.rasterize_pixels(g.records, g.setup.bbox,
                                              g.bins, W, H), 20)
    pms2 = cuda_ms(lambda: rc.rasterize_pixels_plain(
        g.records, g.setup.bbox, g.bins, W, H), 2)
    print(f"phase 4 K2 {W}x{H}: tid differs {tid_frac:.5f} "
          f"(tol {K2_TID_FRAC}), z {z_err:.3g} (tol {K2_Z_TOL}), "
          f"varyings {v_err:.3g} (tol {K2_VARY_TOL}), ints equal {ints_ok}, "
          f"covered {k2.mask.float().mean().item():.3f}, "
          f"bin pairs {int(g.bins.count.sum())}, "
          f"{ms2:.3f} ms vs plain {pms2:.1f} ms", flush=True)
    if not (tid_frac <= K2_TID_FRAC and z_err <= K2_Z_TOL
            and v_err <= K2_VARY_TOL and ints_ok):
        fail("K2 disagrees with its plain version")
    kernels.append(dict(
        name="rasterize_pixels", route="cuda",
        source="kanirenderer_tpu_torch/csrc/raster_pixels.cu",
        replaces="kanirenderer_tpu/ops/raster_pallas.py:759",
        max_abs_err=max(z_err, v_err), ms=ms2, plain_ms=pms2))
    del k1, p1, k2, p2

    # ---- phase 5: small frame, kernels against the plain CPU path ----
    small_cfg = RenderConfig(width=256, height=192, shadow_dim=256,
                             output_u8=True)
    small = {}
    for d in (torch.device("cpu"), dev):
        sc = sponza_standin_scene(target_tris=6000, num_materials=4,
                                  tex_size=32, device=d)
        st = frame_state(sc, camera_state(cam0.position, cam0.yaw,
                                          cam0.pitch, d),
                         default_lights(device=d))
        small[d.type] = render_frame(sc, st, small_cfg).image.cpu()
    diff = (small["cpu"].int() - small["cuda"].int()).abs()
    frac8, mean = (diff > 8).float().mean().item(), diff.float().mean().item()
    print(f"phase 5 small frame cuda vs cpu: >8 levels {frac8:.5f} "
          f"(tol 0.01), mean {mean:.4f} (tol 1.5)", flush=True)
    if not (frac8 < 0.01 and mean < 1.5):
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
    if counts != {"rasterize_depth": n, "rasterize_pixels": n}:
        fail(f"launch counts {counts} != {n} per kernel")
    if overflow:
        fail(f"binning dropped {overflow} chunks")
    if (tuple(img.shape) != (H, W, 3) or img.dtype != torch.uint8
            or std < 1.0 or not 0.2 <= covered <= 1.0):
        fail("implausible frame")
    print(f"median frame {med:.2f} ms over {FRAMES} frames "
          f"(min {min(ms[WARMUP:]):.2f}, max {max(ms[WARMUP:]):.2f}) "
          f"on {card}", flush=True)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": [{f: k[f] for f in order}
                                  for k in kernels]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
