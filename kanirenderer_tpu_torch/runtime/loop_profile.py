"""What one frame of the interactive loop asks of the CUDA runtime.

    python -m kanirenderer_tpu_torch.runtime.loop_profile [frames]

Runs ``run_loop`` on the procedural sponza stand-in at 1920×1080,
LIT_SHADOW, on one card, once with the cached PCF table and once with a
fresh shadow map in every frame, under ``torch.profiler``.  The first
frames (placeholder table, table build, first-touch allocations) run
before the profiler starts.  Prints per frame the calls that make the
host wait for the device (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``), the copies and the
kernel launches, and the device's busy share: device time from the
profiler's footer over the wall time of the profiled frames.  The
profiler slows the host, so the wall time here is not a frame time.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time

import torch

from kanirenderer_tpu_torch.core.types import RenderConfig
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.runtime.loop import run_loop, scripted_flythrough

SKIP = 5
CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemsetAsync",
         "cudaLaunchKernel", "cuLaunchKernel")


def _to_ms(text: str) -> float:
    value, unit = re.match(r"([\d.]+)(us|ms|s)", text).groups()
    return float(value) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[unit]


def profile_loop(scene, frames: int, cache: bool) -> dict:
    """Per-frame runtime calls and device time of ``frames`` loop frames
    after ``SKIP`` unprofiled ones."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    started = []

    def events():
        for i, ev in enumerate(scripted_flythrough(SKIP + frames + 1)):
            if i == SKIP:
                torch.cuda.synchronize()
                prof.start()
                started.append(time.perf_counter())
            yield ev

    cfg = RenderConfig(width=1920, height=1080, cache_shadow_map=cache)
    stats = run_loop(scene, events(), config=cfg, sink_kind="null",
                     max_frames=SKIP + frames)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started[0]) * 1e3
    prof.stop()
    averages = prof.key_averages()
    counts = {e.key: e.count for e in averages if e.key in CALLS}
    footer = re.search(r"Self CUDA time total: (\S+)", averages.table())
    device_ms = _to_ms(footer.group(1)) if footer else float("nan")
    return dict(
        frames=stats["frames"] - SKIP,
        per_frame={k: counts.get(k, 0) / frames for k in CALLS},
        device_ms_per_frame=device_ms / frames,
        wall_ms_per_frame=wall_ms / frames,
        busy_share=device_ms / wall_ms)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    frames = int(argv[0]) if argv else 20
    if not torch.cuda.is_available():
        print("no CUDA device: the loop profile needs one GPU",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = sponza_standin_scene(device=torch.device("cuda", 0))
    for cache in (True, False):
        r = profile_loop(scene, frames, cache)
        calls = ", ".join(f"{k} {v:.1f}" for k, v in r["per_frame"].items())
        print(f"cache_shadow_map={cache}: {r['frames']} profiled frames; "
              f"per frame: {calls}; device {r['device_ms_per_frame']:.2f} "
              f"ms of {r['wall_ms_per_frame']:.2f} ms under the profiler "
              f"(busy share {r['busy_share']:.2f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
