"""The readings the limits of ``compare.py`` are set from, for one cell, in
one process: the program's sampled frames over many seeds against the
reference (the lower readings), and the control, the reference in
bfloat16 (``reference.frame.render_frame(lowp=True)``), in the program's
place on the same poses (the upper readings).

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds 4 [--control-seeds 1,2,3]

The scene is loaded once; each seed drives a window of ``--seconds`` at
the cell's own load.  One JSON line per seed and kind, then the largest
reading of the program and the smallest of the control.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import compare, run, scenefiles, traffic
from portbench.reference.frame import render_frame


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("calibration needs a CUDA device")
        return 3
    bench = run.load_json(run.BENCHMARK)
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg_file = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = run.load_json(run.HERE.parent / cfg_file["file"])
    mix = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    pcfg = run.render_config(config, mix)
    rcfg = run.reference_config(config, mix)
    lights = run.reference_lights(config, "cuda")
    directory = scenefiles.scene_dir(config)
    scene, builder = run.load_program_scene(config, directory, "cuda")
    samples = {}
    for seed in sorted(set(seeds) | set(control)):
        r, window, sink, overflow, t_end = run.drive(
            scene, builder, pcfg, run.point_lights(config), mix, seed,
            args.seconds, True)
        samples[seed] = sink.samples
        frames = r["frames"] - mix["warmup_frames"]
        print(json.dumps({"seed": seed, "kind": "window", "frames": frames,
                          "healed": r["healed"],
                          "overflow_frames": sum(1 for ov in overflow
                                                 if ov),
                          "frame_ms": (t_end - window.t0) * 1e3 / frames}),
              flush=True)
    del scene, builder
    gc.collect()
    torch.cuda.empty_cache()
    ref_scene = run.reference_scene(config, directory, "cuda")
    lows, ups = [], []
    for seed in seeds:
        w = compare.worst(run.check_samples(ref_scene, rcfg, mix, seed,
                                            samples[seed], lights))
        lows.append(w)
        print(json.dumps({"seed": seed, "kind": "program", **w}), flush=True)
    for seed in control:
        poses = traffic.poses(mix, seed, max(g for g, _ in samples[seed]) + 1)
        frames = [(g, render_frame(ref_scene, poses[g], rcfg, lowp=True,
                                   lights=lights))
                  for g, _ in samples[seed]]
        w = compare.worst(run.check_samples(ref_scene, rcfg, mix, seed,
                                            frames, lights))
        ups.append(w)
        print(json.dumps({"seed": seed, "kind": "control", **w}), flush=True)
    summary = {k: {"lower": max(x[k] for x in lows) if lows else None,
                   "upper": min(x[k] for x in ups) if ups else None,
                   "limit": compare.LIMITS[k]} for k in compare.LIMITS}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
