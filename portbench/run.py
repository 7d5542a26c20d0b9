"""The benchmark of kanirenderer_tpu_torch: one cell of BENCHMARK.json, one
process, one result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell is a configuration (``configs/<name>.json``: the scene, the
surface and, with ``point_lights``, the light rig) under a traffic mix
(``traffic/<name>.json``: the mode and the fly-through's parameters);
either may add a ``render`` object of RenderConfig fields, applied alike
to the program's and the reference's.  The run:

1. writes the configuration's scene, made by the generator that its
   ``geometry.generator`` names (``scenes/<name>.py``), as OBJ + MTL + PNG
   files once per checkout (``scenefiles.py``) and loads them with the
   program's ``api.load_model_or_default``, checking the triangle and
   material counts (the loader falls back to a cube where a load fails);
2. drives the program's interactive loop, ``runtime.loop.run_loop``, with
   the configuration's ``point_lights``, the mix's events (``traffic.py``;
   F1 in the first frame leaves the loop's 60 Hz cap), a fixed 1/60 s
   controller step and a sink that keeps a copy of a few presented frames,
   drawn from the seed;
3. warms up for the mix's ``warmup_frames``, synchronises, and measures
   every frame of ``--seconds`` seconds back to back (closed loop), then
   synchronises again; the frame time of each 5 s slice of the window
   goes to standard error;
4. with ``--trace 1`` profiles the first ``TRACE_SECONDS`` of the window,
   with ``TRACE_MARGIN_FRAMES`` traced frames before and after it, and
   reads the per-layer metrics (``metrics/<name>.py``) from the trace;
5. frees the program's scene and renders the sampled frames' poses with
   the plain reference (``reference/``), which recomputes the poses from
   the events, the scene from the generated arrays and the files and the
   light rig as the loop chooses it (``reference_lights``), and compares
   (``compare.py``).

The last line of standard output is the result's JSON; the compared
numbers and their limits are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import enum  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import (compare, roofline, scenefiles, stats,  # noqa: E402
                       traffic)
from portbench import trace as tr  # noqa: E402

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
# Top-level module names that may not be loaded in a run.
BANNED = ("jax", "jaxlib", "flax", "kanirenderer_tpu")
# The traced part of a --trace 1 window, seconds: enough frames for the
# per-frame counts, few enough events for the trace to be read in time.
TRACE_SECONDS = 3.0
# Frames the profiler runs before the traced window's first marker and
# after its last.  The kernels' records drift against the host's calls on
# the trace's clock, by up to about 1.3% of a 3 s window on an NVIDIA H100,
# so those of the window's last kernels can lie tens of milliseconds past
# its last marker; the margin keeps the profiler on until they are in.
TRACE_MARGIN_FRAMES = 20
# How many traced poses the roofline's work is counted on.
WORK_POSES = 2
# The slices of the window whose frame times go to standard error, seconds.
SLICE_SECONDS = 5.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(directory: Path, name: str):
    """The per-layer metric reader ``<directory>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        directory / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def sample_offsets(seed: int, seconds: float, n: int) -> list:
    """Times into the window, drawn from the seed, after which the next
    presented frame is kept for the comparison."""
    rng = np.random.default_rng([seed % 2**64, 1])
    return sorted(rng.uniform(0.05, 0.95, n) * seconds)


class SampleSink:
    """A display sink that keeps a copy of the first frame presented after
    each of ``offsets`` seconds into the window, with its frame number
    (the loop presents each frame one iteration late, in order)."""

    def __init__(self, offsets: list, first_window_frame: int):
        self.offsets = offsets
        self.first = first_window_frame
        self.t0 = None
        self.presented = 0
        self.samples = []

    def present(self, img):
        g = self.presented
        self.presented += 1
        k = len(self.samples)
        if (self.t0 is not None and g >= self.first and k < len(self.offsets)
                and time.perf_counter() - self.t0 >= self.offsets[k]):
            self.samples.append((g, np.array(img, copy=True)))

    def close(self):
        pass


def watch_overflow(loop_module):
    """(the raster overflow of every presented frame, in order, as the
    loop's presenter hands it back; a function that undoes the watch).
    Raises where the loop has no presenter to watch: ``failed`` counts
    the overflowed frames, and a run that cannot see them gives no
    result."""
    presenter = getattr(loop_module, "_Presenter", None)
    collect = getattr(presenter, "collect", None)
    if collect is None:
        raise RuntimeError("runtime.loop has no _Presenter.collect: the "
                           "presented frames' raster overflow cannot be "
                           "read")
    seen = []

    def counted(self):
        ov = collect(self)
        if ov is not None:
            seen.append(ov)
        return ov

    presenter.collect = counted

    def undo():
        presenter.collect = collect

    return seen, undo


class Window:
    """The run's event stream around the mix's: warm-up frames, then the
    measured window with a host-clock stamp as each frame is asked for,
    then quit; with a profiler, the traced part between its markers,
    the profiler running ``TRACE_MARGIN_FRAMES`` frames before and after
    them."""

    def __init__(self, mix, seed, seconds, sink, cuda, profiler=None):
        self.mix, self.seed, self.seconds = mix, seed, seconds
        self.sink, self.cuda, self.prof = sink, cuda, profiler
        self.warmup = mix["warmup_frames"]
        self.t0 = None
        self.stamps = []
        self.traced_frames = None
        self.traced_host_s = None
        self._stop_at = None   # the frame at which the profiler stops

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _mark(self, name):
        with torch.profiler.record_function(name):
            pass

    def _pause(self, start):
        # The window's clock, and the sink's, leave out the traced
        # window's drain and the profiler's stop, so that a traced run
        # samples and runs as long as another.
        paused = time.perf_counter() - start
        self.t0 += paused
        self.sink.t0 += paused

    def _end_trace(self, i):
        start = time.perf_counter()
        self._mark(tr.END)
        self._sync()
        self._mark(tr.DRAINED)
        self.traced_frames = i - self.warmup
        self.traced_host_s = start - self.t0
        self._stop_at = i + TRACE_MARGIN_FRAMES
        self._pause(start)

    def _stop_profiler(self):
        start = time.perf_counter()
        self.prof.stop()
        self._stop_at = None
        self._pause(start)

    def __iter__(self):
        from kanirenderer_tpu_torch.runtime.loop import Events
        for i, ev in enumerate(traffic.events(self.mix, self.seed)):
            if self.prof is not None \
                    and i == max(self.warmup - TRACE_MARGIN_FRAMES, 0):
                self.prof.start()
            if i == self.warmup:
                self._sync()
                if self.prof is not None:
                    self._mark(tr.BEGIN)
                self.t0 = self.sink.t0 = time.perf_counter()
                log(f"warm-up done at {self.t0 - T_START:.4f} s")
            if i >= self.warmup:
                now = time.perf_counter()
                self.stamps.append(now)
                if self.prof is not None and self.traced_frames is None \
                        and now - self.t0 >= min(TRACE_SECONDS,
                                                 self.seconds):
                    self._end_trace(i)
                last = now - self.t0 >= self.seconds
                if self._stop_at is not None and (i >= self._stop_at
                                                  or last):
                    self._stop_profiler()
                if last:
                    yield Events(quit=True)
                    return
            yield Events(held=ev.held, pressed=ev.pressed,
                         mouse_dx=ev.mouse_dx, mouse_dy=ev.mouse_dy,
                         mouse_look=ev.mouse_look)


def slice_ms(stamps: list, t0: float, width: float = SLICE_SECONDS) -> list:
    """The mean frame interval, in ms, of each ``width`` seconds of the
    window from ``t0``: the intervals between consecutive ``stamps`` whose
    end falls in the slice; a slice with none is left out."""
    spans = {}
    for a, b in zip(stamps, stamps[1:]):
        k = int((b - t0) // width)
        n, total = spans.get(k, (0, 0.0))
        spans[k] = (n + 1, total + b - a)
    return [1e3 * total / n for _, (n, total) in sorted(spans.items())]


class MetricContext:
    """What a per-layer metric reader gets: the traced window, and what a
    reader needs to count a kernel's work on traced poses with
    ``roofline``'s functions: the reference's scene, its RenderConfig, its
    light rig ``lights`` (``reference_lights``) and the poses of
    ``WORK_POSES`` traced frames, evenly over the trace."""

    def __init__(self, trace, ref_scene, cfg, lights, mix, seed,
                 first_frame):
        self.trace = trace
        self.scene = ref_scene
        self.config = cfg
        self.lights = lights
        self._mix, self._seed, self._first = mix, seed, first_frame
        self._poses = None
        self._raster_list = None
        self._work = {}

    @property
    def poses(self) -> list:
        """The camera poses (``reference.frame`` form) of ``WORK_POSES``
        frames spread over the traced window, as the loop rendered
        them."""
        if self._poses is None:
            frames = max(self.trace.frames, 1)
            gs = sorted({self._first + k * frames // WORK_POSES
                         for k in range(WORK_POSES)})
            every = traffic.poses(self._mix, self._seed, gs[-1] + 1)
            self._poses = [every[g] for g in gs]
        return self._poses

    def _rasters(self) -> list:
        """(camera bbox, winning triangle per pixel, (3, N) world positions
        of the N covered pixels) of the reference's raster of each of
        ``poses``, shared by the counts."""
        if self._raster_list is None:
            self._raster_list = [_raster(self.scene, self.config, pose)
                                 for pose in self.poses]
        return self._raster_list

    def work(self, kind: str) -> tuple:
        """(bytes, operations) of a K1 ("depth"), a K2 or K2w ("pixels",
        by the cell's mode) or a shading kernel ("shade", ``lights``'
        rig) launch, the mean over ``poses``."""
        if kind not in self._work:
            self._work[kind] = self._count(kind)
        return self._work[kind]

    @torch.no_grad()
    def _count(self, kind: str) -> tuple:
        from portbench.reference import frame as rf
        from portbench.reference.types import RenderMode

        cfg = self.config
        if kind == "depth":
            counts = []
            for pose in self.poses:
                _, _, vout, _, _ = rf.camera_geometry(self.scene, pose, cfg)
                counts.append(roofline.depth_work(
                    rf.shadow_setup(self.scene, vout, cfg).bbox,
                    cfg.shadow_dim))
        elif kind == "pixels":
            counts = [roofline.pixel_work(bbox, tid, cfg.width, cfg.height)
                      for bbox, tid, _ in self._rasters()]
        elif kind == "shade":
            shadow = cfg.mode == RenderMode.LIT_SHADOW
            counts = []
            for _, _, world in self._rasters():
                covered = int(world.shape[1])
                pairs = roofline.lights_in_range(world, self.lights)
                counts.append(roofline.shade_work(covered, pairs, cfg.width,
                                                  cfg.height, shadow))
                log(f"shade work: {covered} covered pixels, {pairs} of "
                    f"{covered * (1 + self.lights.points.range.shape[0])} "
                    "(pixel, light) pairs in range")
        else:
            raise ValueError(f"no work of the kind {kind!r}")
        return (sum(c[0] for c in counts) / len(counts),
                sum(c[1] for c in counts) / len(counts))


@torch.no_grad()
def _raster(scene, cfg, pose) -> tuple:
    """``MetricContext._rasters``' entry of one pose."""
    from portbench.reference import frame as rf
    from portbench.reference.binning import bin_tiles
    from portbench.reference.forward import WORLD_POS
    from portbench.reference.interpolate import build_tri_records_corners
    from portbench.reference.raster import rasterize_pixels_plain
    from portbench.reference.types import RenderMode

    _, _, vout, st, planes = rf.camera_geometry(scene, pose, cfg)
    records = build_tri_records_corners(vout.varyings, planes,
                                        scene.tri_extra)
    bins = bin_tiles(st.bbox, cfg.width, cfg.height, cfg.tile_w,
                     cfg.tile_h, cfg.max_chunks_per_tile)
    pix = rasterize_pixels_plain(records, st.setup, st.bbox, bins,
                                 cfg.width, cfg.height,
                                 wireframe=cfg.mode == RenderMode.WIREFRAME,
                                 wire_thresh=cfg.wire_thresh_px)
    return st.bbox, pix.tid, pix.varyings[WORLD_POS][:, pix.mask]


def end_to_end(window: Window, t_end: float, frames: int) -> dict:
    return {
        "frame_ms": stats.frame_ms(window.t0, t_end, frames),
        "frame_p95_ms": stats.percentile(
            stats.intervals_ms(window.stamps), 95.0),
        "setup_s": window.t0 - T_START,
    }


# RenderConfig fields that the files' own keys set: ``width``, ``height``
# and ``shadow_map`` of the configuration, ``mode`` and
# ``cache_shadow_map`` of the mix; the reference's surface is u8, as the
# loop's.
BASE_FIELDS = ("width", "height", "shadow_dim", "mode", "cache_shadow_map",
               "output_u8")


def render_settings(config: dict, mix: dict) -> dict:
    """The ``render`` objects of the configuration and the mix together:
    RenderConfig field → value, enums by name.  Raises where both files,
    or a file and its own keys, set one field."""
    a, b = config.get("render", {}), mix.get("render", {})
    doubled = sorted(set(a) & set(b))
    if doubled:
        raise ValueError(f"render keys {doubled} are set by both the "
                         f"configuration {config['name']!r} and the mix "
                         f"{mix['name']!r}")
    fixed = sorted((set(a) | set(b)) & set(BASE_FIELDS))
    if fixed:
        raise ValueError(f"render keys {fixed} are set by the files' own "
                         "keys (width, height, shadow_map, mode, "
                         "cache_shadow_map)")
    return {**a, **b}


def _with_settings(cls, base: dict, settings: dict):
    """``cls(**base)`` with ``settings`` applied: each key a field of
    ``cls``, an enum field's value its member's name, a tuple field's a
    list, any other of the default's type."""
    fields = {f.name: f.default for f in dataclasses.fields(cls)}
    unknown = sorted(set(settings) - set(fields))
    if unknown:
        raise ValueError(f"render keys {unknown} are no fields of "
                         f"{cls.__module__}.{cls.__name__}")
    kw = dict(base)
    for key, value in settings.items():
        default = fields[key]
        kind = type(default)
        if isinstance(default, enum.Enum):
            if value not in kind.__members__:
                raise ValueError(f"render key {key!r}: {value!r} is not one "
                                 f"of {list(kind.__members__)}")
            value = kind[value]
        elif isinstance(default, tuple) and isinstance(value, list):
            value = tuple(value)
        elif kind is float and type(value) is int:
            value = float(value)
        if type(value) is not kind:
            raise ValueError(f"render key {key!r}: {value!r} is no "
                             f"{kind.__name__}")
        kw[key] = value
    return cls(**kw)


def render_config(config: dict, mix: dict):
    """The program's RenderConfig of a configuration under a mix."""
    from kanirenderer_tpu_torch.core.types import RenderConfig, RenderMode
    return _with_settings(
        RenderConfig, dict(width=config["width"], height=config["height"],
                           shadow_dim=config["shadow_map"],
                           mode=RenderMode[mix["mode"]],
                           cache_shadow_map=mix["cache_shadow_map"]),
        render_settings(config, mix))


def reference_config(config: dict, mix: dict):
    """The reference's RenderConfig of a configuration under a mix: the
    program's, with the loop's u8 surface."""
    from portbench.reference.types import RenderConfig, RenderMode
    return _with_settings(
        RenderConfig, dict(width=config["width"], height=config["height"],
                           shadow_dim=config["shadow_map"],
                           mode=RenderMode[mix["mode"]],
                           cache_shadow_map=mix["cache_shadow_map"],
                           output_u8=True),
        render_settings(config, mix))


def point_lights(config: dict) -> int:
    """The configuration's ``point_lights``, the loop's argument of that
    name (1 without the key); raises unless a whole number of at least
    1."""
    n = config.get("point_lights", 1)
    if type(n) is not int or n < 1:
        raise ValueError(f"point_lights {n!r} of the configuration "
                         f"{config['name']!r} is no whole number of at "
                         "least 1")
    return n


def reference_lights(config: dict, device):
    """The reference's light rig of a configuration, as the loop chooses
    it from ``point_lights`` N: ``default_lights``' for N = 1, its
    point-light array replaced by ``spawn_point_lights(N)``'s for N > 1.
    Raises unless the array holds ``expect.point_lights`` lights (a key
    that ``point_lights`` needs; 1 where both are left out)."""
    from portbench.reference.types import default_lights, spawn_point_lights
    n = point_lights(config)
    rig = default_lights(device=device)
    if n > 1:
        rig = rig._replace(points=spawn_point_lights(n, device=device))
    want = config["expect"].get("point_lights",
                                None if "point_lights" in config else 1)
    got = int(rig.points.range.shape[0])
    if type(want) is not int or got != want:
        raise ValueError(f"point_lights {n} gives {got} lights, and the "
                         f"configuration {config['name']!r} expects "
                         f"{want!r} (expect.point_lights)")
    return rig


def reference_scene(config: dict, directory: Path, device):
    from portbench.reference.scene import pack_scene
    return pack_scene(*scenefiles.reference_inputs(config, directory),
                      device)


def check_samples(ref_scene, rcfg, mix, seed, samples, lights) -> list:
    """The compared numbers of every sampled (frame number, u8 surface)
    against the reference's frame of the same pose under the rig
    ``lights``."""
    from portbench.reference.frame import render_frame
    if not samples:
        return []
    poses = traffic.poses(mix, seed, max(g for g, _ in samples) + 1)
    return [compare.frame_numbers(img, render_frame(ref_scene, poses[g],
                                                    rcfg, lights=lights))
            for g, img in samples]


def load_program_scene(config: dict, directory: Path, device: str):
    """The program's scene and builder, loaded from the configuration's
    files through ``api.load_model_or_default``; raises unless the
    loaded scene has the configuration's triangles and materials."""
    from kanirenderer_tpu_torch import api
    scene, builder = api.load_model_or_default(
        str(directory / "scene.obj"), "opengl", device=device)
    tris = int(scene.tri_valid.sum())
    mats = int(scene.mat_blk_base.shape[0])
    log("load_seconds " + " ".join(
        f"{k}={v:.4f}" for k, v in builder.load_seconds.items())
        + f" triangles={tris} materials={mats}")
    want = config["expect"]
    if (tris, mats) != (want["triangles"], want["materials"]):
        raise RuntimeError(
            f"the loaded scene has {tris} triangles and {mats} materials, "
            f"not {want['triangles']} and {want['materials']}: the load "
            "fell back or the files are not the configuration's")
    return scene, builder


def drive(scene, builder, pcfg, point_lights: int, mix: dict, seed: int,
          seconds: float, cuda: bool, prof=None, break_frames=None):
    """One warm-up and window of the program's loop under its RenderConfig
    ``pcfg`` (``render_config``) and ``point_lights`` → (the loop's
    statistics, the Window, the SampleSink, the overflow per presented
    frame, the host clock once the device had finished)."""
    from kanirenderer_tpu_torch.runtime import loop as loop_module
    overflow, unwatch = watch_overflow(loop_module)
    saved_render = loop_module.render_frame
    if break_frames is not None:
        loop_module.render_frame = break_frames(saved_render)
    sink = SampleSink(sample_offsets(seed, seconds, mix["samples"]),
                      mix["warmup_frames"])
    window = Window(mix, seed, seconds, sink, cuda, prof)
    try:
        run = loop_module.run_loop(scene, window, config=pcfg, sink=sink,
                                   builder=builder, fixed_dt=mix["fixed_dt"],
                                   point_lights=point_lights)
    finally:
        loop_module.render_frame = saved_render
        unwatch()
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    log(f"present mode: {run['present_mode']}")
    if run["present_mode"] != "AutoNoVsync":
        raise RuntimeError("the window's frames ran with the vsync cap")
    if len(overflow) != sink.presented:
        raise RuntimeError(f"{sink.presented} frames presented, the "
                           f"overflow of {len(overflow)} seen")
    return run, window, sink, overflow, t_end


def run_cell(cell: dict, config: dict, mix: dict, seed: int,
             seconds: float, trace: bool, bench: dict,
             metrics_dir: Path = HERE / "metrics",
             cache: Path = scenefiles.CACHE, device: str = "cuda",
             break_frames=None) -> dict:
    """One run of ``cell``; returns the result's fields.  ``device``
    "cpu" and ``break_frames`` (a function that wraps the program's
    ``render_frame``) serve the harness's own tests.  A configuration's
    generator, render keys or light rig that do not resolve raise before
    anything is loaded."""
    cuda = device == "cuda"
    pcfg = render_config(config, mix)
    rcfg = reference_config(config, mix)
    lights = reference_lights(config, device)
    t_cell = time.perf_counter()
    directory = scenefiles.scene_dir(config, cache)
    t_files = time.perf_counter()
    log(f"scene files ready at {t_files - T_START:.4f} s")
    scene, builder = load_program_scene(config, directory, device)
    t_loaded = time.perf_counter()
    log(f"scene loaded at {t_loaded - T_START:.4f} s")
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    run, window, sink, overflow, t_end = drive(
        scene, builder, pcfg, point_lights(config), mix, seed, seconds, cuda,
        prof, break_frames)
    attempted = len(window.stamps) - 1
    frames = run["frames"] - mix["warmup_frames"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int(run["healed"]) + sum(
        1 for ov in overflow[mix["warmup_frames"]:] if ov)

    trace_path = None
    if trace:
        fd, trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_path)
    result_e2e = end_to_end(window, t_end, frames)
    log(f"setup parts, s: imports {t_cell - T_START:.4f}, scene files "
        f"{t_files - t_cell:.4f}, load {t_loaded - t_files:.4f}, warm-up "
        f"{window.t0 - t_loaded:.4f}")
    log("frame ms of each 5 s slice: " + " ".join(
        f"{ms:.4f}" for ms in slice_ms(window.stamps, window.t0)))
    del scene, builder, prof, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_scene = reference_scene(config, directory, device)
    numbers = check_samples(ref_scene, rcfg, mix, seed, sink.samples,
                            lights)
    log(f"reference: {len(numbers)} frames compared in "
        f"{time.perf_counter() - t_ref:.4f} s")
    numbers += [compare.MISSING] * (mix["samples"] - len(numbers))
    checks = compare.worst(numbers)
    correct = compare.within(checks)

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    breakdown = None
    if not trace:
        out["metrics"] = {m["name"]: {"value": result_e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in bench["end_to_end"]}
    else:
        try:
            t = tr.read(trace_path, window.traced_frames)
        finally:
            os.unlink(trace_path)
        ctx = MetricContext(t, ref_scene, rcfg, lights, mix, seed,
                            mix["warmup_frames"])
        metrics = {}
        for m in bench["per_layer"]:
            if cell["name"] not in m["workloads"]:
                continue
            value = load_metric(metrics_dir, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        out["metrics"] = metrics
        device_info.update(busy_s=tr.busy_s(t), window_s=t.window_s)
        breakdown = {"device_ops": tr.top_device_ops(t),
                     "idle_gaps": tr.idle_gaps(t)}
        log(f"traced {t.frames} frames in {t.window_s:.4f} s of trace "
            f"({window.traced_host_s:.4f} s on the host clock); the "
            f"untraced rest of the window ran {frames - t.frames} frames")
    out["device"] = device_info
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": checks[k], "limit": compare.LIMITS[k]}
                     for k in compare.LIMITS}
    return out


def emit(out: dict) -> int:
    """Prints the result's line, then the compared numbers beside their
    limits as the last lines of standard error, and returns 0; where a
    module of ``BANNED`` has been loaded by now (by the program, a metric
    reader or anything they import), prints no result and returns 1."""
    found = banned_modules()
    if found:
        log(f"modules loaded in the run: {found}; no result")
        return 1
    print(json.dumps(out), flush=True)
    for k, v in out["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    log(f"imports done at {time.perf_counter() - T_START:.4f} s")
    bench = load_json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"the cell needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 3
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(HERE.parent / configs[cell["config"]]["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    query = roofline.query_power_limit()
    try:
        out = run_cell(cell, config, mix, args.seed, args.seconds,
                       bool(args.trace), bench)
    finally:
        card = roofline.power_limit(query)
    log(f"card: {card}")
    return emit(out)


if __name__ == "__main__":
    sys.exit(main())
