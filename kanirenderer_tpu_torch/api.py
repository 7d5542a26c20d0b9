"""Public API — mirrors the reference's entry surface (counterpart of
``kanirenderer_tpu/api.py``).

``run(file_path, file_type, fullscreen_mode, use_hdr)`` mirrors
``pub async fn run`` (reference src/lib.rs:2054) / the C ABI
``run_kanirenderer`` (src/lib.rs:2174-2192): load the model (the default
cube when the path is empty or missing, src/resources.rs:73-79), build the
render state on the device and drive the event loop.  On a headless host
the "window" is a display sink (PNG, GIF, window or null, see
runtime/display.py) and input comes from an event source (scripted by
default).  Everything runs on the CUDA device unless the caller passes
``device="cpu"``; without a card the default raises.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from kanirenderer_tpu_torch.core.types import (RenderConfig, RenderMode,
                                               default_camera,
                                               default_lights, frame_state)
from kanirenderer_tpu_torch.io import obj as obj_mod
from kanirenderer_tpu_torch.io.scene_loader import SceneBuilder
from kanirenderer_tpu_torch.models.procedural import make_cube_obj
from kanirenderer_tpu_torch.ops.occ_replay import choose_occ_scope
from kanirenderer_tpu_torch.runtime.loop import run_loop, scripted_flythrough


def load_model_or_default(file_path: str, file_type: str = "opengl",
                          instances: int = 1, device="cuda"):
    """Reference load_model fallback chain (src/resources.rs:73-79): an
    empty or missing path, or any load error, gives the embedded default
    cube (``.unwrap_or(load_default_cube)``, src/resources.rs:76-79).

    Returns (scene on ``device``, SceneBuilder); the SceneBuilder supports
    file-drop appends, and its ``load_seconds`` says where the load's time went:
    ``parse`` (OBJ and MTL text), ``textures`` (texture decode and tangent
    frames), ``pack`` (Morton order, texture tables, upload)."""
    builder = SceneBuilder()
    parsed = None
    tex_dir = "."
    t0 = time.perf_counter()
    if file_path and os.path.exists(file_path):
        try:
            parsed = obj_mod.load_obj(file_path)
            tex_dir = os.path.dirname(os.path.abspath(file_path))
        except Exception as e:
            print(f"failed to load {file_path!r} ({e!r}), using default cube")
    elif file_path:
        print(f"{file_path!r} not found, using default cube")
    if parsed is None:
        parsed = obj_mod.parse_obj(make_cube_obj(), mtl_loader=lambda p: None)
    t1 = time.perf_counter()
    builder.add_model(parsed, tex_dir, file_type=file_type,
                      instances=instances, rng=np.random.RandomState(0))
    t2 = time.perf_counter()
    scene = builder.build(device)
    builder.load_seconds = dict(parse=t1 - t0, textures=t2 - t1,
                                pack=time.perf_counter() - t2)
    return scene, builder


def run(file_path: str = "", file_type: str = "opengl",
        fullscreen_mode: str = "windowed", use_hdr: bool = False,
        width: int = 1440, height: int = 1080,
        mode: RenderMode = RenderMode.LIT_SHADOW,
        frames: int = 60, sink: str = "png", out: str | None = None,
        events=None, verbose: bool = True, profile_dir: str | None = None,
        point_lights: int = 1, render_scale: int = 1,
        cache_shadow_map: bool = True, device="cuda") -> dict:
    """Load + render loop (reference run(), src/lib.rs:2054-2168).

    Defaults match the reference: 1440×1080 window (src/lib.rs:2056),
    initial mode LitWithShadow (src/lib.rs:1033), LDR unless use_hdr.
    ``cache_shadow_map=False`` re-renders the shadow map in every frame,
    as the reference does.

    Embedding hosts that call with a fixed signature can override the
    headless runtime through the environment: KANI_WIDTH, KANI_HEIGHT,
    KANI_FRAMES, KANI_SINK (png|gif|window|null), KANI_OUT, KANI_MODE,
    KANI_RENDER_SCALE (render at 1/s of the resolution),
    KANI_PRESENT_SCALE (present a 1/s preview; default 1), KANI_PROFILE
    (a directory: write a ``torch.profiler`` trace of the run there) and
    KANI_OCC, the occlusion skip's scope (RenderConfig.occ_scope): "0"
    none, "shadow" (the default) the shadow raster, "1" every raster, or
    "auto": at load, ops/occ_replay.choose_occ_scope replays the skip at
    the default camera and lights and picks "1" or "shadow" (printed when
    ``verbose``; a failing gate raises).  Every scope renders the same
    pixels.
    """
    width = int(os.environ.get("KANI_WIDTH", width))
    height = int(os.environ.get("KANI_HEIGHT", height))
    render_scale = int(os.environ.get("KANI_RENDER_SCALE", render_scale))
    if render_scale > 1:
        width //= render_scale
        height //= render_scale
    frames = int(os.environ.get("KANI_FRAMES", frames))
    sink = os.environ.get("KANI_SINK", sink)
    out = os.environ.get("KANI_OUT", out)
    if "KANI_MODE" in os.environ:
        mode = RenderMode[os.environ["KANI_MODE"].upper()]
    profile_dir = os.environ.get("KANI_PROFILE", profile_dir)
    scene, builder = load_model_or_default(file_path, file_type,
                                           device=device)
    if verbose:
        print("loaded in " + ", ".join(
            f"{k} {v:.2f} s" for k, v in builder.load_seconds.items()))
    cfg = RenderConfig(
        width=width, height=height, mode=mode, hdr=use_hdr,
        cache_shadow_map=cache_shadow_map,
        present_scale=max(int(os.environ.get("KANI_PRESENT_SCALE", "1")), 1))
    occ = os.environ.get("KANI_OCC")
    if occ == "auto":
        t0 = time.perf_counter()
        state = frame_state(scene, default_camera(device=scene.device),
                            default_lights(device=scene.device))
        occ, est = choose_occ_scope(scene, state, cfg)
        if verbose:
            print(f"occlusion gate: scope {occ} (evaluations spared "
                  f"{est['eval_drop']:.1%}, chunks skipped "
                  f"{est['run_skip']:.1%}, {time.perf_counter() - t0:.2f} s)")
    if occ is not None:
        cfg = cfg.with_(occ_scope=occ)
    # A live window is both sink and event source, like the reference's
    # winit loop (src/lib.rs:2091-2140); a host without a display falls
    # back to scripted events and the window sink's PNG dumps.
    sink_obj = None
    if sink == "window" and events is None:
        try:
            from kanirenderer_tpu_torch.runtime.input import (
                InteractiveWindow, interactive_source)
            sink_obj = InteractiveWindow(
                width, height, fullscreen=(fullscreen_mode == "fullscreen"))
            events = interactive_source(sink_obj)
        except Exception as e:
            if verbose:
                print(f"no display ({e!r}); falling back to scripted events")
    if events is None:
        events = scripted_flythrough(frames)

    def go():
        return run_loop(scene, events, config=cfg, sink_kind=sink,
                        sink_path=out,
                        max_frames=frames if frames > 0 else None,
                        verbose=verbose, builder=builder,
                        file_type=file_type, sink=sink_obj,
                        point_lights=point_lights)

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if scene.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            stats = go()
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    else:
        stats = go()
    if verbose:
        print(f"rendered {stats['frames']} frames, "
              f"{stats['mean_ms']:.2f} ms avg ({stats['fps']:.1f} FPS), "
              f"mode {stats['mode']}, fullscreen={fullscreen_mode}")
    return stats
