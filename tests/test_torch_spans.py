"""The frame loop's spans (``utils/spans.py``) on the CPU: nothing is
recorded, and ``record_function`` never entered, while no profiler runs;
the profiler's flag that gates them follows the profiler; under the CPU
profiler every frame's stage spans nest inside its ``kani.frame``; and
the frames are the same with the profiler on as with it off."""

import contextlib
import json

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from kanirenderer_tpu_torch.core.types import RenderConfig, RenderMode
from kanirenderer_tpu_torch.models.procedural import (cube_scene,
                                                      sponza_standin_scene)
from kanirenderer_tpu_torch.runtime.loop import Events, run_loop
from kanirenderer_tpu_torch.utils.spans import span

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)

FRAMES = 3
# A fresh shadow map every frame, so each frame runs the whole pass.
CONFIG = RenderConfig(width=96, height=64, shadow_dim=128,
                      mode=RenderMode.LIT_SHADOW, cache_shadow_map=False)
EVENTS = [Events(held=frozenset(["w"]), mouse_dx=2.0, mouse_dy=0.3,
                 mouse_look=True)] * FRAMES
STAGES = ("kani.geometry", "kani.shadow", "kani.raster", "kani.shade",
          "kani.present")


class Capture:
    """A sink that keeps a copy of every presented frame."""

    def __init__(self):
        self.frames = []

    def present(self, img):
        self.frames.append(torch.tensor(img))

    def close(self):
        pass


def _loop(scene, sink) -> dict:
    return run_loop(scene, EVENTS, config=CONFIG, sink=sink,
                    fixed_dt=1.0 / 60.0)


def _spans(path) -> list:
    """(start ns, end ns, name, category) of every ``kani.*`` span of a
    Chrome trace; the trace's microseconds carry three decimals."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("kani."):
            ts, dur = round(float(e["ts"]) * 1e3), round(float(e["dur"]) * 1e3)
            out.append((ts, ts + dur, e["name"], e.get("cat")))
    return sorted(out)


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


@pytest.fixture(scope="module")
def scene():
    return sponza_standin_scene(target_tris=2_000, num_materials=3,
                                tex_size=16, device="cpu")


@pytest.fixture(scope="module")
def traced(scene, tmp_path_factory):
    """(frames with the profiler off, frames under the CPU profiler, the
    traced run's spans)."""
    off, on = Capture(), Capture()
    _loop(scene, off)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        _loop(scene, on)
    finally:
        prof.stop()
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    return off.frames, on.frames, _spans(path)


def test_span_is_the_shared_null_context_with_the_profiler_off():
    assert not autograd_profiler._is_profiler_enabled
    first = span("kani.frame")
    assert isinstance(first, contextlib.nullcontext)
    assert span("kani.shade") is first


def test_loop_never_enters_record_function_with_the_profiler_off(
        monkeypatch):
    """A cube run of three frames with ``record_function`` made to raise:
    no frame fails (the loop would heal a failed frame and count it)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    stats = run_loop(cube_scene(device="cpu"), [Events()] * FRAMES,
                     config=CONFIG, sink_kind="null")
    assert stats["frames"] == FRAMES and stats["healed"] == 0


@pytest.mark.parametrize("form", ["start_stop", "with"])
def test_profiler_flag_follows_the_profiler(form):
    """The private flag the spans read is set by the profiler's start and
    cleared by its stop: a PyTorch that stops keeping it fails here
    instead of dropping the spans from every trace."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    assert not autograd_profiler._is_profiler_enabled
    if form == "start_stop":
        prof.start()
        try:
            assert autograd_profiler._is_profiler_enabled
            assert isinstance(span("kani.frame"),
                              torch.profiler.record_function)
        finally:
            prof.stop()
    else:
        with prof:
            assert autograd_profiler._is_profiler_enabled
            assert isinstance(span("kani.frame"),
                              torch.profiler.record_function)
    assert not autograd_profiler._is_profiler_enabled
    assert isinstance(span("kani.frame"), contextlib.nullcontext)


def test_traced_loop_records_one_frame_span_per_frame(traced):
    _, _, spans = traced
    frames = [s for s in spans if s[2] == "kani.frame"]
    assert len(frames) == FRAMES
    assert {s[3] for s in spans} == {"user_annotation"}
    for a, b in zip(frames, frames[1:]):
        assert a[1] <= b[0]


@pytest.mark.parametrize("name", STAGES)
def test_stage_spans_nest_in_every_frame(traced, name):
    """Each frame holds the stage's span, and every span of the stage
    lies inside a frame."""
    _, _, spans = traced
    frames = [s for s in spans if s[2] == "kani.frame"]
    stage = [s for s in spans if s[2] == name]
    for f in frames:
        assert any(_inside(s, f) for s in stage), (name, f)
    for s in stage:
        assert any(_inside(s, f) for f in frames), s


def test_light_setup_shadow_span_nests_in_geometry(traced):
    """The light-space setup and bins, made while the geometry runs,
    record a shadow span inside each frame's geometry span."""
    _, _, spans = traced
    geometry = [s for s in spans if s[2] == "kani.geometry"]
    shadow = [s for s in spans if s[2] == "kani.shadow"]
    assert len(geometry) == FRAMES
    for g in geometry:
        assert sum(_inside(s, g) for s in shadow) == 1, g
    # The shadow raster and the table make a second shadow span a frame,
    # outside the geometry's.
    assert len(shadow) == 2 * FRAMES


def test_traced_frames_equal_untraced_frames(traced):
    off, on, _ = traced
    assert len(off) == len(on) == FRAMES
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    # The frames show the scene, not a flat clear colour.
    assert off[-1].reshape(-1, 3).unique(dim=0).shape[0] > 64
