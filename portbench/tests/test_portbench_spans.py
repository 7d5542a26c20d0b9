"""The span readers (``portbench/spans.py`` and the metrics that use it)
on a hand-built Chrome trace of two frames: every metric's exact value, a
kernel launched in a child span counting for the child alone, idle
outside every span counting for no metric, kernels found by correlation
id wherever their records lie, no kernel time where a launch call has no
kernel, and no value from a program without the spans."""

import json

import pytest

from portbench import run, spans
from portbench import trace as tr
from portbench.tests.conftest import ROOT

FRAMES = 2
METRICS = ("geometry.device_ms", "geometry.idle_ms", "shadow.device_ms",
           "shadow.idle_ms", "shade.device_ms", "shade.idle_ms",
           "present.wait_ms", "loop.idle_ms")


def host(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}


def launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return dict(host(name, ts, ts + 0.25, cat), args={"correlation": corr})


def device(name, ts, end, corr=None, cat="kernel"):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}
    if corr is not None:
        event["args"] = {"correlation": corr}
    return event


# Times in microseconds.  Frame 1 runs [1, 50], frame 2 [55, 95]; the
# host is in no span over [0, 1], [50, 55] and [95, 120].
EVENTS = [
    host(tr.BEGIN, 0, 0), host(tr.END, 100, 100), host(tr.DRAINED, 120, 120),
    host("kani.frame", 1, 50),
    launch(1.5, 1), device("fill_kernel", 1.6, 1.9, 1),      # loop: 0.3
    host("kani.geometry", 2, 20),
    launch(3, 2), device("vertex_kernel", 5, 9, 2),          # geometry: 4
    host("kani.shadow", 10, 15),
    launch(11, 3), device("raster_depth_kernel", 12, 14, 3),  # shadow: 2
    # a cudaLaunchKernel and the cuLaunchKernel inside it: one launch
    launch(16, 4), launch(16.1, 104, "cuLaunchKernel", "cuda_driver"),
    device("bin_kernel", 17, 18, 4),                         # geometry: 1
    host("kani.raster", 21, 25),
    launch(22, 5), device("raster_pixels_kernel", 23, 26, 5),  # raster: 3
    host("kani.shade", 26, 40),
    launch(27, 6), device("elementwise_kernel", 28, 38, 6),  # shade: 10
    host("kani.present", 41, 49),
    host("kani.present.wait", 42, 47),
    host("cudaEventSynchronize", 42, 47, "cuda_runtime"),
    device("Memcpy DtoH (Device -> Pinned)", 43, 46, cat="gpu_memcpy"),
    launch(52, 7), device("outside_kernel", 53, 54, 7),      # no span: 1
    host("kani.frame", 55, 95),
    host("kani.geometry", 56, 60),
    host("kani.shade", 61, 70),
    launch(62, 8), device("gather_kernel", 63, 65, 8),       # shade: 2
    host("aten::index", 62, 62.5, "cpu_op"),
]

# Idle (no device op) over the window [0, 120], split by the innermost
# span: geometry 3 + 1 + 2 + 2 + 4, shadow 2 + 1, shade 2 + 2 + 2 + 5,
# the loop 0.6 + 0.1 + 1 + 1 + 1 + 1 + 1 + 25, no span 1 + 3 + 1 + 25.
EXPECTED = {
    "geometry.device_ms": 5e-3 / FRAMES,
    "geometry.idle_ms": 12e-3 / FRAMES,
    "shadow.device_ms": 2e-3 / FRAMES,
    "shadow.idle_ms": 3e-3 / FRAMES,
    "shade.device_ms": 12e-3 / FRAMES,
    "shade.idle_ms": 11e-3 / FRAMES,
    "present.wait_ms": 5e-3 / FRAMES,
    "loop.idle_ms": 30.7e-3 / FRAMES,
}


class Ctx:
    def __init__(self, trace):
        self.trace = trace


def read_trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tr.read(str(path), FRAMES)


def readings(trace) -> dict:
    ctx = Ctx(trace)
    return {m: run.load_metric(ROOT / "metrics", m).read(ctx)
            for m in METRICS}


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_reads_its_exact_value(tmp_path, name):
    got = readings(read_trace(tmp_path, EVENTS))[name]
    assert got == pytest.approx(EXPECTED[name], rel=1e-9, abs=1e-15)


def test_child_span_keeps_its_kernels_and_idle_outside_spans_counts_nowhere(
        tmp_path):
    trace = read_trace(tmp_path, EVENTS)
    att = spans.attribution(trace)
    # The shadow span's kernel counts for it alone, not for the geometry
    # span it nests in; the outside kernel for no span.
    assert att.device_us == pytest.approx({
        None: 1.0, "kani.frame": 0.3, "kani.geometry": 5.0,
        "kani.shadow": 2.0, "kani.raster": 3.0, "kani.shade": 12.0})
    assert att.launches == {None: 1, "kani.frame": 1, "kani.geometry": 2,
                            "kani.shadow": 1, "kani.raster": 1,
                            "kani.shade": 2}
    assert att.syncs == {"kani.present.wait": 1}
    assert att.copies_us == pytest.approx(3.0)
    assert att.idle_us[None] == pytest.approx(30.0)
    # Every idle microsecond of the window is counted once.
    window = trace.drained_us - trace.begin_us
    assert sum(att.idle_us.values()) == pytest.approx(
        window - tr.busy_s(trace) * 1e6)


def test_a_launch_without_its_kernel_gives_no_attribution(tmp_path,
                                                         capsys):
    """No kernel time by span, and a line on standard error that says
    so; the device's idle, read without the pairing, still reads."""
    events = [e for e in EVENTS if e["name"] != "gather_kernel"]
    got = readings(read_trace(tmp_path, events))
    assert spans.attribution(read_trace(tmp_path, events)).device_us is None
    assert "1 of the traced window's launch calls" in capsys.readouterr().err
    for name in METRICS:
        if name.endswith(".device_ms"):
            assert got[name] is None, name
        else:
            assert got[name] is not None, name
    # The kernel left out lay in the second frame's shade span.
    assert got["shade.idle_ms"] == pytest.approx(
        EXPECTED["shade.idle_ms"] + 2e-3 / FRAMES)
    assert got["geometry.idle_ms"] == pytest.approx(
        EXPECTED["geometry.idle_ms"])


def test_kernels_are_found_by_correlation_wherever_their_records_lie(
        tmp_path):
    """A kernel launched in the window whose record lies after the last
    marker counts for its launch's span; a record inside the window of a
    kernel launched before it counts for no span's kernel time."""
    events = [dict(e, ts=121, dur=2) if e["name"] == "gather_kernel" else e
              for e in EVENTS]
    events += [launch(-5, 9), device("early_kernel", 0.2, 0.8, 9)]
    got = readings(read_trace(tmp_path, events))
    for name in METRICS:
        if name.endswith(".device_ms"):
            assert got[name] == pytest.approx(EXPECTED[name], rel=1e-9), name
    att = spans.attribution(read_trace(tmp_path, events))
    assert sum(att.launches.values()) == 8


def test_a_program_without_spans_reads_nothing(tmp_path):
    events = [e for e in EVENTS if not e["name"].startswith("kani.")]
    assert all(v is None
               for v in readings(read_trace(tmp_path, events)).values())


def test_innermost_timeline():
    got = spans.innermost([(0, 10, "a"), (2, 5, "b"), (6, 8, "c"),
                           (6, 7, "d"), (12, 15, "e")])
    assert got == [(0, 2, "a"), (2, 5, "b"), (5, 6, "a"), (6, 7, "d"),
                   (7, 8, "c"), (8, 10, "a"), (12, 15, "e")]


def test_idle_gaps_inside_frames_are_named_by_span(tmp_path):
    """The harness's existing breakdown names each gap by the host op at
    its middle: inside a frame that is now a program span.  Only the gap
    before the first frame has no name."""
    names = [name for name, _ in tr.idle_gaps(read_trace(tmp_path, EVENTS),
                                                n=20)]
    assert {"kani.frame", "kani.geometry", "kani.shadow"} <= set(names)
    assert names.count("(host code outside any traced op)") == 1
