"""The harness end to end on the CPU at a tiny size: a run compares equal
to the reference; a run with the timed path broken underneath, or the
control in the program's place, comes out not correct; a configuration,
a traffic mix and a per-layer metric are found by name in folders of
their own; and without a card the command prints no result."""

import json
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from portbench import compare, run, scenefiles, traffic
from portbench import trace as tr
from portbench.tests.conftest import ROOT, tiny_mix

SEED = 2**31 + 1234


def e2e_bench(cell_name):
    return {"end_to_end": [{"name": "frame_ms", "unit": "ms"},
                           {"name": "frame_p95_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": []}


def test_a_run_is_correct(tmp_path, tiny_config, tiny_cell):
    out = run.run_cell(tiny_cell, tiny_config, tiny_mix("fly-fresh"), SEED,
                       1.5, False, e2e_bench(tiny_cell["name"]),
                       cache=tmp_path, device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] >= 2
    assert set(out["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert all(v["value"] == 0.0 for v in out["checks"].values())


def altered(render):
    """Every frame with one 32x32 block of its surface inverted."""
    def wrapped(*args, **kw):
        out = render(*args, **kw)
        img = out.image.clone()
        img[:32, :32] = 255 - img[:32, :32]
        return out._replace(image=img)
    return wrapped


def unchanged(render):
    """The first frame's outputs, again and again: a frame that does not
    follow the camera."""
    first = []

    def wrapped(*args, **kw):
        if not first:
            first.append(render(*args, **kw))
        return first[0]
    return wrapped


def half_the_triangles(render):
    """Every frame rendered with every second triangle left out, as a
    binning that drops half of its entries would."""
    def wrapped(scene, *args, **kw):
        valid = scene.tri_valid.clone()
        valid[1::2] = False
        return render(scene._replace(tri_valid=valid), *args, **kw)
    return wrapped


@pytest.mark.parametrize("fault", [altered, unchanged, half_the_triangles],
                         ids=["frame_altered", "state_unchanged",
                              "half_left_out"])
def test_a_broken_path_is_not_correct(tmp_path, tiny_config, tiny_cell,
                                      fault):
    out = run.run_cell(tiny_cell, tiny_config, tiny_mix("fly-fresh"), SEED,
                       1.5, False, e2e_bench(tiny_cell["name"]),
                       cache=tmp_path, device="cpu", break_frames=fault)
    assert not out["correct"]


def overflowing(render):
    """Every frame reports that its binning dropped 3 chunk entries."""
    def wrapped(*args, **kw):
        out = render(*args, **kw)
        return out._replace(raster_overflow=torch.full_like(
            out.raster_overflow, 3))
    return wrapped


def test_overflowed_frames_count_as_failed(tmp_path, tiny_config,
                                           tiny_cell):
    out = run.run_cell(tiny_cell, tiny_config, tiny_mix("fly-wire"), SEED,
                       1.0, False, e2e_bench(tiny_cell["name"]),
                       cache=tmp_path, device="cpu",
                       break_frames=overflowing)
    assert out["failed"] >= out["attempted"] >= 1


@pytest.mark.parametrize("missing", ["_Presenter", "collect"])
def test_without_the_presenter_hook_no_result(tmp_path, tiny_config,
                                              tiny_cell, monkeypatch,
                                              missing):
    """The overflowed frames are read from the loop's presenter; a loop
    without it gives no result rather than a ``failed`` that cannot see
    them."""
    from kanirenderer_tpu_torch.runtime import loop
    if missing == "_Presenter":
        monkeypatch.delattr(loop, "_Presenter")
    else:
        monkeypatch.setattr(loop, "_Presenter",
                            type("_Presenter", (), {}))
    with pytest.raises(RuntimeError, match="_Presenter.collect"):
        run.run_cell(tiny_cell, tiny_config, tiny_mix("fly-wire"), SEED,
                     1.0, False, e2e_bench(tiny_cell["name"]),
                     cache=tmp_path, device="cpu")


@pytest.mark.parametrize("imports, gives_result",
                         [("flax", False), ("json", True)],
                         ids=["flax_loaded", "nothing_banned"])
def test_a_banned_module_loaded_after_the_window_gives_no_result(
        tmp_path, tiny_config, tiny_cell, monkeypatch, capsys, imports,
        gives_result):
    """A per-layer metric reader, read after the window has closed, that
    loads a module of JAX's (here a stand-in named ``flax``): ``main``
    looks at ``sys.modules`` just before it prints, and prints nothing."""
    fake = tmp_path / "fake"
    fake.mkdir()
    (fake / "flax.py").write_text("")
    monkeypatch.syspath_prepend(str(fake))
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "frame.imports.py").write_text(
        f"import {imports}  # noqa: F401\n\n\n"
        "def read(ctx):\n    return float(ctx.trace.frames)\n")
    bench = e2e_bench(tiny_cell["name"])
    bench["per_layer"] = [{"name": "frame.imports", "unit": "frames",
                           "moves": "frame_ms",
                           "workloads": [tiny_cell["name"]]}]
    cuda_available = torch.cuda.is_available
    real_run_cell = run.run_cell

    def tiny_run_cell(cell, config, mix, seed, seconds, trace, _bench):
        monkeypatch.setattr(torch.cuda, "is_available", cuda_available)
        return real_run_cell(tiny_cell, tiny_config, tiny_mix("fly-fresh"),
                             seed, 1.0, True, bench, metrics_dir=metrics,
                             cache=tmp_path / "cache", device="cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", tiny_run_cell)
    sys.modules.pop("flax", None)
    try:
        rc = run.main(["--workload", "sponza-1080p.fly-fresh", "--seed",
                       str(SEED), "--seconds", "1", "--trace", "1"])
    finally:
        sys.modules.pop("flax", None)
    printed = capsys.readouterr()
    if gives_result:
        assert rc == 0
        assert json.loads(printed.out.splitlines()[-1])["correct"]
    else:
        # The program's own log lines may reach standard output; the
        # result's JSON line may not.
        assert rc != 0
        assert not any(line.startswith("{")
                       for line in printed.out.splitlines())
        assert "flax" in printed.err


@pytest.mark.parametrize("mix_name", ["fly-fresh", "fly-wire"])
def test_the_control_is_not_correct(tmp_path, tiny_config, mix_name):
    from portbench.reference.frame import render_frame
    mix = tiny_mix(mix_name)
    directory = scenefiles.scene_dir(tiny_config, tmp_path)
    scene = run.reference_scene(tiny_config, directory, "cpu")
    rcfg = run.reference_config(tiny_config, mix)
    poses = traffic.poses(mix, SEED, 40)
    numbers = [compare.frame_numbers(render_frame(scene, poses[g], rcfg,
                                                  lowp=True),
                                     render_frame(scene, poses[g], rcfg))
               for g in (10, 39)]
    assert not compare.within(compare.worst(numbers))


def test_the_reference_scene_is_the_programs(tmp_path, tiny_config):
    directory = scenefiles.scene_dir(tiny_config, tmp_path)
    mine = run.reference_scene(tiny_config, directory, "cpu")
    theirs, _ = run.load_program_scene(tiny_config, directory, "cpu")
    for name in ("tri_valid", "tri_mat", "object_model", "object_normal",
                 "mat_blk_base", "mat_blk_w", "mat_tex_size",
                 "tex_combined", "tri_extra", "corner_pos", "corner_uv",
                 "corner_normal", "corner_tangent", "corner_bitangent",
                 "tri_object"):
        assert torch.equal(getattr(mine, name), getattr(theirs, name)), name


def test_new_files_are_found_by_name(tmp_path, tiny_config):
    """A later cell brings its configuration, its mix and a metric as new
    files; the harness reads them by the names it is given."""
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(tiny_config))
    mix = dict(tiny_mix("fly-cached"), name="fly-slow",
               look_px_per_frame=[0.5, 1.0])
    (tmp_path / "traffic" / "fly-slow.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "frame.traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.frames)\n")
    shutil.copy(ROOT / "metrics" / "frame.syncs_per_frame.py",
                tmp_path / "metrics")
    cell = {"name": "tiny.fly-slow", "config": "tiny", "traffic": "fly-slow",
            "chips": 1}
    bench = e2e_bench(cell["name"])
    bench["per_layer"] = [
        {"name": "frame.traced", "unit": "frames", "moves": "frame_ms",
         "workloads": [cell["name"]]},
        {"name": "frame.syncs_per_frame", "unit": "syncs/frame",
         "moves": "frame_ms", "workloads": [cell["name"]]},
        {"name": "kernel.k1_roofline", "unit": "%", "moves": "frame_ms",
         "workloads": ["another.cell"]}]
    out = run.run_cell(cell, run.load_json(tmp_path / "configs/tiny.json"),
                       run.load_json(tmp_path / "traffic/fly-slow.json"),
                       SEED, 1.0, True, bench,
                       metrics_dir=tmp_path / "metrics",
                       cache=tmp_path / "cache", device="cpu")
    assert out["correct"]
    assert out["metrics"]["frame.traced"]["value"] >= 1
    assert "frame.syncs_per_frame" in out["metrics"]
    assert "kernel.k1_roofline" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_without_a_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sponza-1080p.fly-fresh", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_sample_offsets_lie_in_the_window():
    offs = run.sample_offsets(SEED, 20.0, 4)
    assert offs == sorted(offs) and 0.0 < offs[0] and offs[-1] < 20.0
    assert offs == run.sample_offsets(SEED, 20.0, 4)
    assert not np.allclose(offs, run.sample_offsets(SEED + 1, 20.0, 4))


@pytest.mark.parametrize("seconds, stops_on_margin", [(0.6, True),
                                                     (0.08, False)])
def test_the_profiler_runs_a_margin_around_the_traced_window(
        monkeypatch, seconds, stops_on_margin):
    """The profiler starts ``TRACE_MARGIN_FRAMES`` frames before the
    window's first marker and stops as many after its last, or at the
    window's end where that comes first; the markers sit where they did,
    the first after the warm-up, the last two once the traced time is
    up."""
    mix = dict(tiny_mix("fly-cached"), warmup_frames=30)
    seen, calls = [], []

    class Profiler:
        def start(self):
            calls.append(("start", len(seen)))

        def stop(self):
            calls.append(("stop", len(seen)))

    monkeypatch.setattr(run, "TRACE_SECONDS", 0.05)
    monkeypatch.setattr(run.Window, "_mark",
                        lambda self, name: calls.append((name, len(seen))))
    window = run.Window(mix, SEED, seconds, run.SampleSink([], 30), False,
                        Profiler())
    for ev in window:
        seen.append(ev)
        if ev.quit:
            break
        time.sleep(0.002)
    margin = run.TRACE_MARGIN_FRAMES
    end = 30 + window.traced_frames
    last = len(seen) - 1   # the frame that quits
    stop = end + margin if stops_on_margin else last
    assert calls == [("start", 30 - margin), (tr.BEGIN, 30), (tr.END, end),
                     (tr.DRAINED, end), ("stop", stop)]
    assert stop <= last
