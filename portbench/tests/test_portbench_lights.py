"""A configuration's light rig (``point_lights``): the loop and the
reference get the same one, the configurations without the key run the
calls they ran before, and a bad rig raises before anything is
written."""

import inspect

import numpy as np
import pytest
import torch

from portbench import run, scenefiles, traffic
from portbench.tests.conftest import tiny_mix

SEED = 2**31 + 5678


def tiny_bench():
    return {"end_to_end": [{"name": "frame_ms", "unit": "ms"}],
            "per_layer": []}


def rig_of(config, **expect):
    return dict(config, expect=dict(config["expect"], **expect))


class Watch:
    """Records the ``point_lights`` that reach ``run_loop``, the rig the
    loop uploads in each frame, and the rig of each reference frame."""

    def __init__(self, monkeypatch):
        from kanirenderer_tpu_torch.runtime import loop

        from portbench.reference import frame
        self.loop_args, self.uploaded, self.reference = [], [], []
        run_loop, upload = loop.run_loop, loop._StateUploader.upload
        render_frame = frame.render_frame

        def watched_run_loop(*args, **kw):
            bound = inspect.signature(run_loop).bind(*args, **kw)
            bound.apply_defaults()
            self.loop_args.append(bound.arguments)
            return run_loop(*args, **kw)

        def watched_upload(uploader, uniforms, cam, movable, sun, points,
                           *rest):
            self.uploaded.append((movable, sun, points))
            return upload(uploader, uniforms, cam, movable, sun, points,
                          *rest)

        def watched_render_frame(*args, lights=None, **kw):
            self.reference.append(lights)
            return render_frame(*args, lights=lights, **kw)

        monkeypatch.setattr(loop, "run_loop", watched_run_loop)
        monkeypatch.setattr(loop._StateUploader, "upload", watched_upload)
        monkeypatch.setattr(frame, "render_frame", watched_render_frame)


def same_rig(port, ref) -> bool:
    """The loop's (movable, sun, points) of one frame, host arrays and
    device tensors, against a reference ``Lights``."""
    movable, sun, points = port
    return (all(np.array_equal(np.asarray(a), b.numpy())
                for a, b in zip(movable, ref.movable))
            and all(np.array_equal(np.asarray(a), b.numpy())
                    for a, b in zip(sun, ref.directional))
            and all(torch.equal(a, b) for a, b in zip(points, ref.points)))


@pytest.mark.parametrize("n", [None, 50], ids=["no_key", "lights50"])
def test_the_rig_reaches_the_loop_and_the_reference(
        tmp_path, tiny_config, monkeypatch, n):
    config = tiny_config if n is None else rig_of(
        dict(tiny_config, point_lights=n), point_lights=3 * n)
    cell = {"name": "tiny.fly-cached", "config": "tiny",
            "traffic": "fly-cached", "chips": 1}
    watch = Watch(monkeypatch)
    out = run.run_cell(cell, config, tiny_mix("fly-cached"), SEED, 1.0,
                       False, tiny_bench(), cache=tmp_path, device="cpu")
    assert out["correct"] and out["failed"] == 0
    (args,) = watch.loop_args
    assert args["point_lights"] == (n or 1)
    assert args["fixed_dt"] == tiny_mix("fly-cached")["fixed_dt"]
    assert args["builder"] is not None and args["sink"] is not None
    want = run.reference_lights(config, "cpu")
    assert want.points.range.shape[0] == (3 * n if n else 1)
    assert len(watch.reference) == 2
    assert all(lights is not None and all(
        torch.equal(a, b) for a, b in zip(lights.points, want.points))
        for lights in watch.reference)
    assert len(watch.uploaded) > 2
    assert all(same_rig(frame, want) for frame in watch.uploaded)


def test_without_the_key_the_reference_draws_as_before(tmp_path,
                                                       tiny_config):
    """The rig a configuration without ``point_lights`` gets is the
    default one, and its frames are the frames of a call without a rig;
    a rig of 150 lights lights them otherwise."""
    from portbench.reference.frame import render_frame
    from portbench.reference.types import default_lights
    mix = tiny_mix("fly-cached")
    directory = scenefiles.scene_dir(tiny_config, tmp_path)
    scene = run.reference_scene(tiny_config, directory, "cpu")
    rcfg = run.reference_config(tiny_config, mix)
    rig = run.reference_lights(tiny_config, "cpu")
    for a, b in zip(rig, default_lights(device="cpu")):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    many = run.reference_lights(
        rig_of(dict(tiny_config, point_lights=50), point_lights=150), "cpu")
    poses = traffic.poses(mix, SEED, 40)
    differs = False
    for g in (10, 39):
        before = render_frame(scene, poses[g], rcfg)
        assert np.array_equal(render_frame(scene, poses[g], rcfg,
                                           lights=rig), before)
        differs |= not np.array_equal(
            render_frame(scene, poses[g], rcfg, lights=many), before)
    assert differs


@pytest.mark.parametrize("n", [1, 2, 49, 50, 150])
def test_the_loops_rig_is_the_references(tmp_path, tiny_config,
                                         monkeypatch, n):
    from kanirenderer_tpu_torch.core.types import RenderConfig, RenderMode
    from kanirenderer_tpu_torch.runtime import loop
    from kanirenderer_tpu_torch.runtime.loop import Events
    scene, _ = run.load_program_scene(
        tiny_config, scenefiles.scene_dir(tiny_config, tmp_path), "cpu")
    watch = Watch(monkeypatch)
    loop.run_loop(scene, [Events()], max_frames=1, point_lights=n,
                  config=RenderConfig(width=32, height=32, shadow_dim=64,
                                      mode=RenderMode.LIT))
    want = run.reference_lights(
        {"name": "rig", "point_lights": n,
         "expect": {"point_lights": 3 * n if n >= 50 else n}}, "cpu")
    (frame,) = watch.uploaded
    assert same_rig(frame, want)


@pytest.mark.parametrize("key, expect, message", [
    ("150", 450, "no whole number"), (1.5, 1, "no whole number"),
    (150.0, 450, "no whole number"), (True, 1, "no whole number"),
    (0, 1, "no whole number"), (-3, 1, "no whole number"),
    (50, 50, "expects 50"), (49, 147, "expects 147"),
    (150, None, "expects None"), (None, 3, "expects 3"),
    (2, "2", "expects '2'")],
    ids=["string", "fraction", "float", "bool", "zero", "negative",
         "expect_n_not_3n", "expect_3n_under_50", "expect_missing",
         "expect_without_key", "expect_string"])
def test_a_bad_rig_raises_before_anything_is_written(
        tmp_path, tiny_config, tiny_cell, key, expect, message):
    config = dict(tiny_config)
    if key is not None:
        config["point_lights"] = key
    if expect is not None:
        config = rig_of(config, point_lights=expect)
    with pytest.raises(ValueError, match=message):
        run.run_cell(tiny_cell, config, tiny_mix("fly-fresh"), SEED, 1.0,
                     False, tiny_bench(), cache=tmp_path / "cache",
                     device="cpu")
    assert not (tmp_path / "cache").exists()
