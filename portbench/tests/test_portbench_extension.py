"""What a later configuration brings as added files alone: a scene
generator found by the name in ``geometry.generator``, ``render`` settings
in its configuration or its mix, and a metric reader that counts its
kernel's work from the public ``MetricContext``; and that the sponza
configurations build what they built before."""

import hashlib
import json

import pytest

from portbench import roofline, run, scenefiles, traffic
from portbench import trace as tr
from portbench.tests.conftest import ROOT, tiny_mix

SEED = 2**31 + 4321
# The tiny configuration's scene files as the harness wrote them before
# the generators moved into scenes/: sha256 over each file's name and
# sha256, in name order.
TINY_FILES_SHA256 = \
    "65f819c293e8e741c169412dbc324c56536105f4216bb855e91af773d99839d4"


def files_digest(directory) -> str:
    h = hashlib.sha256()
    for f in sorted(directory.iterdir()):
        h.update(f.name.encode())
        h.update(hashlib.sha256(f.read_bytes()).digest())
    return h.hexdigest()


def test_standin_by_name_writes_the_same_files(tmp_path, tiny_config):
    assert tiny_config["geometry"]["generator"] == "standin"
    directory = scenefiles.scene_dir(tiny_config, tmp_path)
    assert len(list(directory.iterdir())) == 8
    assert files_digest(directory) == TINY_FILES_SHA256


@pytest.mark.parametrize("name", ["courtyard", "../run", "standin.py", ""])
def test_an_unknown_generator_raises_before_anything_is_written(
        tmp_path, tiny_config, tiny_cell, name):
    config = dict(tiny_config,
                  geometry=dict(tiny_config["geometry"], generator=name))
    with pytest.raises(ValueError, match="no scene generator"):
        scenefiles.scene_dir(config, tmp_path / "cache")
    with pytest.raises(ValueError, match="no scene generator"):
        run.run_cell(tiny_cell, config, tiny_mix("fly-fresh"), SEED, 1.0,
                     False, {"end_to_end": [], "per_layer": []},
                     cache=tmp_path / "cache", device="cpu")
    assert not (tmp_path / "cache").exists()


# A generator that no file of the benchmark knows: a floor and a ceiling
# over the courtyard the mixes fly through, in two materials.
SLABS = '''
import numpy as np


def patches(geometry):
    n = geometry["cells"]
    out, vbase = [], 0
    for k, (y, sign) in enumerate(((0.0, 1.0), (500.0, -1.0))):
        xs = np.linspace(-1200.0, 1200.0, n + 1, dtype=np.float32)
        zs = np.linspace(-600.0, 600.0, n + 1, dtype=np.float32)
        xx, zz = np.meshgrid(xs, zs)
        pos = np.stack([xx, np.full_like(xx, y), zz], -1).reshape(-1, 3)
        uv = np.stack([xx, zz], -1).reshape(-1, 2) / 300.0
        nrm = np.tile(np.float32([0.0, sign, 0.0]), (len(pos), 1))
        idx = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
        a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
        c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
        tris = np.concatenate([np.stack([a, c, b], -1),
                               np.stack([b, c, d], -1)]).astype(np.int32)
        if sign < 0:
            tris = tris[:, ::-1]
        out.append((pos, uv, nrm, tris + vbase,
                    np.full(len(tris), k, np.int32)))
        vbase += len(pos)
    return out


def textures(geometry, texture_size):
    s = texture_size
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    out = []
    for k in range(2):
        d = np.full((s, s, 4), 255, np.uint8)
        d[..., k] = ((xx // 4 + yy // 4) % 2 * 200).astype(np.uint8)
        n = np.zeros((s, s, 4), np.uint8)
        n[...] = (128, 128, 255, 255)
        out.append((f"slab_{k}", d, n))
    return out
'''


def test_a_generator_in_a_new_file_is_taken_by_name(tmp_path, tiny_config,
                                                    monkeypatch):
    """A configuration that names a generator kept in a file of its own:
    the harness writes its scene, the program loads it, and a run
    compares correct with the reference, with no edit to any file."""
    scenes = tmp_path / "scenes"
    scenes.mkdir()
    (scenes / "slabs.py").write_text(SLABS)
    monkeypatch.setattr(scenefiles, "SCENES", scenes)
    config = dict(tiny_config, name="slabs",
                  geometry={"generator": "slabs", "cells": 6},
                  expect={"triangles": 144, "materials": 2})
    cell = {"name": "slabs.fly-cached", "config": "slabs",
            "traffic": "fly-cached", "chips": 1}
    out = run.run_cell(cell, config, tiny_mix("fly-cached"), SEED, 1.0,
                       False, {"end_to_end": [{"name": "frame_ms",
                                               "unit": "ms"}],
                               "per_layer": []},
                       cache=tmp_path / "cache", device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert sorted(p.name for p in (tmp_path / "cache" / "slabs").iterdir()) \
        == ["scene.mtl", "scene.obj", "scene_0_d.png", "scene_0_n.png",
            "scene_1_d.png", "scene_1_n.png"]


def test_render_keys_reach_both_render_configs(tiny_config):
    config = dict(tiny_config, render={"occ_scope": "1",
                                       "present_scale": 2, "zfar": 5000})
    mix = dict(tiny_mix("fly-cached"),
               render={"debug_texture": "SHADOW_MAP",
                       "clear_color": [0.0, 0.0, 0.5], "hdr": True})
    for cfg in (run.render_config(config, mix),
                run.reference_config(config, mix)):
        assert cfg.occ_scope == "1" and cfg.present_scale == 2
        assert cfg.zfar == 5000.0 and type(cfg.zfar) is float
        assert cfg.debug_texture.name == "SHADOW_MAP"
        assert type(cfg.debug_texture).__name__ == "DebugTexture"
        assert cfg.clear_color == (0.0, 0.0, 0.5) and cfg.hdr is True
        assert (cfg.width, cfg.height, cfg.shadow_dim) == (96, 64, 256)
        assert cfg.mode.name == "LIT_SHADOW" and cfg.cache_shadow_map


@pytest.mark.parametrize("config_render, mix_render, message", [
    ({"occ_scop": "1"}, {}, "no fields"),
    ({}, {"present_scale": 2, "tile_size": 8}, "no fields"),
    ({"occ_scope": "1"}, {"occ_scope": "0"}, "set by both"),
    ({"width": 128}, {}, "files' own keys"),
    ({}, {"mode": "LIT"}, "files' own keys"),
    ({"debug_texture": "NORMALS"}, {}, "is not one of"),
    ({"hdr": "yes"}, {}, "is no bool"),
    ({"present_scale": 2.0}, {}, "is no int"),
], ids=["unknown_in_config", "unknown_in_mix", "doubled", "own_key_width",
        "own_key_mode", "enum_name", "bool_type", "int_type"])
def test_bad_render_keys_raise_before_anything_is_loaded(
        tmp_path, tiny_config, tiny_cell, config_render, mix_render,
        message):
    config = dict(tiny_config, render=config_render)
    mix = dict(tiny_mix("fly-fresh"), render=mix_render)
    with pytest.raises(ValueError, match=message):
        run.run_cell(tiny_cell, config, mix, SEED, 1.0, False,
                     {"end_to_end": [], "per_layer": []},
                     cache=tmp_path / "cache", device="cpu")
    assert not (tmp_path / "cache").exists()


# A roofline reader as a later PR would add it in a file of its own: it
# counts its kernel's work from the context's public fields alone.
READER = '''
from portbench import roofline
from portbench.reference import frame as rf


def read(ctx):
    counts = []
    for pose in ctx.poses:
        _, _, vout, _, _ = rf.camera_geometry(ctx.scene, pose, ctx.config)
        counts.append(roofline.depth_work(
            rf.shadow_setup(ctx.scene, vout, ctx.config).bbox,
            ctx.config.shadow_dim))
    return [sum(c[k] for c in counts) / len(counts) for k in (0, 1)]
'''


def test_the_metric_context_is_public(tmp_path, tiny_config):
    mix = tiny_mix("fly-fresh")
    directory = scenefiles.scene_dir(tiny_config, tmp_path)
    scene = run.reference_scene(tiny_config, directory, "cpu")
    rcfg = run.reference_config(tiny_config, mix)
    trace = tr.Trace(frames=40, begin_us=0.0, end_us=1.0, drained_us=1.0,
                     device=[], host=[], calls={}, launches=[],
                     kernels={})
    lights = run.reference_lights(tiny_config, "cpu")
    ctx = run.MetricContext(trace, scene, rcfg, lights, mix, SEED,
                            mix["warmup_frames"])
    assert ctx.scene is scene and ctx.config is rcfg and ctx.trace is trace
    assert ctx.lights is lights
    every = traffic.poses(mix, SEED, mix["warmup_frames"] + 40)
    first = mix["warmup_frames"]
    assert len(ctx.poses) == run.WORK_POSES == 2
    for got, want in zip(ctx.poses, (every[first], every[first + 20])):
        assert all((g == w).all() for g, w in zip(got, want))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "kernel.k9_work.py").write_text(READER)
    counted = run.load_metric(tmp_path / "metrics", "kernel.k9_work").read(
        ctx)
    assert tuple(counted) == ctx.work("depth")
    bytes_moved, ops = ctx.work("pixels")
    assert bytes_moved > 0 and ops > 0
    assert roofline.bound_ms(bytes_moved, ops)[0] > 0
    # the shading kernel's work, on the default rig and on 150 lights
    assert lights.points.range.shape == (1,)
    shade = ctx.work("shade")
    lit = run.MetricContext(trace, scene, rcfg, run.reference_lights(
        dict(tiny_config, point_lights=50, expect={"point_lights": 150}),
        "cpu"), mix, SEED, mix["warmup_frames"])
    assert lit.work("shade")[0] == shade[0] > 0
    assert lit.work("shade")[1] > shade[1] > 0


@pytest.mark.parametrize("config_name", ["sponza-1080p", "sponza-2160p"])
@pytest.mark.parametrize("mix_name", ["fly-fresh", "fly-cached",
                                      "fly-wire"])
def test_the_sponza_files_build_the_same_render_configs(config_name,
                                                         mix_name):
    from kanirenderer_tpu_torch.core import types as pt

    from portbench.reference import types as rt
    config = json.loads((ROOT / "configs" / f"{config_name}.json")
                        .read_text())
    mix = json.loads((ROOT / "traffic" / f"{mix_name}.json").read_text())
    assert "render" not in config and "render" not in mix
    assert config["geometry"]["generator"] == "standin"
    assert run.render_config(config, mix) == pt.RenderConfig(
        width=config["width"], height=config["height"],
        shadow_dim=config["shadow_map"], mode=pt.RenderMode[mix["mode"]],
        cache_shadow_map=mix["cache_shadow_map"])
    assert run.reference_config(config, mix) == rt.RenderConfig(
        width=config["width"], height=config["height"],
        shadow_dim=config["shadow_map"], mode=rt.RenderMode[mix["mode"]],
        cache_shadow_map=mix["cache_shadow_map"], output_u8=True)


def test_slice_ms_is_the_mean_interval_of_each_slice():
    # 10 ms frames for the first 5 s, 20 ms ones after: two slices.
    stamps = [0.0025 + 0.01 * k for k in range(500)]
    stamps += [stamps[-1] + 0.02 * k for k in range(1, 251)]
    ms = run.slice_ms(stamps, 0.0, 5.0)
    assert len(ms) == 2
    assert ms[0] == pytest.approx(10.0, rel=1e-6)
    assert ms[1] == pytest.approx(20.0, rel=1e-6)
    assert run.slice_ms([1.0], 1.0) == []
