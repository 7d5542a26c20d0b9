"""The port's entry surface: ``api.load_model_or_default``, ``api.run``,
``cli.main``, ``python -m kanirenderer_tpu_torch``, the profile trace, the
environment overrides, and the package boundary (no module of the port and
not chip_smoke.py imports jax or the JAX package).

Tolerances: the statistics dictionary of ``api.run`` has the keys of the
JAX package's and equal values wherever they do not depend on the clock;
the frames the two packages' ``api.run`` write as PNGs for the default
cube agree by the golden criterion; a scene loaded from the files the
smoke run's writer makes has the stand-in's triangle and material counts
exactly.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kanirenderer_tpu import api as ref_api
from kanirenderer_tpu.io import native as ref_native

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch import api, cli
from kanirenderer_tpu_torch.io import image
from kanirenderer_tpu_torch.models.procedural import (make_cube_obj,
                                                      sponza_standin_scene)
from kanirenderer_tpu_torch.runtime.loop import Events

import chip_smoke

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_png(path):
    with open(path, "rb") as f:
        return image.decode_png(f.read())


@pytest.mark.parametrize("case", ["empty", "missing", "corrupt", "file"])
def test_load_model_or_default(tmp_path, case, capsys):
    """The reference's fallback chain: an empty or missing path and any
    load error give the default cube; a good file is loaded."""
    path = {"empty": "", "missing": str(tmp_path / "nope.obj"),
            "corrupt": str(tmp_path / "bad.obj"),
            "file": str(tmp_path / "small.obj")}[case]
    if case == "corrupt":
        (tmp_path / "bad.obj").write_text("v 0 0 0\nf 1 two 3\n")
    if case == "file":
        (tmp_path / "small.obj").write_text(make_cube_obj(2.0))
    scene, builder = api.load_model_or_default(path, device="cpu")
    assert int(scene.tri_valid.sum()) == 12 and scene.device.type == "cpu"
    assert float(scene.position.abs().max()) == (2.0 if case == "file"
                                                 else 25.0)
    assert len(builder.textures) == 1
    said = capsys.readouterr().out
    assert ("default cube" in said) == (case in ("missing", "corrupt"))


def test_written_standin_loads_with_its_counts(tmp_path):
    """The smoke run's OBJ writer and the loader, at a small size: the
    stand-in's triangles and materials come back, the 16-bit normal map
    selects the separate tables, and the loaded geometry is the packed
    stand-in's."""
    kw = dict(target_tris=3000, num_materials=3, tex_size=16)
    path = chip_smoke.write_standin_obj(str(tmp_path), **kw)
    scene, builder = api.load_model_or_default(path, device="cpu")
    ref = sponza_standin_scene(**kw, device="cpu")
    assert int(scene.tri_valid.sum()) == int(ref.tri_valid.sum()) == 2448
    assert scene.mat_blk_base.shape[0] == 3 == len(builder.textures)
    assert torch.equal(scene.mat_tex_size, ref.mat_tex_size)
    assert scene.tex_combined.shape == ref.tex_combined.shape
    # %.9g round-trips float32: the same triangles, whatever their order
    def tri_set(s):
        corners = s.position[s.tri_idx.long()][s.tri_valid]
        return torch.unique(corners.reshape(-1, 9), dim=0)
    assert torch.equal(tri_set(scene), tri_set(ref))
    assert torch.isfinite(scene.position).all()

    path16 = chip_smoke.write_standin_obj(str(tmp_path), name="deep",
                                          normal16=True, **kw)
    deep, _ = api.load_model_or_default(path16, device="cpu")
    assert deep.tex_normal.dtype == torch.uint16
    assert deep.tex_combined.shape[0] == 0 and deep.tex_diffuse.shape[0] > 0


def test_api_run_writes_pngs_and_matches_reference(tmp_path, monkeypatch):
    """64×64, 2 frames, PNG sink, the default cube, a static camera: the
    statistics and the written frames against the JAX package's api.run."""
    monkeypatch.setattr(ref_native, "compute_tbn", lambda *a: None)
    monkeypatch.setattr(ref_native, "morton_order", lambda *a: None)
    kw = dict(width=64, height=64, frames=2, sink="png", verbose=False,
              mode=None)
    stats, frames = {}, {}
    for name, mod, extra in (("ref", ref_api, {}),
                             ("port", api, dict(device="cpu"))):
        pkg = port if mod is api else __import__("kanirenderer_tpu")
        out = str(tmp_path / f"{name}_%02d.png")
        stats[name] = mod.run("", "opengl", out=out, **extra, **{
            **kw, "mode": pkg.RenderMode.WIREFRAME,
            "events": [Events(), Events(pressed=frozenset(["f1"]))]})
        frames[name] = [read_png(out % i) for i in range(2)]
    assert set(stats["port"]) == set(stats["ref"])
    for k in ("frames", "mode", "present_mode", "picked", "healed",
              "view_size", "render_size"):
        assert stats["port"][k] == stats["ref"][k], k
    assert stats["port"]["mean_ms"] > 0 and stats["port"]["fps"] > 0
    for a, b in zip(frames["port"], frames["ref"]):
        assert a.shape == b.shape == (64, 64, 3)
        diff = np.abs(a.astype(int) - b.astype(int))
        assert (diff > 8).mean() < 0.01 and diff.mean() < 1.5
        assert a.std() > 10       # the wireframe cube from inside


def test_api_run_environment_overrides(tmp_path, monkeypatch):
    out = str(tmp_path / "env.png")
    for k, v in dict(KANI_WIDTH="128", KANI_HEIGHT="64", KANI_FRAMES="1",
                     KANI_SINK="png", KANI_OUT=out, KANI_MODE="unlit",
                     KANI_RENDER_SCALE="2", KANI_PRESENT_SCALE="2").items():
        monkeypatch.setenv(k, v)
    stats = api.run("", width=999, height=999, frames=7, sink="null",
                    verbose=False, device="cpu")
    assert stats["frames"] == 1 and stats["mode"] == "UNLIT"
    assert stats["render_size"] == (64, 32)
    # the PNG sink is no scaling sink: the half-size preview is brought
    # back to the view size for it
    assert read_png(out).shape == (32, 64, 3)


def test_profile_trace_written(tmp_path):
    d = tmp_path / "trace"
    api.run("", "opengl", frames=1, sink="null", width=64, height=64,
            verbose=False, profile_dir=str(d), device="cpu")
    found = [f for _, _, fs in os.walk(d) for f in fs]
    assert found == ["trace.json"]
    assert os.path.getsize(d / "trace.json") > 1000


def test_cli_main_writes_a_png(tmp_path, capsys):
    objpath = tmp_path / "c.obj"
    objpath.write_text(make_cube_obj(2.0))
    out = str(tmp_path / "cli_%d.png")
    rc = cli.main([str(objpath), "opengl", "windowed", "hdr:false",
                   "--width", "64", "--height", "64", "--frames", "2",
                   "--mode", "lit", "--sink", "png", "--out", out,
                   "--device", "cpu"])
    assert rc == 0
    said = capsys.readouterr().out
    assert "rendered 2 frames" in said and "WASD" in said
    img = read_png(out % 1)
    assert img.shape == (64, 64, 3) and img.std() > 5
    with pytest.raises(SystemExit):
        cli.main(["--backend", "pallas"])    # the JAX package's flag is gone


def test_python_m_runs_and_needs_a_card_by_default(tmp_path):
    out = str(tmp_path / "m.png")
    base = [sys.executable, "-m", "kanirenderer_tpu_torch", "", "opengl",
            "--width", "32", "--height", "32", "--frames", "1", "--quiet",
            "--out", out]
    ok = subprocess.run(base + ["--device", "cpu"], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert read_png(out).shape == (32, 32, 3)
    if not torch.cuda.is_available():
        bad = subprocess.run(base, cwd=REPO, capture_output=True, text=True,
                             timeout=120)
        assert bad.returncode != 0 and "CUDA" in bad.stderr


def test_entry_points_default_to_the_card(tmp_path):
    """The new entry points build on the CUDA device unless told otherwise
    and raise without one; none falls back to the CPU."""
    from kanirenderer_tpu_torch.io.scene_loader import load_scene
    from kanirenderer_tpu_torch.models import procedural
    objpath = tmp_path / "c.obj"
    objpath.write_text(make_cube_obj())
    calls = {
        "load_scene": lambda: load_scene(str(objpath)),
        "cube_scene": procedural.cube_scene,
        "layered_scene": lambda: procedural.layered_scene(
            layers=2, target_tris=200, tex_size=8),
        "spawn_point_lights": lambda: port.spawn_point_lights(3),
        "load_model_or_default": lambda: api.load_model_or_default("")[0],
        "api.run": lambda: api.run("", frames=1, sink="null", width=32,
                                   height=32, verbose=False),
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            leaves = torch.utils._pytree.tree_leaves(call())
            assert all(t.device.type == "cuda" for t in leaves
                       if isinstance(t, torch.Tensor)), name
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_smoke_script_import_no_jax():
    """Every source file of the port and chip_smoke.py, by their import
    statements (function-level ones included): nothing of jax, jaxlib or
    the JAX package; then every module of the port imported in a fresh
    interpreter leaves none of them loaded."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "kanirenderer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 35
    for path in files:
        bad = [m for m in _imports(path)
               if m.split(".")[0] in ("jax", "jaxlib", "kanirenderer_tpu")]
        assert not bad, (path, bad)
    code = (
        "import sys, pkgutil, importlib, kanirenderer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                               p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'kanirenderer_tpu')]\n"
        "need = ['api', 'cli', '__main__', 'io.obj', 'io.image', 'io.jpeg',\n"
        "        'runtime.loop', 'runtime.display', 'runtime.input',\n"
        "        'runtime.frametime', 'models.animation', 'utils.log',\n"
        "        'parallel', 'parallel.mesh', 'ops.occ_replay']\n"
        "missing = [n for n in need if p.__name__ + '.' + n not in names]\n"
        "print(len(bad), missing, 'triton' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 [] False", out.stdout
