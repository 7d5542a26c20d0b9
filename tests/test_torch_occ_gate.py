"""The port's occlusion scopes: ``occ_on`` (RenderConfig.occ_scope and
KANI_OCC), the load-time gate (ops/occ_replay.choose_occ_scope) against
the JAX package's at the configuration of tests/test_occ_gate.py:21-50,
scope "1" with interleaved row bands, and ``KANI_OCC=auto`` in api.run.
Every scope renders the same pixels: frames are compared bit for bit.
On the CPU the raster wrappers take their plain versions, which never
skip; where a test holds the skip itself, it replays the kernels' rule
(ops/occ_replay) on the CPU.
"""

import functools

import pytest
import torch

import kanirenderer_tpu as kani
from kanirenderer_tpu.core.types import default_camera as ref_camera
from kanirenderer_tpu.core.types import default_lights as ref_lights
from kanirenderer_tpu.core.types import frame_state as ref_frame_state
from kanirenderer_tpu.models.procedural import layered_scene as ref_layered
from kanirenderer_tpu.ops import occ_replay as ref_occ

from kanirenderer_tpu_torch import api
from kanirenderer_tpu_torch.core.types import (RenderConfig, RenderMode,
                                               default_camera,
                                               default_lights, frame_state)
from kanirenderer_tpu_torch.models.procedural import layered_scene
from kanirenderer_tpu_torch.ops import occ_replay
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops.binning import interleave_bins
from kanirenderer_tpu_torch.passes.frame import (frame_geometry, render_band,
                                                 render_frame)
from kanirenderer_tpu_torch.runtime.loop import Events

import chip_smoke

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def layered():
    """layered_scene(target_tris=8000) at the gate test's configuration
    (tests/test_occ_gate.py:21-34), scope "1"."""
    scene = layered_scene(target_tris=8_000, device="cpu")
    state = frame_state(scene, default_camera("cpu"),
                        default_lights(device="cpu"))
    cfg = RenderConfig(width=256, height=128, shadow_dim=64,
                       mode=RenderMode.LIT, occ_scope="1")
    return scene, state, cfg


def test_gate_decisions_match_the_reference():
    """At the reference's threshold the gate picks "1" on layered content
    and "shadow" on one wall, as the JAX gate does at the same
    configuration, and its estimates clear the bounds of
    tests/test_occ_gate.py:26-50; at its own threshold (the card's) the
    decision follows the estimate."""
    cfg_ref = kani.RenderConfig(width=256, height=128, shadow_dim=64,
                                mode=kani.RenderMode.LIT)
    cfg = RenderConfig(width=256, height=128, shadow_dim=64,
                       mode=RenderMode.LIT)
    for kw, want in ((dict(target_tris=8_000), "1"),
                     (dict(layers=1, target_tris=4_000), "shadow")):
        ref_scene = ref_layered(**kw)
        ref_st = ref_frame_state(ref_scene, ref_camera(), ref_lights())
        ref_scope, _ = ref_occ.choose_occ_scope(ref_scene, ref_st, cfg_ref,
                                                tile_stride=2)
        scene = layered_scene(**kw, device="cpu")
        st = frame_state(scene, default_camera("cpu"),
                         default_lights(device="cpu"))
        scope, est = occ_replay.choose_occ_scope(
            scene, st, cfg, tile_stride=2,
            threshold=ref_occ.EVAL_DROP_THRESHOLD)
        assert est["evals_sampled"] > 0
        assert scope == ref_scope == want, est
        if want == "1":
            assert est["eval_drop"] > 0.3, est
        else:
            assert est["eval_drop"] < 0.05, est
        card_scope, card_est = occ_replay.choose_occ_scope(scene, st, cfg,
                                                           tile_stride=2)
        assert card_est == est
        assert card_scope == ("1" if est["eval_drop"]
                              >= occ_replay.EVAL_DROP_THRESHOLD
                              else "shadow")


@pytest.mark.parametrize("env,scope,depth,want", [
    (None, "env", True, True), (None, "env", False, False),
    ("auto", "env", True, True), ("auto", "env", False, False),
    ("1", "env", False, True), ("0", "env", True, False),
    ("1", "0", True, False), (None, "shadow", True, True),
    (None, "shadow", False, False), (None, "1", False, True),
    (None, "auto", False, False), (None, "auto", True, True),
])
def test_scope_table(monkeypatch, env, scope, depth, want):
    if env is None:
        monkeypatch.delenv("KANI_OCC", raising=False)
    else:
        monkeypatch.setenv("KANI_OCC", env)
    assert rc.occ_on(scope, depth) is want


def test_interleaved_bands_with_scope_1_reassemble(layered):
    """Scope "1" with interleaved bands: the bands' rows are the whole
    frame's, and the whole frame is the one with scope "0".  On the CPU
    the raster wrappers take their plain versions, which never skip, so
    the frames check the nearest-first bins and the wiring; the skip
    itself is checked by ops/occ_replay's raster, which skips by the
    kernels' rule, on each band's interleaved bins against the whole
    frame's plain raster."""
    scene, state, cfg = layered
    for mode in (RenderMode.LIT, RenderMode.WIREFRAME):
        c = cfg.with_(mode=mode, height=128, output_u8=True)
        g = frame_geometry(scene, state, c)
        assert g.bins.bound is not None
        wire = c.wire_thresh_px if mode == RenderMode.WIREFRAME else None
        ref = rc.rasterize_pixels_plain(
            g.records, g.setup.setup, g.setup.bbox, g.bins, c.width,
            c.height, wire is not None, c.wire_thresh_px)
        whole = render_frame(scene, state, c)
        off = render_frame(scene, state, c.with_(occ_scope="0"))
        assert torch.equal(whole.image, off.image)
        n, th = 2, c.tile_h
        J = c.height // th // n
        bands = [render_band(scene, state, c, band_h=J * th, y0=k * th,
                             band_stride=n) for k in range(n)]
        img = torch.empty_like(whole.image)
        z = torch.empty_like(ref.z)
        tid = torch.empty_like(ref.tid)
        skipped = 0
        for k, b in enumerate(bands):
            r = occ_replay.replay(g.setup.setup, g.setup.bbox,
                                  interleave_bins(g.bins, k, n), c.width,
                                  c.height, wire, y0=k * th, y_stride=n,
                                  band_h=J * th)
            skipped += r.counts["hits_dropped"] + r.counts["chunks_skipped"]
            for j in range(J):
                rows = slice((j * n + k) * th, (j * n + k + 1) * th)
                img[rows] = b.image[j * th:(j + 1) * th]
                z[rows], tid[rows] = r.z[j * th:(j + 1) * th], \
                    r.tid[j * th:(j + 1) * th]
        assert torch.equal(img, whole.image), mode
        assert torch.equal(z, ref.z) and torch.equal(tid, ref.tid), mode
        if mode == RenderMode.LIT:  # wireframe leaves the walls open
            assert skipped > 0


@pytest.mark.parametrize("threshold", ["card", "reference"])
def test_api_run_with_kani_occ_auto(tmp_path, monkeypatch, capsys,
                                    threshold):
    """api.run on the layered scene written as OBJ, the camera standing at
    the start pose: KANI_OCC=auto prints the gate's decision (at the
    card's threshold, and at the reference's, where it picks "1"), and
    the frames are those of KANI_OCC=0.  On the CPU the rasters take
    their plain versions, which never skip: this checks the gate's
    wiring into api.run, not the skip (the card tests and chip_smoke
    phase 24 do)."""
    if threshold == "reference":
        monkeypatch.setattr(api, "choose_occ_scope", functools.partial(
            occ_replay.choose_occ_scope,
            threshold=ref_occ.EVAL_DROP_THRESHOLD))
    path = chip_smoke.write_layered_obj(str(tmp_path), target_tris=4_000,
                                        tex_size=16)
    frames = {}
    for occ in ("auto", "0"):
        monkeypatch.setenv("KANI_OCC", occ)
        out = str(tmp_path / f"{occ}_%d.png")
        api.run(path, width=128, height=64, frames=2, sink="png", out=out,
                events=[Events(), Events()], device="cpu")
        frames[occ] = [(tmp_path / f"{occ}_{i}.png").read_bytes()
                       for i in range(2)]
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("occlusion gate: scope ")]
    assert len(said) == 1, said
    if threshold == "reference":
        assert said[0].startswith("occlusion gate: scope 1 "), said
    assert frames["auto"] == frames["0"]
