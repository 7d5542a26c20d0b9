"""The port's runtime layer against the JAX package's: controllers (host
and tensor forms), frame-time ring, event accumulation, the size ladder,
sinks, the instance animation and ``run_loop`` on ``device="cpu"``.

Tolerances: controllers within 1e-6 (positions 1e-4 absolute at their
magnitude of hundreds, as the JAX package's own twin test); pure-Python
copies (FrameTimeGraph, EventAccumulator, _bucket, sinks) exact; the
loop's steady-state frame equal to the port's fresh frame
(``assert_array_equal``); the loop's presented frames against the JAX
loop's for the same events by the golden criterion (under 1% of values
more than 8 levels apart, mean under 1.5).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import kanirenderer_tpu as kani
from kanirenderer_tpu.io import native as ref_native
from kanirenderer_tpu.io import obj as ref_obj
from kanirenderer_tpu.io import scene_loader as ref_loader
from kanirenderer_tpu.runtime import controllers as ref_controllers
from kanirenderer_tpu.runtime import frametime as ref_frametime
from kanirenderer_tpu.runtime import input as ref_input
from kanirenderer_tpu.runtime import loop as ref_loop

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.io import image
from kanirenderer_tpu_torch.io.scene_loader import SceneBuilder
from kanirenderer_tpu_torch.io import obj as obj_mod
from kanirenderer_tpu_torch.models.animation import random_walk_objects
from kanirenderer_tpu_torch.models.procedural import cube_scene, make_cube_obj
from kanirenderer_tpu_torch.passes.frame import render_frame
from kanirenderer_tpu_torch.runtime import controllers, display
from kanirenderer_tpu_torch.runtime import loop as loop_mod
from kanirenderer_tpu_torch.runtime.frametime import FrameTimeGraph
from kanirenderer_tpu_torch.runtime.input import TK_KEYMAP, EventAccumulator
from kanirenderer_tpu_torch.runtime.loop import (PRESENT_MODES, Events,
                                                 run_loop)

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return cube_scene(device="cpu")


def stage_obj() -> str:
    """A cube standing on a floor in front of the loop's start camera
    (which sits inside the default cube and sees only culled back faces):
    lit faces, a shadow on the floor, background above."""
    lines = []
    for line in make_cube_obj(20.0).splitlines():
        if line.startswith("v "):
            x, y, z = map(float, line.split()[1:])
            line = f"v {x} {y - 5.0} {z - 80.0}"
        lines.append(line)
    lines += ["v -300 -25 100", "v 300 -25 100", "v 300 -25 -400",
              "v -300 -25 -400",
              "f 25/1/5 26/2/5 27/3/5", "f 25/1/5 27/3/5 28/4/5"]
    return "\n".join(lines) + "\n"


def build_stage(pkg_obj, builder, **build_kw):
    parsed = pkg_obj.parse_obj(stage_obj(), mtl_loader=lambda p: None)
    builder.add_model(parsed, ".")
    return builder.build(**build_kw)


@pytest.fixture(scope="module")
def stage():
    return build_stage(obj_mod, SceneBuilder(), device="cpu")


class Capture:
    """A frame-capturing sink without ``scales_preview``."""

    def __init__(self):
        self.frames = []

    def present(self, f):
        self.frames.append(np.array(f))

    def close(self):
        pass


def small(**kw):
    kw.setdefault("shadow_dim", 64)
    return port.RenderConfig(**kw)


# ---- controllers ---------------------------------------------------------

def _draw(rng):
    cam = dict(position=(rng.randn(3) * 100).astype(np.float32),
               yaw=np.float32(rng.uniform(-3, 3)),
               pitch=np.float32(rng.uniform(-1.4, 1.4)))
    cam_in = [float(x) for x in rng.randint(0, 2, 6)] \
        + [float(rng.randn() * 5), float(rng.randn() * 5), float(rng.randn())]
    light_in = [float(x) for x in rng.randint(0, 2, 6)] \
        + [float(rng.randint(-1, 2)), float(rng.randint(-1, 2))]
    return cam, cam_in, light_in, float(rng.uniform(0.001, 0.1))


def _close(ref, got, atol):
    for name, a in ref._asdict().items():
        b = getattr(got, name)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert b.dtype == np.float32, name
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("which", ["camera", "movable_light", "rotate_sun",
                                   "sun_distance"])
def test_controllers_match_reference(which):
    """Host and tensor forms of each controller against the JAX one."""
    rng = np.random.RandomState(3)
    host_lights = loop_mod._host_start_state()
    for _ in range(10):
        cam, cam_in, light_in, dt = _draw(rng)
        if which == "camera":
            ref = ref_controllers.update_camera(
                kani.CameraState(**{k: jnp.asarray(v)
                                    for k, v in cam.items()}),
                ref_controllers.CameraInputs(*cam_in), dt)
            inp = controllers.CameraInputs(*cam_in)
            host = controllers.update_camera_host(
                controllers.HostCamera(**cam), inp, dt)
            dev = controllers.update_camera(
                port.camera_state(device="cpu", **cam), inp, dt)
            atol = 1e-4
        elif which == "movable_light":
            ref = ref_controllers.update_movable_light(
                kani.default_lights().movable,
                ref_controllers.LightInputs(*light_in), dt)
            inp = controllers.LightInputs(*light_in)
            host = controllers.update_movable_light_host(host_lights[1], inp,
                                                         dt)
            dev = controllers.update_movable_light(
                port.default_lights(device="cpu").movable, inp, dt)
            atol = 1e-4
        elif which == "rotate_sun":
            deg = [float(x) for x in rng.uniform(-30, 30, 3)]
            ref = ref_controllers.rotate_directional_light(
                kani.default_lights().directional, *deg)
            host = controllers.rotate_directional_light_host(host_lights[2],
                                                             *deg)
            dev = controllers.rotate_directional_light(
                port.default_lights(device="cpu").directional, *deg)
            atol = 1e-6
        else:
            delta = float(rng.choice([-10.0, 10.0, -1e6, 1e6]))
            ref = ref_controllers.step_directional_distance(
                kani.default_lights().directional, delta)
            host = controllers.step_directional_distance_host(host_lights[2],
                                                              delta)
            dev = controllers.step_directional_distance(
                port.default_lights(device="cpu").directional, delta)
            atol = 1e-4
        _close(ref, host, atol)
        _close(ref, dev, atol)


def test_controller_constants_and_key_steps():
    for name in ("SAFE_PITCH", "CAMERA_SPEED", "CAMERA_SENSITIVITY",
                 "LIGHT_SPEED"):
        assert getattr(controllers, name) == getattr(ref_controllers, name)
    m = loop_mod._host_start_state()[1]
    m2 = controllers.update_movable_light_host(
        m, controllers.LightInputs(d_range=1), 0.0)
    assert float(m2.range) == float(m.range) + 5.0
    m3 = controllers.update_movable_light_host(
        m2, controllers.LightInputs(d_color=1), 0.0)
    np.testing.assert_allclose(m3.color, m2.color + 5.0)
    c = controllers.update_camera_host(
        controllers.HostCamera(np.zeros(3, np.float32), np.float32(0),
                               np.float32(0)),
        controllers.CameraInputs(rotate_dy=-1e6), 1.0)
    assert abs(float(c.pitch)) <= controllers.SAFE_PITCH + 1e-7


# ---- pure-Python copies --------------------------------------------------

def test_frametime_graph_ring():
    g, r = FrameTimeGraph(), ref_frametime.FrameTimeGraph()
    for i in range(300):
        g.update(0.01 + 1e-5 * i)
        r.update(0.01 + 1e-5 * i)
    np.testing.assert_array_equal(g.buffer, r.buffer)
    assert g.buffer.shape == (256,) and g.buffer.dtype == np.float32
    assert (g.mean_ms, g.fps, g.current_index) \
        == (r.mean_ms, r.fps, r.current_index)
    assert FrameTimeGraph().fps == 0.0


def _feed(acc):
    """A scripted sequence of window events; returns every polled Events."""
    out = []
    acc.key_press("w")
    acc.key_press("Shift_L")
    acc.key_press("Tab")
    out.append(acc.poll())
    acc.key_release("Tab")      # X11 auto-repeat: release + press
    acc.key_press("Tab")
    acc.key_release("w")
    out.append(acc.poll())
    acc.mouse_move(100, 100)
    acc.button_press(3, 100, 100)
    acc.mouse_move(110, 95)
    acc.raw_move(7, -3)
    out.append(acc.poll())
    acc.button_release(3)
    acc.reset_pointer()
    acc.mouse_move(320, 240)
    acc.button_press(1, 42, 17)
    acc.button_press(4, 0, 0)
    acc.wheel(-240)
    acc.configure(800, 600)
    acc.drop_file("model.obj")
    acc.key_press("unknown_key")
    out.append(acc.poll())
    out.append(acc.poll())
    acc.key_press("Escape")
    out.append(acc.poll())
    return out


def test_event_accumulator_matches_reference():
    ours = _feed(EventAccumulator())
    ref = _feed(ref_input.EventAccumulator())
    assert [tuple(e) for e in ours] == [tuple(e) for e in ref]
    assert all(isinstance(e, Events) for e in ours)
    assert Events._fields == ref_loop.Events._fields
    assert ours[0].pressed == frozenset({"w", "lshift", "tab"})
    assert "tab" in ours[1].held and "tab" not in ours[1].pressed
    assert ours[2].mouse_look and (ours[2].mouse_dx, ours[2].mouse_dy) \
        == (17, -8)
    assert ours[3].click_pos == (42, 17) and ours[3].scroll == -1.0
    assert ours[3].resize == (800, 600) and ours[3].mouse_dx == 0
    assert ours[3].dropped_file == "model.obj"
    assert ours[4].click_pos is None and not ours[4].quit
    assert ours[5].quit
    assert TK_KEYMAP == ref_input.TK_KEYMAP


@pytest.mark.parametrize("v", [1, 256, 257, 1000, 1920, 3840, 3841, 5000])
def test_size_ladder(v):
    assert loop_mod._bucket(v) == ref_loop._bucket(v) >= v
    assert loop_mod._SIZE_LADDER == ref_loop._SIZE_LADDER
    assert PRESENT_MODES == ref_loop.PRESENT_MODES


# ---- sinks ----------------------------------------------------------------

def test_to_uint8_takes_tensors_and_arrays():
    f = np.linspace(-0.1, 1.1, 24, dtype=np.float32).reshape(2, 4, 3)
    want = np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(display.to_uint8(f), want)
    np.testing.assert_array_equal(display.to_uint8(torch.from_numpy(f)),
                                  want)
    np.testing.assert_array_equal(
        display.to_uint8(torch.from_numpy(f).to(torch.float16)),
        np.clip(f.astype(np.float16).astype(np.float32) * 255.0 + 0.5, 0,
                255).astype(np.uint8))
    u8 = torch.arange(24, dtype=torch.uint8).reshape(2, 4, 3)
    np.testing.assert_array_equal(display.to_uint8(u8), u8.numpy())


@pytest.mark.parametrize("pattern", ["f_%03d.png", "single.png"])
def test_png_sink_writes_decodable_frames(tmp_path, pattern):
    sink = display.make_sink("png", str(tmp_path / pattern), 8, 8)
    frames = [np.full((8, 8, 3), 40 * i, np.uint8) for i in range(3)]
    for f in frames:
        sink.present(f)
    sink.close()
    names = sorted(os.listdir(tmp_path))
    assert names == (["f_000.png", "f_001.png", "f_002.png"]
                     if "%" in pattern else
                     ["single.png", "single_0001.png", "single_0002.png"])
    for name, f in zip(names, frames):
        with open(tmp_path / name, "rb") as fh:
            np.testing.assert_array_equal(image.decode_png(fh.read()), f)


def test_gif_and_null_sinks(tmp_path):
    path = str(tmp_path / "cap.gif")
    s = display.make_sink("gif", path, 8, 8)
    assert isinstance(s, display.GifSink)
    for i in range(3):
        s.present(np.full((8, 8, 3), i * 80, np.uint8))
    s.close()
    assert os.path.getsize(path) > 0
    null = display.make_sink("null", None, 8, 8)
    assert null.scales_preview
    null.present(np.zeros((2, 2, 3), np.uint8), view=(4, 4))
    null.close()
    with pytest.raises(ValueError):
        display.make_sink("hologram", None, 8, 8)


def test_scale_to_view():
    small_img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    up = display._scale_to_view(small_img, (12, 8))
    np.testing.assert_array_equal(
        up, np.repeat(np.repeat(small_img, 2, axis=0), 2, axis=1))
    assert display._scale_to_view(small_img, (13, 9)).shape == (9, 13, 3)
    assert display._scale_to_view(small_img, None) is small_img


# ---- animation --------------------------------------------------------------

def test_random_walk_objects(scene):
    """Held to its distribution, not to the JAX key's bits: every step
    within ±speed·dt, the rotation block untouched, the same seed the same
    walk."""
    m0 = torch.eye(4).repeat(64, 1, 1)
    gen = torch.Generator().manual_seed(5)
    m1 = random_walk_objects(m0, gen, 1.0 / 60.0)
    d = (m1[:, :3, 3] - m0[:, :3, 3])
    assert (d.abs() > 0).all() and (d.abs() <= 100.0 / 60.0 + 1e-5).all()
    assert d.min() < -0.8 and d.max() > 0.8 and abs(float(d.mean())) < 0.3
    assert torch.equal(m1[:, :3, :3], m0[:, :3, :3])
    assert torch.equal(m1[:, 3], m0[:, 3])
    m2 = random_walk_objects(m1, gen, 1.0 / 60.0, speed=10.0)
    assert ((m2 - m1)[:, :3, 3].abs() <= 10.0 / 60.0 + 1e-5).all()
    again = random_walk_objects(m0, torch.Generator().manual_seed(5),
                                1.0 / 60.0)
    assert torch.equal(again, m1)
    out = render_frame(scene, port.frame_state(
        scene, port.default_camera(device="cpu"),
        port.default_lights(device="cpu"))._replace(
            object_model=random_walk_objects(
                scene.object_model, gen, 1.0)),
        small(width=32, height=24, mode=port.RenderMode.LIT))
    assert out.image.isfinite().all()


# ---- run_loop -------------------------------------------------------------

def test_loop_tab_cycles_modes_and_renders(scene):
    events = [Events()] + [Events(pressed=frozenset(["tab"]))] * 3
    sink = Capture()
    stats = run_loop(scene, events, config=small(width=64, height=48),
                     sink=sink)
    assert stats["frames"] == 4 and stats["mode"] == "UNLIT"
    assert [f.shape for f in sink.frames] == [(48, 64, 3)] * 4
    assert sink.frames[1].max() == 255          # WIREFRAME draws white
    assert set(stats) == {"frames", "mean_ms", "fps", "mode", "present_mode",
                          "picked", "healed", "view_size", "render_size"}


def test_loop_present_mode_cycle_and_picking(scene):
    events = [Events(pressed=frozenset(["f1"])), Events(click_pos=(32, 24)),
              Events(click_pos=(-5, 999))]
    stats = run_loop(scene, events, sink_kind="null", config=small(
        width=64, height=48, mode=port.RenderMode.LIT))
    assert stats["present_mode"] == "AutoNoVsync"
    (x, y, raw, linear), (x2, y2, raw2, _) = stats["picked"]
    assert (x, y) == (32, 24) and (x2, y2) == (0, 47)   # clamped to the view
    assert 0.0 <= raw <= 1.0 and 0.1 <= linear <= 10050.0


def test_loop_f11_drives_sink_and_quit_stops(scene):
    class Fullscreen(Capture):
        calls = []

        def set_fullscreen(self, fs):
            self.calls.append(fs)

    sink = Fullscreen()
    events = iter([Events(pressed=frozenset({"f11", "f1"})),
                   Events(pressed=frozenset({"f11"})), Events(quit=True),
                   Events()])
    stats = run_loop(scene, events, sink=sink, config=small(
        width=64, height=64, mode=port.RenderMode.UNLIT))
    assert sink.calls == [True, False]
    assert stats["present_mode"] == PRESENT_MODES[1]
    assert stats["frames"] == 2 and len(sink.frames) == 2


def _count_shadow_passes(monkeypatch):
    calls = []
    real = loop_mod.render_shadow_map

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(loop_mod, "render_shadow_map", counted)
    return calls


def test_loop_shadow_table_cache_steady_state(stage, monkeypatch):
    """Frame 0 renders with the all-lit table; from frame 1 on the loop
    renders with the cached table, equal to a fresh-shadow frame; the
    standalone shadow pass runs exactly once."""
    calls = _count_shadow_passes(monkeypatch)
    scene = stage
    cfg = small(width=96, height=64, shadow_dim=256)
    assert cfg.cache_shadow_map and cfg.mode == port.RenderMode.LIT_SHADOW
    sink = Capture()
    run_loop(scene, [Events()] * 4, config=cfg, sink=sink)
    assert len(sink.frames) == 4 and len(calls) == 1
    state = port.frame_state(scene, port.default_camera(device="cpu"),
                             port.default_lights(device="cpu"))
    ref8 = render_frame(scene, state, cfg.with_(
        cache_shadow_map=False, output_u8=True)).image.numpy()
    for f in sink.frames[1:]:
        np.testing.assert_array_equal(f, ref8)
    # frame 0 is never darker than the shadowed frame, and brighter where
    # the cube's shadow falls
    assert (sink.frames[0].astype(int) >= ref8.astype(int) - 1).all()
    assert (sink.frames[0].astype(int) > ref8.astype(int) + 8).mean() > 0.01
    assert ref8.std() > 20


def test_loop_shadow_schedule_follows_the_sun(scene, monkeypatch):
    """While the sun rotates the stale table is reused; one pass in the
    first frame that finds the sun where the frame before left it; a
    fresh-per-frame loop hands the frame no table."""
    calls = _count_shadow_passes(monkeypatch)
    seen = []
    real = loop_mod.render_frame

    def spy(*a, **k):
        seen.append((len(calls), k["shadow_table"]))
        return real(*a, **k)

    monkeypatch.setattr(loop_mod, "render_frame", spy)
    held = Events(held=frozenset(["r"]))
    events = [Events(), Events(), held, held, held, Events(), Events(),
              Events(pressed=frozenset(["3"])), Events(), Events()]
    cfg = small(width=32, height=24)
    run_loop(scene, events, config=cfg, sink_kind="null")
    #        f0 f1 r  r  r  f5 f6 "3" f8 f9
    assert [n for n, _ in seen] == [0, 1, 1, 1, 1, 2, 2, 2, 3, 3]
    tables = [id(t) for _, t in seen]
    assert tables[1] == tables[2] == tables[4] != tables[5]
    assert tables[5] == tables[6] == tables[7] != tables[8] == tables[9]
    assert tables[0] != tables[1]                       # the all-lit table

    seen.clear()
    run_loop(scene, [Events()] * 3, sink_kind="null",
             config=cfg.with_(cache_shadow_map=False))
    assert len(calls) == 3 and [t for _, t in seen] == [None] * 3


def test_file_drop_appends_model(tmp_path, monkeypatch):
    objpath = tmp_path / "extra.obj"
    objpath.write_text(make_cube_obj(10.0))
    b = SceneBuilder()
    b.add_model(obj_mod.parse_obj(make_cube_obj(),
                                  mtl_loader=lambda p: None), ".")
    calls = _count_shadow_passes(monkeypatch)
    tris = []
    real = loop_mod.render_frame
    monkeypatch.setattr(loop_mod, "render_frame", lambda s, *a, **k: (
        tris.append(int(s.tri_valid.sum())), real(s, *a, **k))[1])
    events = [Events(), Events(), Events(dropped_file=str(objpath)),
              Events(), Events(dropped_file=str(tmp_path / "absent.obj")),
              Events()]
    stats = run_loop(b.build("cpu"), events, sink_kind="null", builder=b,
                     config=small(width=32, height=24))
    assert stats["frames"] == 6
    assert tris == [12, 12, 24, 24, 24, 24]
    assert len(calls) == 2           # the drop discards the cached table
    assert b.build("cpu").object_model.shape[0] == 2


def test_resize_event_changes_output_size(scene):
    sink = Capture()
    run_loop(scene, [Events(), Events(resize=(48, 32)), Events(),
                     Events(resize=(0, 10))], sink=sink,
             config=small(width=32, height=24, mode=port.RenderMode.LIT))
    assert [f.shape for f in sink.frames] \
        == [(24, 32, 3), (32, 48, 3), (32, 48, 3), (32, 48, 3)]


def test_loop_resize_bucketing_keeps_one_render_size(scene, monkeypatch):
    """Several view sizes inside one ladder bucket render into one padded
    target, each presented frame cropped to its exact view, and the crop
    equals a frame rendered at the view's own size."""
    sizes = []
    real = loop_mod.render_frame
    monkeypatch.setattr(loop_mod, "render_frame", lambda s, st, c, **k: (
        sizes.append(((c.width, c.height), k["view_wh"])),
        real(s, st, c, **k))[1])
    sink = Capture()
    cfg = small(width=64, height=48, mode=port.RenderMode.LIT)
    events = [Events(), Events(resize=(100, 70)), Events(resize=(120, 90)),
              Events(resize=(200, 150))]
    stats = run_loop(scene, events, config=cfg, sink=sink)
    assert stats["frames"] == 4
    assert stats["view_size"] == (200, 150)
    assert stats["render_size"] == (256, 256)
    assert [f.shape for f in sink.frames] \
        == [(48, 64, 3), (70, 100, 3), (90, 120, 3), (150, 200, 3)]
    assert sizes == [((64, 48), None), ((256, 256), (100, 70)),
                     ((256, 256), (120, 90)), ((256, 256), (200, 150))]
    state = port.frame_state(scene, port.default_camera(device="cpu"),
                             port.default_lights(device="cpu"))
    exact = render_frame(scene, state, cfg.with_(
        width=100, height=70, output_u8=True)).image.numpy()
    diff = np.abs(sink.frames[1].astype(int) - exact.astype(int))
    assert diff.max() <= 1 and exact.std() > 5


def test_loop_self_heals_after_frame_failure(scene, monkeypatch):
    real = loop_mod.render_frame
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected device loss")
        return real(*a, **k)

    monkeypatch.setattr(loop_mod, "render_frame", flaky)
    sink = Capture()
    stats = run_loop(scene, [Events()] * 4, sink=sink, config=small(
        width=48, height=32, mode=port.RenderMode.LIT))
    assert stats["healed"] == 1
    assert stats["frames"] == 3  # the failed frame is dropped, not fatal
    assert len(sink.frames) == 2  # ... and so is the present pending then


def test_loop_gives_up_after_persistent_failure(scene, monkeypatch):
    def dead(*a, **k):
        raise RuntimeError("injected permanent loss")

    monkeypatch.setattr(loop_mod, "render_frame", dead)
    assert loop_mod._MAX_HEAL_STREAK == ref_loop._MAX_HEAL_STREAK
    with pytest.raises(RuntimeError, match="permanent loss"):
        run_loop(scene, [Events()] * 10, sink_kind="null", config=small(
            width=48, height=32, mode=port.RenderMode.LIT))


def test_present_preview_native_to_scaling_sink(scene):
    calls = []

    class Scaling:
        scales_preview = True

        def present(self, f, view=None):
            calls.append((f.shape, view))

        def close(self):
            pass

    cfg = small(width=64, height=48, mode=port.RenderMode.LIT,
                present_scale=2)
    stats = run_loop(scene, [Events()] * 2, config=cfg, sink=Scaling())
    assert stats["frames"] == 2
    assert calls == [((24, 32, 3), (64, 48))] * 2
    legacy = Capture()
    run_loop(scene, [Events()] * 2, config=cfg, sink=legacy)
    assert [f.shape for f in legacy.frames] == [(48, 64, 3)] * 2


def test_loop_warns_of_binning_overflow(stage, capsys):
    """A per-tile cap of 0 chunks drops every bin entry; the loop says so
    once (the count comes to the host with the presented frame)."""
    cfg = small(width=32, height=24, mode=port.RenderMode.LIT,
                max_chunks_per_tile=0)
    run_loop(stage, [Events()] * 3, config=cfg, sink_kind="null")
    err = capsys.readouterr().err
    assert err.count("raster binning dropped") == 1


def test_loop_hdr_and_point_lights(scene):
    sink = Capture()
    stats = run_loop(scene, [Events()] * 2, sink=sink, point_lights=4,
                     config=small(width=32, height=24, hdr=True))
    assert stats["frames"] == 2 and sink.frames[0].dtype == np.uint8
    assert sink.frames[1].std() > 1.0


def test_loop_frames_match_reference_loop(stage):
    """The same events through the JAX loop and the port's loop (a static
    camera: the loops integrate wall-clock time): every presented frame by
    the golden criterion."""
    events = [Events(), Events(), Events(pressed=frozenset(["3", "r"]),
                                         held=frozenset(["r"])),
              Events(), Events(), Events(pressed=frozenset(["tab"]))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_native, "compute_tbn", lambda *a: None)
        mp.setattr(ref_native, "morton_order", lambda *a: None)
        ref_scene = build_stage(ref_obj, ref_loader.SceneBuilder())
    ref_sink, sink = Capture(), Capture()
    ref_stats = ref_loop.run_loop(
        ref_scene, events, sink=ref_sink,
        config=kani.RenderConfig(width=96, height=64, shadow_dim=256))
    stats = run_loop(stage, events, sink=sink,
                     config=small(width=96, height=64, shadow_dim=256))
    for k in ("frames", "mode", "present_mode", "picked", "healed",
              "view_size", "render_size"):
        assert stats[k] == ref_stats[k], k
    assert stats["mode"] == "WIREFRAME" and len(sink.frames) == 6
    for i, (a, b) in enumerate(zip(sink.frames, ref_sink.frames)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        diff = np.abs(a.astype(int) - b.astype(int))
        print(f"frame {i}: >8 levels {(diff > 8).mean():.5f}, mean "
              f"{diff.mean():.4f}")
        assert (diff > 8).mean() < 0.01 and diff.mean() < 1.5, i
        assert a.std() > 20
