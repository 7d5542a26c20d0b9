"""Host render loop — the app layer (reference ``run()``,
src/lib.rs:2054-2168; counterpart of ``kanirenderer_tpu/runtime/loop.py``).

* an input source yields per-frame ``Events`` (key presses/holds, mouse
  deltas): an interactive backend wraps a real window, scripted sources
  drive demos, benchmarks and tests;
* the controllers (runtime/controllers.py) integrate camera and light state
  on the host;
* hotkeys replicate the reference bindings: Tab cycles render modes
  (src/lib.rs:1221-1229), Key1 toggles the debug texture
  (src/lib.rs:1282-1327), Key2/Key3 move the sun distance, R/T/Y rotate
  the sun (src/lib.rs:1329-1355), F1 cycles present modes
  (src/lib.rs:1248-1280 — here: frame pacing), F11 fullscreen (window
  sinks only);
* each frame calls ``render_frame`` and presents through a display sink.

What the loop keeps off the device's critical path:

* the pose, the lights and the frame-time ring live on the host; each
  frame packs them with the two uniform matrices into one pinned buffer
  and uploads it in one asynchronous copy (``_StateUploader``), so the
  frame never reads its own state back;
* the frame is presented one iteration late (``_Presenter``): its surface
  and its overflow count are copied to pinned host memory on a side stream
  behind an event, and the host waits on that event only after it has
  queued the next frame.  The loop never synchronises the whole device;
* with ``cache_shadow_map`` the PCF table of a forward LIT_SHADOW frame is
  built on the device once per sun move and kept there.

While a profiler runs (``--profile``), each iteration records a
``kani.frame`` span, the cached table's shadow pass ``kani.shadow``, the
present ``kani.present`` and its wait on the previous frame's copy
``kani.present.wait`` (utils/spans.py); ``render_frame`` records the
frame's stages inside them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, NamedTuple

import numpy as np
import torch

from kanirenderer_tpu_torch.core.types import (CameraState, DebugTexture,
                                               DirectionalLight, FrameState,
                                               Lights, MovableLight,
                                               RenderConfig, RenderMode,
                                               Scene, default_lights,
                                               spawn_point_lights)
from kanirenderer_tpu_torch.io import obj as obj_mod
from kanirenderer_tpu_torch.ops.sampling import build_shadow_table
from kanirenderer_tpu_torch.passes.frame import (frame_uniforms_host,
                                                 linearize_depth,
                                                 render_frame,
                                                 render_shadow_map,
                                                 view_extent)
from kanirenderer_tpu_torch.runtime import controllers
from kanirenderer_tpu_torch.runtime.display import make_sink, to_uint8
from kanirenderer_tpu_torch.runtime.frametime import FrameTimeGraph
from kanirenderer_tpu_torch.utils import log
from kanirenderer_tpu_torch.utils.spans import span


class Events(NamedTuple):
    """One frame's worth of input."""

    held: frozenset = frozenset()      # currently-held key names
    pressed: frozenset = frozenset()   # keys newly pressed this frame
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    mouse_look: bool = False           # RMB held (src/lib.rs:1365-1369)
    scroll: float = 0.0
    click_pos: tuple | None = None     # LMB depth-pick (src/lib.rs:1370-1376)
    dropped_file: str | None = None    # file drop adds a model
    #                                    (src/lib.rs:2122-2137)
    resize: tuple | None = None        # (w, h) window resize
    #                                    (State::resize, src/lib.rs:1166)
    quit: bool = False


PRESENT_MODES = ["AutoVsync", "AutoNoVsync", "Fifo", "Immediate"]

# Render-target size ladder for drag-resize.  A resize renders into the
# next ladder size ≥ the view, so the frame's buffers change shape only on
# a ladder step, while the exact view size drives projection and raster
# extent (passes/frame.render_frame view_wh) and the present path crops the
# padded output to the view: exact framing at every size in between.
_SIZE_LADDER = (256, 384, 512, 768, 1024, 1280, 1536, 1920, 2560, 3840)


def _bucket(v: int) -> int:
    for s in _SIZE_LADDER:
        if v <= s:
            return s
    return -(-int(v) // 128) * 128


# Consecutive frame-failure limit before the loop gives up (the
# reference's OutOfMemory → exit analog, src/lib.rs:2156).
_MAX_HEAL_STREAK = 3


@dataclasses.dataclass
class AppState:
    """Mutable host-side app state (≈ the non-GPU parts of struct State):
    the camera as a ``controllers.HostCamera``, the lights as ``Lights`` of
    float32 numpy values."""

    config: RenderConfig
    camera: controllers.HostCamera
    lights: Lights
    present_mode: int = 0
    fullscreen: bool = False

    def cycle_mode(self):
        self.config = self.config.with_(mode=self.config.mode.next())

    def toggle_debug_texture(self):
        nxt = DebugTexture((int(self.config.debug_texture) + 1) % 2)
        self.config = self.config.with_(debug_texture=nxt)


def _camera_inputs(ev: Events) -> controllers.CameraInputs:
    h = ev.held
    return controllers.CameraInputs(
        forward=1.0 if ("w" in h or "up" in h) else 0.0,
        backward=1.0 if ("s" in h or "down" in h) else 0.0,
        left=1.0 if ("a" in h or "left" in h) else 0.0,
        right=1.0 if ("d" in h or "right" in h) else 0.0,
        up=1.0 if "space" in h else 0.0,
        down=1.0 if "lshift" in h else 0.0,
        rotate_dx=ev.mouse_dx if ev.mouse_look else 0.0,
        rotate_dy=ev.mouse_dy if ev.mouse_look else 0.0,
        scroll=ev.scroll * -100.0,
    )


def _light_inputs(ev: Events) -> controllers.LightInputs:
    h, p = ev.held, ev.pressed
    return controllers.LightInputs(
        forward=1.0 if "i" in h else 0.0,
        backward=1.0 if "k" in h else 0.0,
        left=1.0 if "j" in h else 0.0,
        right=1.0 if "l" in h else 0.0,
        up=1.0 if "u" in h else 0.0,
        down=1.0 if "o" in h else 0.0,
        d_range=(1.0 if "=" in p else 0.0) - (1.0 if "-" in p else 0.0),
        d_color=(1.0 if "]" in p else 0.0) - (1.0 if "[" in p else 0.0),
    )


def _host_start_state():
    """The initial camera (reference src/lib.rs:382) and light rig
    (src/lib.rs:431-514) as host float32 values."""
    camera = controllers.HostCamera(
        position=np.array([0.0, 5.0, 10.0], np.float32),
        yaw=np.deg2rad(np.float32(-90.0)),
        pitch=np.deg2rad(np.float32(-20.0)))
    rig = default_lights(device="cpu")
    movable = MovableLight(*(t.numpy() for t in rig.movable))
    directional = DirectionalLight(*(t.numpy() for t in rig.directional))
    return camera, movable, directional


class _StateUploader:
    """The frame's dynamic state, from host values to the device in one
    copy: both uniform matrices, the camera, the movable light, the sun
    and the frame-time ring, packed into one float32 vector.  On a CUDA
    device the vector goes through one of two pinned buffers with an
    asynchronous copy; a buffer is rewritten only after the event behind
    its last copy has passed."""

    _N = 54 + 256

    def __init__(self, device: torch.device):
        self.device = device
        self.turn = 0
        self.ring = []
        if device.type == "cuda":
            self.ring = [(torch.empty(self._N, dtype=torch.float32)
                          .pin_memory(), torch.cuda.Event())
                         for _ in range(2)]

    def upload(self, uniforms: torch.Tensor, cam: controllers.HostCamera,
               movable: MovableLight, sun: DirectionalLight, points,
               frame_times: np.ndarray, scene: Scene):
        """→ (FrameState on the device, (view_proj, light_vp))."""
        parts = [uniforms.numpy().reshape(-1), cam.position, [cam.yaw],
                 [cam.pitch], movable.position, movable.color,
                 [movable.range], [movable.yaw], sun.color, sun.direction,
                 [sun.distance], [sun.intensity], [sun.shadow_scene_size],
                 frame_times]
        host = np.concatenate([np.asarray(p, np.float32).reshape(-1)
                               for p in parts])
        if self.ring:
            pinned, event = self.ring[self.turn]
            self.turn ^= 1
            event.synchronize()
            pinned.numpy()[:] = host
            v = pinned.to(self.device, non_blocking=True)
            event.record()
        else:
            v = torch.from_numpy(host)
        state = FrameState(
            camera=CameraState(position=v[32:35], yaw=v[35], pitch=v[36]),
            lights=Lights(
                movable=MovableLight(position=v[37:40], color=v[40:43],
                                     range=v[43], yaw=v[44]),
                points=points,
                directional=DirectionalLight(
                    color=v[45:48], direction=v[48:51], distance=v[51],
                    intensity=v[52], shadow_scene_size=v[53])),
            object_model=scene.object_model,
            object_normal=scene.object_normal,
            frame_times_ms=v[54:])
        return state, (v[0:16].reshape(4, 4), v[16:32].reshape(4, 4))


class _Presenter:
    """Double-buffered presents, swapchain style: the frame submitted on
    iteration N is handed to the sink on iteration N + 1, so its copy to
    the host overlaps the next frame's work on the device.

    On a CUDA device ``submit`` copies the surface and the overflow count
    into pinned host buffers on a side stream, after an event that marks
    the end of the frame's work, and records a second event behind the
    copies; ``collect`` waits on that event alone.  The two pinned
    surfaces alternate, so a sink that keeps a frame beyond the next
    present copies it.  On the CPU the same calls pass the tensors along.
    """

    def __init__(self, device: torch.device, sink):
        self.device = device
        self.sink = sink
        self.sink_scales = bool(getattr(sink, "scales_preview", False))
        self.pending = None
        self.turn = 0
        self.slots = [None, None]
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def _slot(self, image: torch.Tensor):
        slot = self.slots[self.turn]
        if slot is None or slot[0].shape != image.shape \
                or slot[0].dtype != image.dtype:
            slot = (torch.empty(image.shape, dtype=image.dtype).pin_memory(),
                    torch.empty((), dtype=torch.int32).pin_memory())
            self.slots[self.turn] = slot
        self.turn ^= 1
        return slot

    def submit(self, out, view, scale) -> None:
        if self.stream is None:
            self.pending = (out.image, out.raster_overflow, None, view, scale)
            return
        host_image, host_overflow = self._slot(out.image)
        done = torch.cuda.Event()
        done.record()
        self.stream.wait_event(done)
        with torch.cuda.stream(self.stream):
            host_image.copy_(out.image, non_blocking=True)
            host_overflow.copy_(out.raster_overflow, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        out.image.record_stream(self.stream)
        out.raster_overflow.record_stream(self.stream)
        self.pending = (host_image, host_overflow, copied, view, scale)

    def drop(self) -> None:
        self.pending = None

    def collect(self) -> int | None:
        """Hand the pending frame to the sink; returns its overflow count,
        or None when nothing is pending."""
        if self.pending is None:
            return None
        image, overflow, copied, view, scale = self.pending
        self.pending = None
        if copied is not None:
            with span("kani.present.wait"):
                copied.synchronize()
        img = to_uint8(image)
        if scale > 1:
            if self.sink_scales:
                # Crop the preview to the view's footprint; the sink
                # resizes to the exact view size.
                pv = (-(-view[0] // scale), -(-view[1] // scale))
                if (img.shape[1], img.shape[0]) != pv:
                    img = img[:pv[1], :pv[0]]
                self.sink.present(img, view=view)
                return int(overflow)
            img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
        if (img.shape[1], img.shape[0]) != view:
            img = img[:view[1], :view[0]]
        self.sink.present(img)
        return int(overflow)


def run_loop(scene: Scene, events: Iterable[Events],
             config: RenderConfig | None = None,
             sink_kind: str = "null", sink_path: str | None = None,
             max_frames: int | None = None,
             verbose: bool = False, builder=None,
             file_type: str = "opengl", sink=None,
             point_lights: int = 1, fixed_dt: float | None = None) -> dict:
    """Drive frames from an event stream on the scene's device.  Returns
    run statistics.

    ``builder``: the SceneBuilder that produced ``scene`` — required to
    honour file-drop events (the scene is rebuilt with the new model
    appended, like the reference's drop handler, src/lib.rs:2122-2137).

    ``sink``: an already-constructed sink (e.g. an InteractiveWindow that
    is also the event source); overrides ``sink_kind``.

    ``fixed_dt``: the seconds each frame advances the camera and light
    controllers by, instead of the wall clock's; the same events then give
    the same frames in every run.  The frame-time statistics keep the
    wall clock.

    Shadow cache (``cache_shadow_map``, forward LIT_SHADOW): the map
    depends on the sun and the geometry, not on the camera, so the loop
    keeps the PCF table (ops/sampling.build_shadow_table) on the device
    and hands it to ``render_frame``, which then skips both the shadow
    raster and the table build.  Frame 0 renders with an all-lit table;
    the standalone shadow pass runs once the sun has been the same for two
    frames, exactly once per sun move; while the sun rotates the stale
    table is reused; a file drop discards it.  The cache key comes from
    the host copy of the sun.  ``cache_shadow_map=False`` renders a fresh
    map in every frame, as the reference does (src/lib.rs:1721).

    Recovery (the reference's SurfaceError::Lost → resize, OutOfMemory →
    exit, src/lib.rs:2153-2157): a frame that raises is dropped, the cached
    table, the pending present and the allocator's cache are discarded,
    and the loop goes on; after ``_MAX_HEAL_STREAK`` failures in a row it
    re-raises.  On a CUDA device this recovers what leaves the context
    usable — an out-of-memory error, a rejected launch, an error raised by
    host code — and then the scene is packed and uploaded anew from the
    ``builder``'s host arrays, because buffers read back after a fault
    cannot be trusted; without one the error is re-raised at once.
    A fault that poisons the context (an illegal address) makes every
    later call fail too, so the streak limit ends the run.  A CPU scene's
    tensors are not at risk and are kept.
    """
    cfg = config or RenderConfig()
    # Present in the real surface format — uint8 for LDR (Rgba8UnormSrgb),
    # float16 for HDR (Rgba16Float; src/lib.rs:321-329) — so the copy to
    # the host is small and LDR needs no host convert.
    cfg = cfg.with_(output_u8=True)
    dev = scene.device
    camera, movable, directional = _host_start_state()
    host_points = spawn_point_lights(point_lights, device="cpu") \
        if point_lights > 1 else default_lights(device="cpu").points
    points = type(host_points)(*(t.to(dev) for t in host_points))
    app = AppState(config=cfg, camera=camera,
                   lights=Lights(movable, type(host_points)(
                       *(t.numpy() for t in host_points)), directional))
    if sink is None:
        sink = make_sink(sink_kind, sink_path, cfg.width, cfg.height)
    presenter = _Presenter(dev, sink)
    uploader = _StateUploader(dev)
    graph = FrameTimeGraph()
    frames = 0
    last = time.perf_counter()
    picked: list = []
    shadow_table = None
    shadow_key = None
    shadow_prev_key = None
    shadow_ones = None
    warned_overflow = 0
    # Exact view size; differs from the (padded) config dims after a
    # resize — see _SIZE_LADDER.
    view_size = (cfg.width, cfg.height)
    healed = 0
    heal_streak = 0

    def warn_overflow(ov):
        nonlocal warned_overflow
        if ov and ov != warned_overflow:
            log.warn("raster binning dropped %d chunk entries this frame — "
                     "raise max_chunks_per_tile / shadow_chunks_per_tile "
                     "(RenderConfig)", ov)
            warned_overflow = ov

    for ev in events:
        if ev.quit or (max_frames is not None and frames >= max_frames):
            break
        with span("kani.frame"):
            now = time.perf_counter()
            wall, last = now - last, now
            dt = wall if fixed_dt is None else fixed_dt

            # --- file drop: append a model and rebuild the packed scene ---
            if ev.dropped_file is not None and builder is not None:
                try:
                    builder.add_model(
                        obj_mod.load_obj(ev.dropped_file),
                        os.path.dirname(os.path.abspath(ev.dropped_file)),
                        file_type=file_type)
                    scene = builder.build(dev)
                    shadow_table = None  # geometry changed
                    shadow_key = None
                    if verbose:
                        log.info("added model %s", ev.dropped_file)
                except Exception as e:  # missing/corrupt file: keep rendering
                    log.warn("file drop failed for %r: %s", ev.dropped_file, e)

            # --- window resize (State::resize, src/lib.rs:1166) ---
            if ev.resize is not None:
                w, h = ev.resize
                if w > 0 and h > 0:
                    view_size = (int(w), int(h))
                    bw, bh = _bucket(int(w)), _bucket(int(h))
                    if (bw, bh) != (app.config.width, app.config.height):
                        app.config = app.config.with_(width=bw, height=bh)

            # --- hotkeys (State::input, src/lib.rs:1208-1379) ---
            p = ev.pressed
            if "tab" in p:
                app.cycle_mode()
            if "f1" in p:
                # Present-mode cycle (reference src/lib.rs:1248-1280).  The
                # headless analog of vsync is frame pacing: AutoVsync/Fifo cap
                # the loop at 60 Hz (see the sleep below), AutoNoVsync/
                # Immediate free-run.
                app.present_mode = (app.present_mode + 1) % len(PRESENT_MODES)
                log.info("present mode: %s", PRESENT_MODES[app.present_mode])
            if "f11" in p:
                # Fullscreen toggle with a real effect on window sinks
                # (reference src/lib.rs:1231-1247).
                app.fullscreen = not app.fullscreen
                if hasattr(sink, "set_fullscreen"):
                    sink.set_fullscreen(app.fullscreen)
            if "1" in p:
                app.toggle_debug_texture()
            d = app.lights.directional
            if "2" in p:
                d = controllers.step_directional_distance_host(d, -10.0)
            if "3" in p:
                d = controllers.step_directional_distance_host(d, +10.0)
            if "r" in ev.held:
                d = controllers.rotate_directional_light_host(d, 4.0, 0.0, 0.0)
            if "t" in ev.held:
                d = controllers.rotate_directional_light_host(d, 0.0, 4.0, 0.0)
            if "y" in ev.held:
                d = controllers.rotate_directional_light_host(d, 0.0, 0.0, 4.0)

            # --- controller integration (State::update), on the host ---
            app.camera = controllers.update_camera_host(
                app.camera, _camera_inputs(ev), dt)
            app.lights = app.lights._replace(
                movable=controllers.update_movable_light_host(
                    app.lights.movable, _light_inputs(ev), dt),
                directional=d)

            # --- render ---
            graph.update(wall)
            vwh = None
            if view_size != (app.config.width, app.config.height):
                vwh = view_size
            cam = app.camera
            try:
                state, uniforms = uploader.upload(
                    frame_uniforms_host(
                        cam.position, cam.yaw, cam.pitch, d.direction,
                        d.distance, d.shadow_scene_size, app.config,
                        view_extent(app.config, vwh)[2]),
                    cam, app.lights.movable, d, points, graph.buffer, scene)
                # The prebuilt-table path applies to forward LIT_SHADOW
                # (DEBUG's overlay and the deferred shader take the raw map).
                tbl = None
                if (app.config.mode == RenderMode.LIT_SHADOW
                        and app.config.cache_shadow_map
                        and not app.config.deferred):
                    D = app.config.shadow_dim
                    key = (D, tuple(np.asarray(d.direction).tolist()),
                           float(d.distance), float(d.shadow_scene_size))
                    if shadow_table is not None and key == shadow_key:
                        tbl = shadow_table          # steady state
                    elif frames > 0 and key == shadow_prev_key:
                        # The sun has settled: one shadow pass, one table.
                        with span("kani.shadow"):
                            shadow_table = build_shadow_table(
                                render_shadow_map(scene, state, app.config,
                                                  light_vp=uniforms[1]))
                        shadow_key = key
                        tbl = shadow_table
                    elif shadow_table is not None:
                        tbl = shadow_table          # stale while it rotates
                    else:
                        if shadow_ones is None \
                                or shadow_ones.shape[0] != (D // 8) ** 2:
                            shadow_ones = build_shadow_table(torch.ones(
                                (D, D), dtype=torch.float32, device=dev))
                        tbl = shadow_ones
                    shadow_prev_key = key
                out = render_frame(scene, state, app.config, shadow_table=tbl,
                                   view_wh=vwh, uniforms=uniforms)
                # Present the previous frame: its copy has had this frame's
                # host work to finish in.  Overruns of the binning caps must
                # not drop geometry silently; the count came with the frame,
                # and is looked at every 8th frame.
                with span("kani.present"):
                    ov = presenter.collect()
                    if ov is not None and frames % 8 == 1:
                        warn_overflow(ov)
                    presenter.submit(out, view_size, app.config.present_scale)
                heal_streak = 0
            except Exception as e:
                heal_streak += 1
                healed += 1
                if heal_streak > _MAX_HEAL_STREAK:
                    raise
                log.warn("frame failed (%s: %s) — rebuilding device state "
                         "(attempt %d)", type(e).__name__, e, heal_streak)
                shadow_table = shadow_key = shadow_ones = None
                presenter.drop()
                if dev.type == "cuda":
                    if builder is None:
                        raise
                    torch.cuda.empty_cache()
                    scene = builder.build(dev)
                continue
            frames += 1

            # --- frame pacing: the vsync-like present modes cap at 60 Hz ---
            if PRESENT_MODES[app.present_mode] in ("AutoVsync", "Fifo"):
                budget = 1.0 / 60.0 - (time.perf_counter() - now)
                if budget > 0:
                    time.sleep(budget)

            # --- depth picking (src/lib.rs:1923-2039): one value indexed on
            # the device, fetched with its linearization in one copy ---
            if ev.click_pos is not None:
                x, y = ev.click_pos
                x = int(np.clip(x, 0, view_size[0] - 1))
                y = int(np.clip(y, 0, view_size[1] - 1))
                raw = out.depth[y, x]
                depth, lin = torch.stack([raw, linearize_depth(
                    raw, app.config.znear, app.config.zfar)]).tolist()
                picked.append((x, y, depth, lin))
                if verbose:
                    print(f"depth at ({x},{y}): raw={depth:.6f} "
                          f"linear={lin:.2f}")

            if verbose and frames % 60 == 0:
                print(f"frame {frames}: {graph.mean_ms:.2f} ms "
                      f"({graph.fps:.1f} FPS) mode={app.config.mode.name}")

    warn_overflow(presenter.collect())  # flush the last pending frame
    sink.close()
    return {
        "frames": frames,
        "mean_ms": graph.mean_ms,
        "fps": graph.fps,
        "mode": app.config.mode.name,
        "present_mode": PRESENT_MODES[app.present_mode],
        "picked": picked,
        "healed": healed,
        "view_size": view_size,
        "render_size": (app.config.width, app.config.height),
    }


def scripted_flythrough(n_frames: int, look: bool = True) -> Iterable[Events]:
    """A deterministic W-forward + mouse-look event stream for demos and
    benchmarks."""
    for _ in range(n_frames):
        yield Events(held=frozenset(["w"]),
                     mouse_dx=2.0 if look else 0.0,
                     mouse_dy=0.3 if look else 0.0,
                     mouse_look=look)
