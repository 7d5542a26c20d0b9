"""Interactive input: a live tkinter window that is both a display sink and
an event source.

The reference's winit event routing (src/lib.rs:2091-2140) maps to:

* ``EventAccumulator`` — pure event-translation/accumulation logic (tk
  event names → the loop's ``Events`` tuple); unit-testable headlessly;
* ``InteractiveWindow`` — a tkinter window with key/mouse/scroll capture
  feeding an ``EventAccumulator``, honoring F11 fullscreen
  (src/lib.rs:1231-1247) by actually toggling the window, and presenting
  frames like ``runtime.display.WindowSink``;
* ``interactive_source`` — an ``Events`` iterator for ``run_loop``.

Mouse-look follows the reference: deltas rotate the camera only while the
right button is held (src/lib.rs:1365-1369, 2092-2102); the left button
arms depth picking (src/lib.rs:1370-1376).
"""

from __future__ import annotations

from kanirenderer_tpu_torch.runtime.loop import Events

# tk keysym (lowercased) → the loop's key names (see loop._camera_inputs /
# _light_inputs / run_loop hotkeys).
TK_KEYMAP = {
    "w": "w", "a": "a", "s": "s", "d": "d",
    "up": "up", "down": "down", "left": "left", "right": "right",
    "space": "space", "shift_l": "lshift",
    "tab": "tab", "f1": "f1", "f11": "f11",
    "1": "1", "2": "2", "3": "3",
    "r": "r", "t": "t", "y": "y",
    "i": "i", "j": "j", "k": "k", "l": "l", "u": "u", "o": "o",
    "equal": "=", "plus": "=", "minus": "-",
    "bracketleft": "[", "bracketright": "]",
    "escape": "escape",
}


class EventAccumulator:
    """Accumulates window events between frames; ``poll()`` snapshots them
    as one ``Events`` and clears the per-frame edges."""

    def __init__(self):
        self.held: set = set()
        self._pressed: set = set()
        self._was_held: set = set()
        self._dx = 0.0
        self._dy = 0.0
        self._scroll = 0.0
        self._look = False
        self._click = None
        self._resize = None
        self._drop = None
        self._quit = False
        self._last_xy = None

    # --- feed (called from UI callbacks) ---
    def key_press(self, keysym: str) -> None:
        name = TK_KEYMAP.get(keysym.lower())
        if name is None:
            return
        if name == "escape":
            self._quit = True
            return
        # X11 auto-repeat emits release+press pairs; only count a press
        # as "newly pressed" if the key wasn't held at the last poll.
        if name not in self._was_held:
            self._pressed.add(name)
        self.held.add(name)

    def key_release(self, keysym: str) -> None:
        self.held.discard(TK_KEYMAP.get(keysym.lower()))

    def mouse_move(self, x: float, y: float) -> None:
        if self._last_xy is not None:
            self._dx += x - self._last_xy[0]
            self._dy += y - self._last_xy[1]
        self._last_xy = (x, y)

    def raw_move(self, dx: float, dy: float) -> None:
        """Raw relative deltas (the pointer-warp mouse-look grab below;
        ≈ the reference's DeviceEvent::MouseMotion, src/lib.rs:2092-2102)."""
        self._dx += dx
        self._dy += dy

    def reset_pointer(self) -> None:
        """Forget the last absolute position (after a grab ends, so the
        warp-displaced pointer doesn't register as one huge delta)."""
        self._last_xy = None

    def button_press(self, num: int, x: float, y: float) -> None:
        if num == 1:
            self._click = (x, y)
        elif num == 3:
            self._look = True
        elif num == 4:   # X11 wheel up
            self._scroll += 1.0
        elif num == 5:   # X11 wheel down
            self._scroll -= 1.0

    def button_release(self, num: int) -> None:
        if num == 3:
            self._look = False

    def wheel(self, delta: float) -> None:
        self._scroll += delta / 120.0  # Windows-style wheel units

    def configure(self, width: int, height: int) -> None:
        self._resize = (width, height)

    def drop_file(self, path: str) -> None:
        self._drop = path

    def close(self) -> None:
        self._quit = True

    # --- drain ---
    def poll(self) -> Events:
        ev = Events(
            held=frozenset(self.held),
            pressed=frozenset(self._pressed),
            mouse_dx=self._dx, mouse_dy=self._dy,
            mouse_look=self._look,
            scroll=self._scroll,
            click_pos=self._click,
            dropped_file=self._drop,
            resize=self._resize,
            quit=self._quit,
        )
        self._pressed = set()
        self._was_held = set(self.held)
        self._dx = self._dy = self._scroll = 0.0
        self._click = None
        self._resize = None
        self._drop = None
        return ev


class InteractiveWindow:
    """Live tkinter window with input capture.  Raises RuntimeError when no
    display is available (callers fall back to scripted events + PNG)."""

    def __init__(self, width: int, height: int, title: str = "kanirenderer",
                 fullscreen: bool = False):
        import tkinter
        from PIL import Image, ImageTk

        self.acc = EventAccumulator()
        root = tkinter.Tk()
        root.title(title)
        root.geometry(f"{width}x{height}")
        label = tkinter.Label(root)
        label.pack(fill="both", expand=True)
        self._tk = (tkinter, root, label, Image, ImageTk)
        self._fullscreen = False

        acc = self.acc
        root.bind("<KeyPress>", lambda e: acc.key_press(e.keysym))
        root.bind("<KeyRelease>", lambda e: acc.key_release(e.keysym))

        # Mouse-look grab (reference src/lib.rs:2066-2080: cursor is
        # confined+hidden while RMB is held and look uses RAW device
        # deltas).  tk has no raw-motion API, so emulate it: while
        # grabbed, hide the cursor and warp the pointer back to the
        # window center after every motion event — each event's offset
        # from center IS the raw delta, and look continues indefinitely
        # past the window edge.  The warp itself lands exactly at center
        # (delta 0), so it self-filters.
        self._grab_center = None

        def _on_motion(e):
            if self._grab_center is not None:
                cx, cy = self._grab_center
                dx, dy = e.x - cx, e.y - cy
                if dx or dy:
                    acc.raw_move(dx, dy)
                    self._warp(cx, cy)
            else:
                acc.mouse_move(e.x, e.y)

        def _on_press(e):
            acc.button_press(e.num, e.x, e.y)
            if e.num == 3:
                self._begin_grab()

        def _on_release(e):
            acc.button_release(e.num)
            if e.num == 3:
                self._end_grab()

        root.bind("<Motion>", _on_motion)
        root.bind("<ButtonPress>", _on_press)
        root.bind("<ButtonRelease>", _on_release)
        root.bind("<MouseWheel>", lambda e: acc.wheel(e.delta))
        # Window resize → Events.resize → surface reconfigure (the
        # reference's State::resize, src/lib.rs:1166).  Only report real
        # size changes: tkinter fires <Configure> for moves too.
        self._size = (width, height)

        def _on_configure(e):
            # toplevel bindings receive every descendant's <Configure>;
            # only the window's own size changes are resizes
            if e.widget is not root:
                return
            if (e.width, e.height) != self._size and e.width > 1 \
                    and e.height > 1:
                self._size = (e.width, e.height)
                acc.configure(e.width, e.height)

        root.bind("<Configure>", _on_configure)
        root.protocol("WM_DELETE_WINDOW", acc.close)
        if fullscreen:
            self.set_fullscreen(True)

    # --- sink interface ---
    # Scaling sink (see runtime/display.WindowSink): the loop hands the
    # present-path preview at its own resolution plus the view size, and
    # one PIL nearest resize brings it to the view.
    scales_preview = True

    def present(self, frame, view: tuple | None = None) -> None:
        tkinter, root, label, Image, ImageTk = self._tk
        img = Image.fromarray(frame)
        if view is not None and (img.width, img.height) != tuple(view):
            img = img.resize(tuple(view), Image.NEAREST)
        photo = ImageTk.PhotoImage(img)
        label.configure(image=photo)
        label.image = photo
        root.update()

    def close(self) -> None:
        try:
            self._tk[1].destroy()
        except Exception:
            pass

    # --- mouse-look pointer grab (reference src/lib.rs:2066-2080) ---
    def _warp(self, x: int, y: int) -> None:
        try:
            self._tk[1].event_generate("<Motion>", warp=True, x=x, y=y)
        except Exception:
            pass  # no pointer-warp support (non-X11 tk): plain deltas

    def _begin_grab(self) -> None:
        root = self._tk[1]
        cx = max(root.winfo_width() // 2, 1)
        cy = max(root.winfo_height() // 2, 1)
        self._grab_center = (cx, cy)
        try:
            root.config(cursor="none")
        except Exception:
            pass
        self._warp(cx, cy)

    def _end_grab(self) -> None:
        self._grab_center = None
        try:
            self._tk[1].config(cursor="")
        except Exception:
            pass
        # the warp displaced the pointer; don't count it as a look delta
        self.acc.reset_pointer()

    # --- window control (F11, reference src/lib.rs:1231-1247) ---
    def set_fullscreen(self, fullscreen: bool) -> None:
        self._fullscreen = fullscreen
        try:
            self._tk[1].attributes("-fullscreen", fullscreen)
        except Exception:
            pass

    # --- event-source interface ---
    def poll(self) -> Events:
        self._tk[1].update()  # pump pending UI events into the accumulator
        return self.acc.poll()


def interactive_source(window: InteractiveWindow):
    """Yield one ``Events`` per frame from a live window, forever."""
    while True:
        yield window.poll()
