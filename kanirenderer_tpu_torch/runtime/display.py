"""Frame presentation: PNG/GIF writers and an optional live window (own
copy of ``kanirenderer_tpu/runtime/display.py``).

The reference presents to a winit swapchain window (src/lib.rs:2044).  A
render host is typically headless, so the primary sinks are:

* ``PngSink``  — one PNG per frame (or a single frame);
* ``GifSink``  — animated GIF capture of a fly-through;
* ``WindowSink`` — best-effort live window via tkinter when a display is
  available; degrades to PNG dumping otherwise.

All sinks take (H, W, 3) uint8 host frames (already display-encoded).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from kanirenderer_tpu_torch.io.image import write_png


def to_uint8(image) -> np.ndarray:
    """Display-encoded frame (tensor or array) → (H, W, 3) uint8 host array.

    With ``RenderConfig.output_u8`` the LDR quantization already happened
    on the device and this is just the host fetch; HDR surfaces arrive as
    f16/f32 linear values and quantize here (a real HDR swapchain would
    hand them to the display pipeline instead)."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.asarray(image)
    if img.dtype == np.uint8:
        return img
    img = img.astype(np.float32)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


class PngSink:
    def __init__(self, path: str):
        self.path = path
        self.count = 0

    def present(self, frame: np.ndarray) -> None:
        if "%" in self.path:
            path = self.path % self.count
        elif self.count == 0:
            path = self.path
        else:
            base, ext = os.path.splitext(self.path)
            path = f"{base}_{self.count:04d}{ext}"
        write_png(path, frame)
        self.count += 1

    def close(self) -> None:
        pass


class GifSink:
    """Animated GIF via PIL (falls back to per-frame PNGs without PIL)."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self.frames: list = []

    def present(self, frame: np.ndarray) -> None:
        self.frames.append(frame.copy())

    def close(self) -> None:
        if not self.frames:
            return
        try:
            from PIL import Image
            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(self.path, save_all=True, append_images=imgs[1:],
                         duration=int(1000 / self.fps), loop=0)
        except Exception:
            base, _ = os.path.splitext(self.path)
            for i, f in enumerate(self.frames):
                write_png(f"{base}_{i:04d}.png", f)


class WindowSink:
    """Best-effort interactive window (tkinter).  Headless → PNG fallback
    into the temporary directory.

    ``scales_preview``: the sink accepts the present-path preview at its
    own (device-downsampled) resolution plus the target ``view`` size and
    scales it itself with one nearest-neighbour resize.
    """

    scales_preview = True

    def __init__(self, width: int, height: int, title: str = "kanirenderer"):
        self._fallback = None
        self._tk = None
        try:
            import tkinter
            from PIL import Image, ImageTk
            root = tkinter.Tk()
            root.title(title)
            label = tkinter.Label(root)
            label.pack()
            self._tk = (tkinter, root, label, Image, ImageTk)
        except Exception:
            self._fallback = PngSink(os.path.join(
                tempfile.gettempdir(), "kanirenderer_frame_%05d.png"))

    def present(self, frame: np.ndarray, view: tuple | None = None) -> None:
        if self._fallback is not None:
            self._fallback.present(_scale_to_view(frame, view))
            return
        tkinter, root, label, Image, ImageTk = self._tk
        img = Image.fromarray(frame)
        if view is not None and (img.width, img.height) != tuple(view):
            img = img.resize(tuple(view), Image.NEAREST)
        photo = ImageTk.PhotoImage(img)
        label.configure(image=photo)
        label.image = photo
        root.update()

    def close(self) -> None:
        if self._tk is not None:
            self._tk[1].destroy()


def _scale_to_view(frame: np.ndarray, view: tuple | None) -> np.ndarray:
    """Nearest-upscale a preview frame to the view size (used by scaling
    sinks that ultimately need a full-size pixel buffer)."""
    if view is None or (frame.shape[1], frame.shape[0]) == tuple(view):
        return frame
    try:
        from PIL import Image
        return np.asarray(Image.fromarray(frame).resize(tuple(view),
                                                        Image.NEAREST))
    except Exception:
        sy = -(-view[1] // frame.shape[0])
        sx = -(-view[0] // frame.shape[1])
        return np.repeat(np.repeat(frame, sy, axis=0),
                         sx, axis=1)[:view[1], :view[0]]


class NullSink:
    """Discards frames; a scaling sink, so the loop pays no host upscale
    for it."""

    scales_preview = True

    def present(self, frame, view=None) -> None:
        pass

    def close(self) -> None:
        pass


def make_sink(kind: str, path: str | None, width: int, height: int):
    if kind == "png":
        return PngSink(path or "frame.png")
    if kind == "gif":
        return GifSink(path or "capture.gif")
    if kind == "window":
        return WindowSink(width, height)
    if kind == "null":
        return NullSink()
    raise ValueError(f"unknown sink {kind!r}")
