"""The forward shading and encode kernel (csrc/shade_forward.cu): wrapper,
the cases it covers, and its plain version.

``shade_surface`` computes what ``passes/frame.band_surface(band_shade(...))``
computes for a band in LIT and LIT_SHADOW, in one launch: the materials
from the combined table, the PCF shadow, Blinn-Phong over the movable
light, the sun and the point-light array, Reinhard or ACES, the clear
colour where no triangle covers, the sRGB encode and the u8 store (the
clamp and the float16 store with ``hdr``).  It counts its launches in
``raster_cuda.launch_counts["shade_forward"]``, and loads from the kernel
library that ``raster_cuda`` builds from every ``csrc/*.cu``.

``covers`` says which frames take it: a CUDA device, LIT or LIT_SHADOW,
forward (not deferred), ``present_scale`` 1, the ``output_u8`` surface and
a scene with the combined texture table.  Every other case (UNLIT,
WIREFRAME, DEBUG with its overlays, deferred, a downscaled or float32
surface, the separate tables of a deeper normal map, the CPU) keeps the
plain chain, which stays the reference: ``shade_surface_plain``.

The kernel sums the texture's and the PCF's non-zero lane terms only, in
another order than the plain path's reductions, so the two agree to the
last place of those sums: on the u8 surface within one level.
"""

from __future__ import annotations

import ctypes

import torch

from kanirenderer_tpu_torch.core.types import (FrameState, RenderConfig,
                                               RenderMode, Scene)
from kanirenderer_tpu_torch.ops import raster_cuda
from kanirenderer_tpu_torch.ops.interpolate import PixelBuffer
from kanirenderer_tpu_torch.ops.vertex import USED

Tensor = torch.Tensor

_fn = None


def covers(cfg: RenderConfig, scene: Scene, device) -> bool:
    """Whether a frame of ``cfg`` on ``scene`` and ``device`` shades
    through the kernel."""
    return (torch.device(device).type == "cuda"
            and cfg.mode in (RenderMode.LIT, RenderMode.LIT_SHADOW)
            and not cfg.deferred and cfg.present_scale == 1
            and cfg.output_u8 and scene.tex_combined.shape[0] > 0)


def _kernel():
    global _fn
    if _fn is None:
        fn = raster_cuda.load_kernels().kani_shade_forward
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 8 + [i32] + [ptr] * 11 + [i32] + [f32] * 3 \
            + [i32] * 3 + [ptr] * 2
        fn.restype = i32
        _fn = fn
    return _fn


def _f32(t: Tensor, name: str, numel: int, device) -> Tensor:
    if t.device != device or t.dtype != torch.float32 or t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} {t.dtype} values on "
                         f"{t.device}, expected {numel} float32 on {device}")
    return t.contiguous()


def shade_surface(scene: Scene, state: FrameState, cfg: RenderConfig,
                  pix: PixelBuffer, table: Tensor | None,
                  light_vp: Tensor) -> Tensor:
    """The band's (rows, W, 3) surface, u8 (float16 with ``cfg.hdr``), of
    a frame that ``covers`` takes: ``band_shade`` then ``band_surface``
    in one launch.  ``table``: the PCF table in LIT_SHADOW, None in LIT."""
    dev = pix.mask.device
    if not covers(cfg, scene, dev):
        raise ValueError("the shade kernel does not cover this frame")
    if (table is None) != (cfg.mode == RenderMode.LIT):
        raise ValueError("LIT_SHADOW shades with a PCF table, LIT without")
    rows, W = pix.mask.shape
    planes = [pix.varyings, pix.tex_w, pix.tex_h, pix.blk_base, pix.blk_w,
              pix.mask]
    for name, t, shape, dtype in zip(
            ("varyings", "tex_w", "tex_h", "blk_base", "blk_w", "mask"),
            planes, [(USED, rows, W)] + [(rows, W)] * 5,
            [torch.float32] + [torch.int32] * 4 + [torch.bool]):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {shape} {dtype} on {dev}")
    planes = [t.contiguous() for t in planes]
    tex = scene.tex_combined
    if tex.device != dev or tex.dtype != torch.uint8 or tex.dim() != 2 \
            or tex.shape[1] != 128 or not tex.is_contiguous():
        raise ValueError("tex_combined must be a contiguous (R, 128) u8 "
                         f"table on {dev}")
    D = cfg.shadow_dim
    if table is not None:
        raster_cuda._check(table, "table", ((D // 8) ** 2, 128),
                           torch.float32, dev)
    lights = state.lights
    m, d, p = lights.movable, lights.directional, lights.points
    P = p.range.numel()
    sun_dir = _f32(d.direction, "sun direction", 3, dev)
    small = [_f32(light_vp, "light_vp", 16, dev),
             _f32(state.camera.position, "camera position", 3, dev),
             _f32(m.position, "movable position", 3, dev),
             _f32(m.color, "movable colour", 3, dev),
             _f32(m.range, "movable range", 1, dev), sun_dir,
             torch.linalg.vector_norm(sun_dir),
             _f32(d.color, "sun colour", 3, dev),
             _f32(p.position, "point positions", 3 * P, dev),
             _f32(p.color, "point colours", 3 * P, dev),
             _f32(p.range, "point ranges", P, dev)]
    out = torch.empty((rows, W, 3), device=dev,
                      dtype=torch.float16 if cfg.hdr else torch.uint8)
    err = _kernel()(
        *(t.data_ptr() for t in planes), tex.data_ptr(),
        0 if table is None else table.data_ptr(), D,
        *(t.data_ptr() for t in small), P, *cfg.clear_color, int(cfg.hdr),
        rows, W, out.data_ptr(), raster_cuda._stream())
    raster_cuda.launch_counts["shade_forward"] += 1
    if err:
        raise RuntimeError(f"shade_forward launch failed: CUDA error {err}")
    return out


def shade_surface_plain(scene: Scene, state: FrameState, cfg: RenderConfig,
                        pix: PixelBuffer, table: Tensor | None,
                        light_vp: Tensor) -> Tensor:
    """The plain chain the kernel replaces, on any device:
    ``passes/frame.band_surface(band_shade(...))`` of a LIT or LIT_SHADOW
    band (no overlays, so neither the depth nor the map is read)."""
    from kanirenderer_tpu_torch.passes.frame import band_shade, band_surface
    return band_surface(band_shade(scene, state, cfg, pix, table, light_vp),
                        state, cfg, pix.z, None)
