"""DEBUG-mode overlays as tensor compositing ops (PyTorch counterpart of
``debug_texture_quad`` and ``frame_time_graph`` in
``kanirenderer_tpu/passes/overlay.py``, with their row-band variants
``debug_texture_quad_band`` and ``frame_time_graph_band``, of which the
full-screen ones are the one-band case).

* Depth/shadow visualization quad — reference debug pass
  (src/lib.rs:1865-1890) + src/debug_depth.wgsl: a 0.4-scaled quad offset
  to the top-right showing the linearized scene depth or the shadow map,
  with a 1%-UV black border (src/debug_depth.wgsl:44-47).
* Frame-time graph — reference src/frametime.rs:33-60 +
  src/lib.rs:1893-1914: a 256-point red LineStrip in a 400×100 box at the
  bottom-right, vertical full scale 8.333 ms.

Both take and return a channel-last (H, W, 3) image and leave their input
unchanged.  ``linearize_depth`` is the depth linearization the quad and the
reference's depth picking share.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def linearize_depth(depth: Tensor, znear: float, zfar: float) -> Tensor:
    """znear·zfar / (zfar − depth·(zfar − znear)) (reference
    src/lib.rs:2000-2013, src/debug_depth.wgsl:37-41).  PyTorch evaluates
    ``float / tensor`` as a reciprocal times the float, which rounds twice;
    a 0-dim CPU tensor numerator divides once on any device, as JAX
    does."""
    num = torch.tensor(znear * zfar, dtype=torch.float32)
    return torch.div(num, zfar - depth * (zfar - znear))


def debug_texture_quad(image: Tensor, depth_tex: Tensor, znear: float,
                       zfar: float) -> Tensor:
    """Composite the depth-visualization quad onto ``image``: screen
    x ∈ [0.55W, 0.95W), y ∈ [0.05H, 0.45H), a bilinear sample of
    ``depth_tex`` linearized and divided by zfar (src/debug_depth.wgsl)."""
    return debug_texture_quad_band(image, 0, image.shape[0], depth_tex,
                                   znear, zfar)


def debug_texture_quad_band(image: Tensor, row0: int, full_h: int,
                            depth_tex: Tensor, znear: float,
                            zfar: float) -> Tensor:
    """``debug_texture_quad`` on the row band [row0, row0 + Hb) of a
    ``full_h``-tall screen: the band's rows of the quad, placed and
    sampled in global rows, so its pixels are the full composite's."""
    Hb, W = image.shape[0], image.shape[1]
    x0, x1 = int(0.55 * W), int(0.95 * W)
    y0, y1 = int(0.05 * full_h), int(0.45 * full_h)
    qw, qh = x1 - x0, y1 - y0
    a, b = max(y0 - row0, 0), min(y1 - row0, Hb)   # band rows in the quad
    out = image.clone()
    if a >= b:
        return out
    dev = image.device

    U = ((torch.arange(qw, dtype=torch.float32, device=dev) + 0.5)
         / qw)[None, :]
    # The quad's own row index, an exact integer in float32.
    r = torch.arange(a, b, dtype=torch.float32, device=dev) + (row0 - y0)
    Vv = ((r + 0.5) / qh)[:, None]

    # Bilinear sample of the depth texture.
    D_h, D_w = depth_tex.shape
    tx = U * D_w - 0.5
    ty = Vv * D_h - 0.5
    ix0 = torch.clamp(torch.floor(tx).to(torch.int64), 0, D_w - 1)
    iy0 = torch.clamp(torch.floor(ty).to(torch.int64), 0, D_h - 1)
    ix1 = torch.clamp(ix0 + 1, 0, D_w - 1)
    iy1 = torch.clamp(iy0 + 1, 0, D_h - 1)
    fx = torch.clamp(tx - torch.floor(tx), 0, 1)
    fy = torch.clamp(ty - torch.floor(ty), 0, 1)
    flat = depth_tex.reshape(-1)

    def g(iy, ix):
        return flat[iy * D_w + ix]                          # (rows, qw)

    d = (g(iy0, ix0) * (1 - fx) + g(iy0, ix1) * fx) * (1 - fy) \
        + (g(iy1, ix0) * (1 - fx) + g(iy1, ix1) * fx) * fy

    val = linearize_depth(d, znear, zfar) / zfar
    border = (U < 0.01) | (U > 0.99) | (Vv < 0.01) | (Vv > 0.99)
    quad = torch.where(border, 0.0, val)
    out[a:b, x0:x1, :] = quad[..., None]
    return out


def frame_time_graph(image: Tensor, frame_times_ms: Tensor) -> Tensor:
    """Composite the red frame-time LineStrip (bottom-right, 400×100 px,
    full scale 8.333 ms — reference src/frametime.rs:38-46): pixels whose
    centre lies within sqrt(0.45) px of a segment turn red.

    The distance is taken to all 255 segments at once, a (255, 250, 433)
    float32 tensor at 1920×1080 (110 MB), several alive at a time."""
    return frame_time_graph_band(image, 0, image.shape[0], frame_times_ms)


def frame_time_graph_band(image: Tensor, row0: int, full_h: int,
                          frame_times_ms: Tensor) -> Tensor:
    """``frame_time_graph`` on the row band [row0, row0 + Hb) of a
    ``full_h``-tall screen, in global rows (see
    ``debug_texture_quad_band``)."""
    Hb, W = image.shape[0], image.shape[1]
    H = full_h
    n = frame_times_ms.shape[0]
    dev = image.device
    graph_w, graph_h = 400.0, 100.0
    x_off = W - graph_w - 25.0
    y_off = 25.0  # pixels from the bottom (NDC y-up)

    # Overlay region (static): rows [H-250, H), cols [x_off-8, W)
    ry0 = max(H - 250, 0)
    rx0 = max(int(x_off) - 8, 0)
    a = min(max(ry0 - row0, 0), Hb)               # band rows in the region
    out = image.clone()
    if a >= Hb:
        return out

    sx = x_off + torch.arange(n, dtype=torch.float32, device=dev) / n \
        * graph_w
    ys_up = y_off + frame_times_ms / 8.333 * graph_h
    sy = H - ys_up  # to top-down screen rows

    py = row0 + torch.arange(a, Hb, dtype=torch.float32,
                             device=dev)[:, None] + 0.5
    px = rx0 + torch.arange(W - rx0, dtype=torch.float32,
                            device=dev)[None, :] + 0.5

    # Distance from each region pixel to each strip segment.
    ax, ay = sx[:-1], sy[:-1]
    bx, by = sx[1:], sy[1:]
    dx = (bx - ax)[:, None, None]
    dy = (by - ay)[:, None, None]
    pxa = px[None] - ax[:, None, None]
    pya = py[None] - ay[:, None, None]
    denom = torch.clamp(dx * dx + dy * dy, min=1e-12)
    t = torch.clamp((pxa * dx + pya * dy) / denom, 0.0, 1.0)
    ddx = pxa - t * dx
    ddy = pya - t * dy
    dist2 = (ddx * ddx + ddy * ddy).amin(0)
    on_line = dist2 <= 0.45

    red = torch.zeros(3, dtype=torch.float32, device=dev)
    red[0] = 1.0  # filled on the device: no host-to-device copy
    out[a:, rx0:, :] = torch.where(on_line[..., None], red,
                                   image[a:, rx0:, :])
    return out
