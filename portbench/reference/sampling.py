"""Frozen copy of ``kanirenderer_tpu_torch/ops/sampling.py`` (commit 1e399aa), the
benchmark's plain reference; only its imports were changed.

Texture and shadow sampling as row gathers (PyTorch counterpart of
``kanirenderer_tpu/ops/sampling.py``).

* ``sample_materials_combined`` — bilinear diffuse + normal-map filtering
  with Repeat addressing from the combined block table
  (``Scene.tex_combined``): each texture is tiled into 3×4-texel blocks
  whose Repeat-wrapped 4×5 windows × 6 channels (diffuse RGB, normal RGB)
  form one 120-lane row, so a pixel's bilinear footprint is one gathered
  row.  The diffuse lanes hold round(sqrt(linear)·255) (decode v²/65025),
  the normal lanes raw u8 (decode v/255).
* ``sample_materials_blocks`` — the same filtering from the separate
  tables of a scene with a normal map deeper than 8 bits
  (``Scene.tex_diffuse`` / ``Scene.tex_normal``): 6×4-texel blocks whose
  Repeat-wrapped 7×5 windows × RGB form one 105-lane row per texture, the
  normal table at its source depth (u16 or f32).
* ``build_shadow_table`` / ``sample_shadow_pcf`` — 3×3 PCF of comparison
  taps (reference src/lib.rs:760-767, src/shader.wgsl:140-159) from a
  table whose row b is the clamp-padded 11×11 window of 8×8 shadow block
  b, depth quantized to 16-bit unorm; ``build_shadow_table_band`` builds
  the rows of one row band of the map from the band and its halo rows.

The per-lane weights are separable, so the port forms them as an outer
product of a row and a column profile and reduces the lanes with a sum;
the reference reduces with a selector matmul.  The terms are the same,
the summation order differs.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

# Shadow block-window geometry: 8×8 texel blocks, 11×11 windows.
_B = 8
_WIN = _B + 3

# Combined-table geometry: 3×4-texel blocks, 4×5 window × 6 channels.
CMB_BX = 3
CMB_BY = 4
CMB_WINX = CMB_BX + 1
CMB_WINY = CMB_BY + 1
CMB_LANES = CMB_WINX * CMB_WINY * 6    # 120


# Separate-table geometry: 6×4-texel blocks, 7×5 window × RGB.
MAT_BX = 6
MAT_BY = 4
MAT_WINX = MAT_BX + 1
MAT_WINY = MAT_BY + 1
MAT_LANES = MAT_WINX * MAT_WINY * 3    # 105


def build_combined_blocks(diffuse_u8: np.ndarray,
                          normal_u8: np.ndarray) -> np.ndarray:
    """(h, w, 3) u8 sqrt-encoded diffuse + (h, w, 3) u8 raw normal →
    (ceil(h/4)·ceil(w/3), 128) u8 rows of Repeat-wrapped 4×5 windows,
    lanes (row, col, channel) channel-innermost.  Host-side, once per
    texture at scene build."""
    h, w = diffuse_u8.shape[:2]
    bw = -(-w // CMB_BX)
    bh = -(-h // CMB_BY)
    ys = (np.arange(bh)[:, None] * CMB_BY + np.arange(CMB_WINY)[None]) % h
    xs = (np.arange(bw)[:, None] * CMB_BX + np.arange(CMB_WINX)[None]) % w
    both = np.concatenate([diffuse_u8, normal_u8], axis=-1)   # (h, w, 6)
    win = both[ys[:, None, :, None], xs[None, :, None, :]]    # (bh,bw,5,4,6)
    rows = win.reshape(bh * bw, CMB_LANES)
    return np.pad(rows, ((0, 0), (0, 128 - CMB_LANES)))


def _hat(lanes: Tensor, a: Tensor) -> Tensor:
    """max(0, 1 − |lane − a|): 1−f at the anchor texel, f at its +1
    neighbour (bilinear weights as a function of lane position)."""
    return torch.clamp(1.0 - torch.abs(lanes - a[..., None]), min=0.0)


def sample_materials_combined(tex_combined: Tensor, blk_base: Tensor,
                              blk_w: Tensor, tw: Tensor, th: Tensor,
                              u: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
    """Returns (diffuse (3, H, W) linear f32, normal (3, H, W) raw f32).

    blk_base/blk_w/tw/th are per-pixel (H, W) i32 planes from the
    triangle records; u, v the interpolated texture coordinates."""
    dev = u.device
    tx = u * tw.to(torch.float32) - 0.5
    ty = v * th.to(torch.float32) - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = torch.remainder(x0.to(torch.int32), tw)
    y0i = torch.remainder(y0.to(torch.int32), th)
    bx = torch.div(x0i, CMB_BX, rounding_mode="floor")
    by = torch.div(y0i, CMB_BY, rounding_mode="floor")
    lx = x0i - bx * CMB_BX
    ly = y0i - by * CMB_BY
    row = (blk_base + by * blk_w + bx).reshape(-1)

    ax = (lx.to(torch.float32) + fx).reshape(-1)
    ay = (ly.to(torch.float32) + fy).reshape(-1)
    cols = torch.arange(CMB_WINX, dtype=torch.float32, device=dev)
    rows = torch.arange(CMB_WINY, dtype=torch.float32, device=dev)
    wgt = _hat(rows, ay)[:, :, None] * _hat(cols, ax)[:, None, :]  # (N,5,4)

    win = tex_combined.index_select(0, row)[:, :CMB_LANES]
    w32 = win.to(torch.float32).reshape(-1, CMB_WINY, CMB_WINX, 6)
    lane_ch = torch.arange(6, device=dev)
    dscale = torch.where(lane_ch < 3, 1.0 / 65025.0, 0.0).to(torch.float32)
    nscale = torch.where(lane_ch >= 3, 1.0 / 255.0, 0.0).to(torch.float32)
    s = (w32 * dscale + nscale) * w32 * wgt[..., None]
    out6 = s.sum(dim=(1, 2))                                 # (N, 6)
    out6 = out6.T.reshape((6,) + u.shape)
    return out6[:3], out6[3:]


def build_material_blocks(tex: np.ndarray) -> np.ndarray:
    """(h, w, 3) texture of any dtype → (ceil(h/4)·ceil(w/6), 128) rows of
    Repeat-wrapped 7×5 windows, lanes (row, col, channel)
    channel-innermost, in the texture's dtype.  Host-side, once per
    texture at scene build."""
    h, w = tex.shape[:2]
    bw = -(-w // MAT_BX)
    bh = -(-h // MAT_BY)
    ys = (np.arange(bh)[:, None] * MAT_BY + np.arange(MAT_WINY)[None]) % h
    xs = (np.arange(bw)[:, None] * MAT_BX + np.arange(MAT_WINX)[None]) % w
    win = tex[ys[:, None, :, None], xs[None, :, None, :]]  # (bh,bw,5,7,3)
    rows = win.reshape(bh * bw, MAT_LANES)
    return np.pad(rows, ((0, 0), (0, 128 - MAT_LANES)))


def _gather_f32(table: Tensor, row: Tensor) -> Tensor:
    """Rows of a u8, u16 or f32 table as float32.  A u16 table is gathered
    through its int16 view, which every device indexes, and the wrapped
    negatives are brought back to 0..65535."""
    if table.dtype == torch.uint16:
        x = table.view(torch.int16).index_select(0, row).to(torch.float32)
        return torch.where(x < 0, x + 65536.0, x)
    return table.index_select(0, row).to(torch.float32)


def sample_materials_blocks(tex_diffuse: Tensor, tex_normal: Tensor,
                            blk_base: Tensor, blk_w: Tensor, tw: Tensor,
                            th: Tensor, u: Tensor,
                            v: Tensor) -> tuple[Tensor, Tensor]:
    """``sample_materials_combined`` from the separate tables: one row
    gather per texture.  The table's dtype selects the decode: the u8
    diffuse table is sqrt-encoded (v²/65025); a normal table is raw unorm
    (u8 /255, u16 /65535) or float."""
    dev = u.device
    tx = u * tw.to(torch.float32) - 0.5
    ty = v * th.to(torch.float32) - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = torch.remainder(x0.to(torch.int32), tw)
    y0i = torch.remainder(y0.to(torch.int32), th)
    bx = torch.div(x0i, MAT_BX, rounding_mode="floor")
    by = torch.div(y0i, MAT_BY, rounding_mode="floor")
    lx = x0i - bx * MAT_BX
    ly = y0i - by * MAT_BY
    row = (blk_base + by * blk_w + bx).reshape(-1)

    ax = (lx.to(torch.float32) + fx).reshape(-1)
    ay = (ly.to(torch.float32) + fy).reshape(-1)
    cols = torch.arange(MAT_WINX, dtype=torch.float32, device=dev)
    rows = torch.arange(MAT_WINY, dtype=torch.float32, device=dev)
    wgt = _hat(rows, ay)[:, :, None] * _hat(cols, ax)[:, None, :]  # (N,5,7)

    def tex(table, sqrt_encoded):
        w32 = _gather_f32(table, row)[:, :MAT_LANES] \
            .reshape(-1, MAT_WINY, MAT_WINX, 3)
        if table.dtype == torch.uint8 and sqrt_encoded:
            s = (w32 * w32) * (wgt * (1.0 / 65025.0))[..., None]
        elif table.dtype == torch.uint8:
            s = w32 * (wgt * (1.0 / 255.0))[..., None]
        elif table.dtype == torch.uint16:
            s = w32 * (wgt * (1.0 / 65535.0))[..., None]
        else:
            s = w32 * wgt[..., None]
        return s.sum(dim=(1, 2)).T.reshape((3,) + u.shape)

    return tex(tex_diffuse, True), tex(tex_normal, False)


def build_shadow_table(shadow_map: Tensor) -> Tensor:
    """(D, D) shadow map → ((D/8)², 128) block-window table.

    Row (by·D/8 + bx) holds the clamp-padded 11×11 window anchored at
    texel (8bx−1, 8by−1), row-major in lanes 0..120 (121..127 are zero).
    Depth is quantized to 16-bit unorm like the reference's D16 table; the
    port keeps the integer values in float32, which holds them exactly and
    spares a conversion after the per-pixel gather."""
    D = shadow_map.shape[0]
    if D % _B:
        raise ValueError("shadow_dim must be a multiple of 8")
    padded = torch.nn.functional.pad(_quantize(shadow_map)[None, None],
                                     (1, _B, 1, _B), mode="replicate")[0, 0]
    return _table_from_padded_rows(padded)


def _quantize(depth: Tensor) -> Tensor:
    return torch.round(torch.clamp(depth, 0.0, 1.0) * 65535.0)


def _table_from_padded_rows(padded: Tensor) -> Tensor:
    """Table rows of the 8-row blocks of (8·nbb + 3 or more, D + 9)
    quantized map rows padded by one row and column before and by the
    halo after: one row per block, blocks row-major."""
    win = padded.unfold(0, _WIN, _B).unfold(1, _WIN, _B)  # (nbb, nb, 11, 11)
    t = win.reshape(-1, _WIN * _WIN)
    return torch.nn.functional.pad(t, (0, 128 - _WIN * _WIN))


def build_shadow_table_band(band: Tensor, top1: Tensor, bot2: Tensor,
                            D: int) -> Tensor:
    """The table rows of a row band of the map (the reference's
    ``build_shadow_table_band``, kanirenderer_tpu/ops/sampling.py:294):
    ``band`` (sb_h, D) map rows [y0, y0 + sb_h) with sb_h a multiple of 8,
    ``top1`` (1, D) the map row above it and ``bot2`` (2, D) the two below
    (the band's own edge row where the map ends, as the map's replicate
    padding).  Block row by reads map rows 8·by − 1 … 8·by + 9, so these
    are ``build_shadow_table``'s rows (sb_h/8 · D/8 of them) exactly."""
    if band.shape[0] % _B or band.shape[1] != D:
        raise ValueError(f"a band of {tuple(band.shape)} for a {D}² map")
    rows = _quantize(torch.cat([top1, band, bot2]))
    padded = torch.nn.functional.pad(rows[None, None], (1, _B, 0, 0),
                                     mode="replicate")[0, 0]
    return _table_from_padded_rows(padded)


def _trapezoid(lanes: Tensor, a: Tensor) -> Tensor:
    """Row/column sums of the nine bilinear PCF kernels as a function of the
    lane's distance d from the anchor: 1−f, 1, 1, f at d = −f .. 3−f."""
    d = lanes - a[..., None]
    return torch.clamp(torch.minimum(d + 1.0, 3.0 - d), 0.0, 1.0)


def sample_shadow_pcf(shadow_table: Tensor, dim: int, u: Tensor, v: Tensor,
                      depth: Tensor) -> Tensor:
    """3×3 PCF average of comparison taps: one table-row gather and a
    separable-weight reduction over the 11×11 window."""
    D = dim
    nb = D // _B
    tx = u * D - 0.5
    ty = v * D - 0.5
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = torch.clamp(x0.to(torch.int32), 0, D - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, D - 1)
    blk = ((y0i >> 3) * nb + (x0i >> 3)).reshape(-1)
    ly = y0i & (_B - 1)
    lx = x0i & (_B - 1)

    win = shadow_table.index_select(0, blk)[:, :_WIN * _WIN]
    win = win.reshape(-1, _WIN, _WIN)
    passed = (depth.reshape(-1) * 65535.0)[:, None, None] <= win

    lanes = torch.arange(_WIN, dtype=torch.float32, device=u.device)
    wy = _trapezoid(lanes, (ly.to(torch.float32) + fy).reshape(-1))
    wx = _trapezoid(lanes, (lx.to(torch.float32) + fx).reshape(-1))
    w = wy[:, :, None] * wx[:, None, :]
    pcf = torch.where(passed, w, 0.0).sum(dim=(1, 2)) / 9.0
    return pcf.reshape(u.shape)
