"""The forward shading kernel (csrc/shade_forward.cu) on the CPU: its
reduced-tap sampling written in plain PyTorch against the samplers, the
cases ``ops/shade_cuda.covers`` sends to it, and the CPU frame's plain
path.  The kernel itself runs only on the card (tests/test_torch_cuda.py).

Tolerances: the reduced-tap sums take the non-zero lane terms of the
samplers' reductions and nothing else, in another order, so they agree
within 1e-6 relative (sums of non-negative float32 terms); the CPU frame
is the plain chain's bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kanirenderer_tpu_torch.core.types import (RenderConfig, RenderMode,
                                               camera_state, default_lights,
                                               frame_state)
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops import sampling, shade_cuda
from kanirenderer_tpu_torch.passes import frame as frame_mod
from kanirenderer_tpu_torch.passes.frame import (band_bins, band_pixels,
                                                 band_shade, band_surface,
                                                 frame_geometry, render_frame,
                                                 render_shadow_map)

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)

N = 4096


def _hat(lane, a):
    return torch.clamp(1.0 - torch.abs(lane.to(torch.float32) - a), min=0.0)


def materials_reduced(tex, blk_base, blk_w, tw, th, u, v):
    """The kernel's texture sample: the 2x2 texels of the combined row that
    the hat weights leave non-zero, each column's rows summed, then the
    columns."""
    tx = u * tw.to(torch.float32) - 0.5
    ty = v * th.to(torch.float32) - 0.5
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = tx - x0, ty - y0
    x0i = torch.remainder(x0.to(torch.int32), tw)
    y0i = torch.remainder(y0.to(torch.int32), th)
    bx = torch.div(x0i, sampling.CMB_BX, rounding_mode="floor")
    by = torch.div(y0i, sampling.CMB_BY, rounding_mode="floor")
    lx, ly = x0i - bx * sampling.CMB_BX, y0i - by * sampling.CMB_BY
    row = (blk_base + by * blk_w + bx).long()
    ax, ay = lx.to(torch.float32) + fx, ly.to(torch.float32) + fy
    ch = torch.arange(6)
    cols = []
    for c in (0, 1):
        col = None
        for r in (0, 1):
            lane = ((ly + r) * sampling.CMB_WINX + lx + c)[:, None] * 6 + ch
            t = tex[row[:, None], lane.long()].to(torch.float32)
            w = (_hat(ly + r, ay) * _hat(lx + c, ax))[:, None]
            term = torch.where(ch < 3, ((t * (1.0 / 65025.0)) * t) * w,
                               ((1.0 / 255.0) * t) * w)
            col = term if col is None else col + term
        cols.append(col)
    out = (cols[0] + cols[1]).T
    return out[:3], out[3:]


def _trapezoid(lane, a):
    d = lane.to(torch.float32) - a
    return torch.clamp(torch.minimum(d + 1.0, 3.0 - d), 0.0, 1.0)


def pcf_reduced(table, D, u, v, depth):
    """The kernel's PCF: the 4x4 taps of the 11x11 window that the
    trapezoid weights leave non-zero, summed row by row."""
    tx, ty = u * D - 0.5, v * D - 0.5
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = tx - x0, ty - y0
    x0i = torch.clamp(x0.to(torch.int32), 0, D - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, D - 1)
    blk = ((y0i >> 3) * (D // 8) + (x0i >> 3)).long()
    ly, lx = y0i & 7, x0i & 7
    ax, ay = lx.to(torch.float32) + fx, ly.to(torch.float32) + fy
    ref = depth * 65535.0
    total = torch.zeros_like(u)
    for r in range(4):
        for c in range(4):
            tap = table[blk, ((ly + r) * 11 + lx + c).long()]
            w = _trapezoid(ly + r, ay) * _trapezoid(lx + c, ax)
            total = total + torch.where(ref <= tap, w, 0.0)
    return total * (1.0 / 9.0)


def _coords(rng, n, scale_lo, scale_hi):
    """Seeded coordinates: a third inside [0, 1], a third far outside
    (Repeat wrap or clamp), a third on exact texel-centre anchors."""
    k = n // 3
    inside = rng.uniform(0.0, 1.0, k)
    outside = rng.uniform(scale_lo, scale_hi, k)
    return inside, outside, n - 2 * k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduced_texture_footprint_matches_sampler(seed):
    rng = np.random.default_rng(seed)
    sizes = [(32, 32), (17, 9), (5, 3), (64, 48)]
    rows, base, meta = [], 0, []
    for w, h in sizes:
        diffuse = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        normal = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        blocks = sampling.build_combined_blocks(diffuse, normal)
        meta.append((base, -(-w // sampling.CMB_BX), w, h))
        rows.append(blocks)
        base += blocks.shape[0]
    tex = torch.from_numpy(np.concatenate(rows))
    pick = rng.integers(0, len(sizes), N)
    blk_base, blk_w, tw, th = (torch.tensor([meta[i][j] for i in pick],
                                            dtype=torch.int32)
                               for j in range(4))
    uv = []
    for size in (tw, th):
        inside, outside, rest = _coords(rng, N, -7.5, 9.5)
        centres = (rng.integers(-40, 80, rest) + 0.5) / size[-rest:].numpy()
        uv.append(torch.tensor(np.concatenate([inside, outside, centres]),
                               dtype=torch.float32))
    u, v = uv
    want = sampling.sample_materials_combined(tex, blk_base, blk_w, tw, th,
                                              u, v)
    got = materials_reduced(tex, blk_base, blk_w, tw, th, u, v)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
    assert want[0].max() > 0.5 and want[1].max() > 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduced_pcf_taps_match_sampler(seed):
    rng = np.random.default_rng(seed)
    D = 64
    smap = torch.from_numpy(rng.uniform(0.0, 1.0, (D, D)).astype(np.float32))
    table = sampling.build_shadow_table(smap)
    cols = []
    for _ in range(2):
        inside, outside, rest = _coords(rng, N, -0.6, 1.6)
        anchors = (rng.integers(-3, D + 3, rest) + 0.5) / D
        cols.append(torch.tensor(np.concatenate([inside, outside, anchors]),
                                 dtype=torch.float32))
    u, v = cols
    depth = torch.from_numpy(rng.uniform(-0.05, 1.05, N).astype(np.float32))
    want = sampling.sample_shadow_pcf(table, D, u, v, depth)
    got = pcf_reduced(table, D, u, v, depth)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    assert 0.1 < want.mean().item() < 0.9


@pytest.fixture(scope="module")
def scene():
    return sponza_standin_scene(target_tris=6000, num_materials=4,
                                tex_size=32, device="cpu")


COVERED = RenderConfig(width=96, height=64, shadow_dim=256,
                       mode=RenderMode.LIT_SHADOW, output_u8=True)
CASES = [
    ("lit_shadow", {}, True),
    ("lit", dict(mode=RenderMode.LIT), True),
    ("hdr", dict(hdr=True), True),
    ("lit_hdr", dict(mode=RenderMode.LIT, hdr=True), True),
    ("unlit", dict(mode=RenderMode.UNLIT), False),
    ("wireframe", dict(mode=RenderMode.WIREFRAME), False),
    ("debug", dict(mode=RenderMode.DEBUG), False),
    ("deferred", dict(deferred=True), False),
    ("present_scale2", dict(present_scale=2), False),
    ("float32_surface", dict(output_u8=False), False),
]


@pytest.mark.parametrize("name,changes,want", CASES,
                         ids=[c[0] for c in CASES])
def test_covers_picks_the_kernel_only_where_it_applies(scene, name, changes,
                                                       want):
    cfg = dataclasses.replace(COVERED, **changes)
    assert shade_cuda.covers(cfg, scene, torch.device("cuda", 0)) is want
    assert shade_cuda.covers(cfg, scene, "cuda") is want
    # the CPU and the separate tables of a deeper normal map: never
    assert not shade_cuda.covers(cfg, scene, "cpu")
    deep = scene._replace(tex_combined=scene.tex_combined[:0])
    assert not shade_cuda.covers(cfg, deep, torch.device("cuda", 0))


def _plain_frame(scene, state, cfg):
    """The frame as render_band computed it before the kernel: the stage
    functions with band_shade and band_surface."""
    g = frame_geometry(scene, state, cfg)
    table = None
    if cfg.mode == RenderMode.LIT_SHADOW:
        table = sampling.build_shadow_table(
            render_shadow_map(scene, state, cfg, g.light_vp))
    bins = band_bins(g, cfg, 0, cfg.height)
    pix = band_pixels(g, cfg, bins, 0, cfg.height)
    return band_surface(band_shade(scene, state, cfg, pix, table,
                                   g.light_vp), state, cfg, pix.z, None)


@pytest.mark.parametrize("name", ["lit_shadow", "lit", "hdr"])
def test_cpu_frame_keeps_the_plain_path(scene, monkeypatch, name):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU frame reached the kernel's wrapper")

    monkeypatch.setattr(shade_cuda, "shade_surface", refuse)
    cfg = dataclasses.replace(COVERED, **dict(
        (c[0], c[1]) for c in CASES)[name])
    state = frame_state(scene, camera_state([-900.0, 180.0, 0.0], 0.0,
                                            np.deg2rad(-5.0), "cpu"),
                        default_lights(device="cpu"))
    rc.reset_launch_counts()
    out = render_frame(scene, state, cfg)
    want = _plain_frame(scene, state, cfg)
    assert out.image.dtype == (torch.float16 if cfg.hdr else torch.uint8)
    assert torch.equal(out.image, want)
    assert out.image.float().std() > 0.01
    assert rc.launch_counts["shade_forward"] == 0
    assert frame_mod.shade_cuda is shade_cuda
