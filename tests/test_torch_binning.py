"""The port's tile binner against the reference's ``bin_stream``.

Same bboxes in, same grid: every tile's chunk list must equal, exactly and
in ascending order, the chunk set decoded from the reference's run stream
(chunks with a subbatch bbox overlapping the tile), and both report no
overflow.  The port's cap is its own (a per-tile chunk count), tested on
its own.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kanirenderer_tpu.ops import binning as ref_binning

from kanirenderer_tpu_torch.core.types import (CHUNK_SIZE, camera_state,
                                               default_lights, frame_state)
from kanirenderer_tpu_torch.models.procedural import sponza_standin_scene
from kanirenderer_tpu_torch.ops.binning import bin_tiles
from kanirenderer_tpu_torch.passes.frame import frame_geometry
from kanirenderer_tpu_torch.core.types import RenderConfig

W, H, D = 256, 192, 256

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def geometry():
    scene = sponza_standin_scene(target_tris=6000, num_materials=4,
                                 tex_size=32, device="cpu")
    state = frame_state(scene, camera_state([-900.0, 180.0, 0.0], 0.0,
                                            np.deg2rad(-5.0), "cpu"),
                        default_lights(device="cpu"))
    return frame_geometry(scene, state,
                          RenderConfig(width=W, height=H, shadow_dim=D))


def decode_stream(bins, num_chunks, num_tiles):
    """Per-tile chunk lists of a reference StreamBins (runs expanded)."""
    hdr = np.asarray(bins.header)
    entries = np.asarray(bins.stream)[:, 0].reshape(-1)
    cpad = ref_binning.stream_cpad_for(num_chunks)
    out = []
    for t in range(num_tiles):
        s0 = hdr[0, t] * 128 + hdr[1, t]
        chunks = set()
        for e in entries[s0:s0 + hdr[2, t]]:
            cid0 = (e // 32) % cpad
            chunks.update(range(cid0, cid0 + e % 16))
        out.append(sorted(chunks))
    return out


@pytest.mark.parametrize("grid", ["camera", "shadow"])
@pytest.mark.parametrize("tile", [(16, 16), (32, 8)])
def test_tile_lists_match_bin_stream(geometry, grid, tile):
    st, size = ((geometry.setup, (W, H)) if grid == "camera"
                else (geometry.shadow_setup, (D, D)))
    tw, th = tile
    bins = bin_tiles(st.bbox, size[0], size[1], tw, th, cap=640)
    tx, ty = -(-size[0] // tw), -(-size[1] // th)
    ref = ref_binning.bin_stream(jnp.asarray(st.bbox.numpy()), tx, ty, tw,
                                 th, 64, 640, 128)
    want = decode_stream(ref, st.bbox.shape[0] // CHUNK_SIZE, tx * ty)
    assert (bins.tiles_x, bins.tiles_y) == (tx, ty)
    assert int(bins.count.sum()) == sum(map(len, want)) > 0
    for t in range(tx * ty):
        s, n = int(bins.start[t]), int(bins.count[t])
        assert bins.chunk[s:s + n].tolist() == want[t], t
    assert int(bins.overflow) == int(ref.overflow) == 0


def test_cap_drops_highest_chunks_and_counts_them(geometry):
    st = geometry.setup
    full = bin_tiles(st.bbox, W, H, 16, 16, cap=10_000)
    cap = 3
    capped = bin_tiles(st.bbox, W, H, 16, 16, cap=cap)
    raw = full.count.to(torch.int64)
    assert raw.max() > cap
    assert int(capped.overflow) == int(torch.clamp(raw - cap, min=0).sum())
    for t in range(raw.shape[0]):
        s, n = int(capped.start[t]), int(capped.count[t])
        fs, fn = int(full.start[t]), int(full.count[t])
        assert capped.chunk[s:s + n].tolist() == \
            full.chunk[fs:fs + min(fn, cap)].tolist()


def test_empty_and_offscreen_chunks_are_not_binned():
    T = 2 * CHUNK_SIZE
    bbox = torch.zeros((T, 4))
    bbox[:, 0], bbox[:, 1] = 64.0, 48.0       # empty boxes (x1 ≤ x0)
    bbox[5] = torch.tensor([3.0, 4.0, 20.0, 9.0])   # one real triangle
    bins = bin_tiles(bbox, 64, 48, 16, 16, cap=8)
    assert bins.count.tolist() == [1, 1, 0, 0] + [0] * 8
    assert bins.chunk[:2].tolist() == [0, 0]
    assert int(bins.overflow) == 0
