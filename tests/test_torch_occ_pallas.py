"""The port's occlusion skip against the Pallas raster's:
tests/test_occ_gate.py:53-73 for the port, on the reference's two-layer
triangles (tests/test_binning_pallas.py:371), the Pallas kernel run in
interpret mode as the JAX package's own tests run it.

Tolerance: mask equal, z within 1e-6, ids differing on at most 2% of
pixels (z ties, whose order the TPU kernel takes from its run order),
the tolerance of tests/test_occ_gate.py:69-73.
"""

import numpy as np
import torch

import kanirenderer_tpu as kani
from kanirenderer_tpu.ops import raster_pallas

from kanirenderer_tpu_torch.core.types import RenderConfig
from kanirenderer_tpu_torch.ops import occ_replay
from kanirenderer_tpu_torch.ops import raster_cuda as rc
from kanirenderer_tpu_torch.ops.binning import bin_tiles, depth_bound
from kanirenderer_tpu_torch.ops.vertex import TriangleSetup
from tests.test_binning_pallas import _two_layer_setup

torch.set_num_threads(2)


def test_scope_1_against_the_pallas_raster_on_two_layers():
    """tests/test_occ_gate.py:53-73 for the port: the reference's two
    layers through its Pallas raster with scope "1" and through the port's
    ``rasterize_config`` with scope "1" (nearest-first bins)."""
    ref_st = _two_layer_setup(height=64, ny=4)
    cfg_ref = kani.RenderConfig(width=256, height=64, occ_scope="1")
    v_ref = raster_pallas.rasterize(ref_st, cfg_ref)
    st = TriangleSetup(*(torch.from_numpy(np.array(a)) for a in ref_st))
    cfg = RenderConfig(width=256, height=64, occ_scope="1")
    v = rc.rasterize_config(st, cfg)
    ref_tri, ref_z = np.asarray(v_ref.tri), np.asarray(v_ref.z)
    np.testing.assert_array_equal(v.tri.numpy() >= 0, ref_tri >= 0)
    np.testing.assert_allclose(v.z.numpy(), ref_z, atol=1e-6)
    assert (v.tri.numpy() != ref_tri).mean() < 0.02
    # the port's rule on its nearest-first bins gives the same raster
    bins = bin_tiles(st.bbox, 256, 64, 16, 16, 640,
                     occ_bound=depth_bound(st.setup, st.bbox, 16, 16))
    on = occ_replay.replay(st.setup, st.bbox, bins, 256, 64)
    assert on.counts["chunks_tested"] > 0
    assert torch.equal(on.tid, v.tri) and torch.equal(on.z, v.z)
