"""The roofline's work depends on the triangles, not on their order or on
how they are cut into chunks."""

import torch

from portbench import roofline


def boxes(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randint(-50, 1900, (n,), generator=g).float()
    y0 = torch.randint(-50, 1050, (n,), generator=g).float()
    w = torch.randint(-5, 80, (n,), generator=g).float()
    h = torch.randint(-5, 80, (n,), generator=g).float()
    return torch.stack([x0.clamp(min=0), y0.clamp(min=0),
                        (x0 + w).clamp(0, 1920), (y0 + h).clamp(0, 1080)], 1)


def test_depth_work_ignores_order_and_chunking():
    b = boxes(5000)
    want = roofline.depth_work(b, 2048)
    perm = torch.randperm(5000, generator=torch.Generator().manual_seed(1))
    assert roofline.depth_work(b[perm], 2048) == want
    # the same triangles padded to whole chunks of 128 with empty boxes
    pad = torch.zeros((128 - 5000 % 128, 4))
    assert roofline.depth_work(torch.cat([b, pad]), 2048) == want


def test_pixel_work_ignores_order_and_ids():
    b = boxes(3000, 2)
    g = torch.Generator().manual_seed(3)
    tid = torch.randint(-1, 3000, (64, 96), generator=g)
    want = roofline.pixel_work(b, tid, 96, 64)
    perm = torch.randperm(3000, generator=g)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(3000)
    moved = torch.where(tid >= 0, inv[tid.clamp(min=0)], tid)
    assert roofline.pixel_work(b[perm], moved, 96, 64) == want


def test_work_counts():
    b = torch.tensor([[0.0, 0.0, 10.0, 4.0], [5.0, 5.0, 5.0, 9.0]])
    nbytes, ops = roofline.depth_work(b, 16)
    assert ops == 40 * roofline.OPS_COVER
    assert nbytes == 1 * (roofline.SETUP_B + roofline.BBOX_B) + 16 * 16 * 4
    tid = torch.tensor([[0, 0], [-1, 0]])
    nbytes, ops = roofline.pixel_work(b, tid, 2, 2)
    assert ops == 40 * roofline.OPS_COVER + 3 * roofline.OPS_K2_PIXEL
    assert nbytes == (roofline.SETUP_B + roofline.BBOX_B + roofline.RECORD_B
                      + 4 * roofline.PIXEL_PX_B)


def test_bound_takes_the_larger():
    assert roofline.bound_ms(3.35e9, 0)[1] == "bytes"
    t, by = roofline.bound_ms(0, 67e9)
    assert by == "operations" and abs(t - 1.0) < 1e-12
