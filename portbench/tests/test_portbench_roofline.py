"""The roofline's work depends on the triangles, not on their order or on
how they are cut into chunks; the shading kernel's on each light only
where it reaches a covered pixel; and the shading kernel's reader divides
its bound by the kernel's mean time."""

import pytest
import torch

from portbench import roofline, run
from portbench.tests.conftest import ROOT


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


def rig(points=(), movable=((0.0, 1e6, 0.0), 256.0)):
    """The reference's rig with the movable light at ``movable`` (position,
    range) and the point lights ``points``, each (position, range)."""
    from portbench.reference.types import MovableLight, PointLights
    from portbench.reference.types import default_lights
    base = default_lights(device="cpu")
    pos, rng = movable
    mov = MovableLight(position=torch.tensor(pos), color=base.movable.color,
                       range=torch.tensor(rng), yaw=base.movable.yaw)
    pts = PointLights(
        position=torch.tensor([p for p, _ in points]).reshape(-1, 3),
        color=torch.full((len(points), 3), 10.0),
        range=torch.tensor([r for _, r in points]).reshape(-1))
    return base._replace(movable=mov, points=pts)


def world(n=500, seed=4):
    """(3, n) world positions in a 200-unit box about the origin."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((3, n), generator=g) * 200.0 - 100.0


def shade_work(world, lights, shadow=True):
    return roofline.shade_work(world.shape[1],
                               roofline.lights_in_range(world, lights),
                               96, 64, shadow)


@pytest.mark.parametrize("shadow", [False, True], ids=["LIT", "LIT_SHADOW"])
def test_a_light_out_of_range_of_every_pixel_adds_no_operations(shadow):
    w = world()
    dark = rig([((99999.0, 999999.0, 99999.0), 0.0)])
    far = rig([((99999.0, 999999.0, 99999.0), 0.0),
               ((5000.0, 0.0, 0.0), 256.0), ((0.0, 0.0, 0.0), 0.0)])
    assert roofline.lights_in_range(w, far) == 0
    nbytes, ops = shade_work(w, dark, shadow)
    assert shade_work(w, far, shadow) == (nbytes, ops)
    per_pixel = roofline.OPS_SHADE_PIXEL \
        + (roofline.OPS_SHADE_PCF if shadow else 0)
    assert ops == 500 * per_pixel


@pytest.mark.parametrize("n", [1, 3, 150])
def test_in_range_lights_add_their_count_each(n):
    w = world()
    base = shade_work(w, rig())
    near = rig([((float(k), 0.0, 0.0), 1000.0) for k in range(n)])
    assert roofline.lights_in_range(w, near) == 500 * n
    assert shade_work(w, near)[1] - base[1] \
        == n * 500 * roofline.OPS_SHADE_LIGHT
    # the movable light is counted alike
    movable = rig(movable=((0.0, 0.0, 0.0), 1000.0))
    assert shade_work(w, movable)[1] - base[1] \
        == 500 * roofline.OPS_SHADE_LIGHT


def test_a_light_counts_only_the_pixels_inside_its_range():
    # pixels on the x axis at 0, 3, 5 and 9; a pixel at the range's
    # distance is outside it, where the attenuation is 0
    w = torch.tensor([[0.0, 3.0, 5.0, 9.0], [0.0] * 4, [0.0] * 4])
    assert roofline.lights_in_range(w, rig([((0.0, 0.0, 0.0), 5.0)])) == 2
    # (0, 0, 0) reaches 0 and 3; (9, 0, 4) reaches 9 (4 away), not 5
    # (5.66 away); the movable light at x = 1 reaches 0 and 3
    assert roofline.lights_in_range(
        w, rig([((0.0, 0.0, 0.0), 5.0), ((9.0, 0.0, 4.0), 5.0)],
               movable=((1.0, 0.0, 0.0), 2.5))) == 2 + 1 + 2


def test_shade_bytes_do_not_depend_on_the_rig():
    w = world()
    nbytes = shade_work(w, rig())[0]
    assert nbytes == 96 * 64 * (roofline.MASK_PX_B + roofline.OUT_PX_B) \
        + 500 * roofline.SHADE_PLANES_B
    for lights in (rig([((0.0, 0.0, 0.0), 1000.0)] * 40),
                   rig(movable=((0.0, 0.0, 0.0), 1000.0))):
        assert shade_work(w, lights)[0] == nbytes
        assert shade_work(w, lights, False)[0] == nbytes


class Context:
    """What the reader uses of ``run.MetricContext``: a trace, the
    RenderConfig and the counted work."""

    def __init__(self, device, hdr=False, work=(3.35e8, 6.7e8)):
        from types import SimpleNamespace

        from portbench import trace as tr
        self.trace = tr.Trace(frames=2, begin_us=0.0, end_us=1e4,
                              drained_us=1e4, device=device, host=[],
                              calls={}, launches=[], kernels={})
        self.config = SimpleNamespace(hdr=hdr)
        self._work = work

    def work(self, kind):
        assert kind == "shade"
        return self._work


SHADE = "void (anonymous namespace)::shade_forward_kernel<true, false>" \
    "((anonymous namespace)::ShadeArgs)"


def test_the_shade_reader_divides_the_bound_by_the_mean_kernel_time():
    reader = run.load_metric(ROOT / "metrics", "kernel.shade_roofline")
    # bytes 3.35e8 → 0.1 ms, operations 6.7e8 → 0.01 ms: bound 0.1 ms;
    # the kernel's two records take 0.2 and 0.6 ms, 0.4 on average.
    ctx = Context([(100.0, 300.0, SHADE), (350.0, 360.0, "other_kernel"),
                   (1000.0, 1600.0, SHADE)])
    assert reader.read(ctx) == pytest.approx(25.0, rel=1e-12)
    # bound by operations: 6.7e9 → 0.1 ms, bytes 0.001 ms
    ctx = Context([(0.0, 400.0, SHADE)], work=(3.35e6, 6.7e9))
    assert reader.read(ctx) == pytest.approx(25.0, rel=1e-12)


@pytest.mark.parametrize("device, hdr", [
    ([(0.0, 50.0, "raster_pixels_kernel<false, false>")], False),
    ([], False), ([(0.0, 400.0, SHADE)], True)],
    ids=["other_kernels", "no_kernels", "hdr"])
def test_the_shade_reader_reads_nothing_without_its_kernel(device, hdr):
    reader = run.load_metric(ROOT / "metrics", "kernel.shade_roofline")
    assert reader.read(Context(device, hdr)) is None
