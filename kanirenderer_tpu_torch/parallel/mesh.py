"""Row-band rendering: the framebuffer split into bands of screen rows
(PyTorch counterpart of ``kanirenderer_tpu/parallel/mesh.py``).

Each band renders its rows through ``passes/frame.render_band``, the same
body ``render_frame`` runs, so the two cannot drift:

* scene and frame state are replicated; the vertex stage, the setups and
  the shadow binning run once per process, as every rank would compute
  them identically;
* each band bins its rows of the main grid (its own grid when contiguous,
  its tile rows of the full grid when interleaved) and runs K2/K2w, the
  shading and the surface on them;
* a fresh shadow map is rasterized in row bands, one per band (K1 on the
  band's run of the map's bins), and assembled by one all_gather: of the
  PCF table's rows for LIT_SHADOW (each band builds its rows from its map
  band and a halo of one row above and two below, which a small
  all_gather of every band's edge rows brings), of the map otherwise;
* DEBUG gathers the depth of every band for its depth quad.

A ``Mesh`` is one of two forms.  ``make_mesh(n)``: n bands in this
process, on one device, looped; the collectives are concatenations.
``make_mesh()`` in a process of an initialised ``torch.distributed``
group: one band per rank, the collectives ``Collectives.all_gather`` over
the group (gloo between CPU processes, and between processes that share a
card; NCCL where each rank has its own card).  Every collective moves its
tensor as bytes (a uint8 view): gloo raises on uint16 and NCCL has no
16-bit integer type, and the bytes come back intact.

Bands reassembled are the full frame bit for bit (``torch.equal``): the
kernels evaluate every plane at the global pixel centre and no
coefficient is re-anchored, unlike the JAX package's bands, which differ
from its full frame by about one ulp.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from kanirenderer_tpu_torch.core.types import (FrameState, RenderConfig,
                                               RenderMode, Scene,
                                               camera_state, default_lights,
                                               frame_state)
from kanirenderer_tpu_torch.passes.frame import (FrameOutputs, render_band,
                                                 render_frame)

Tensor = torch.Tensor


class Collectives:
    """``all_gather`` over the initialised ``torch.distributed`` group, as
    ``passes/frame.render_band`` takes it: every rank's tensor (same shape
    and dtype on every rank) concatenated along dim 0 in rank order, on
    the tensor's device.  The tensors travel as bytes, through host memory
    where the group is gloo's."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        # gloo gathers through host memory: hand it host tensors.
        self.host = dist.get_backend() == "gloo"

    def all_gather(self, t: Tensor) -> Tensor:
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        if self.host:
            flat = flat.cpu()
        out = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(out, flat)
        return torch.cat([o.view(t.dtype).reshape(t.shape) for o in out]
                         ).to(t.device)


class Mesh(NamedTuple):
    size: int                    # number of row bands
    comm: Collectives | None     # None: every band in this process


def make_mesh(n: int | None = None) -> Mesh:
    """n bands in this process, or (``n`` None) one band per rank of the
    initialised process group."""
    if n is not None:
        return Mesh(n, None)
    comm = Collectives()
    return Mesh(comm.size, comm)


def _band_geometry(config: RenderConfig, n: int, interleave: bool):
    """(band_h, y0 step) for contiguous or interleaved row bands."""
    if not interleave:
        return config.height // n, None
    tiles_full = -(-config.height // config.tile_h)
    tiles_band = -(-tiles_full // n)
    return tiles_band * config.tile_h, config.tile_h


def deinterleave_rows(arr, n: int, tile_h: int, height: int):
    """Reassemble an interleaved row-band stack (numpy or torch): stacked
    (n·J·tile_h, …) band-major → global row order, cropped to ``height``.
    Band k's row block j is global tile row j·n + k."""
    rest = tuple(arr.shape[1:])
    J = arr.shape[0] // (n * tile_h)
    a = arr.reshape((n, J, tile_h) + rest).swapaxes(0, 1)
    return a.reshape((n * J * tile_h,) + rest)[:height]


def render_frame_sharded(scene: Scene, state: FrameState,
                         config: RenderConfig, mesh: Mesh,
                         shadow_map: Tensor | None = None,
                         interleave: bool = False) -> FrameOutputs:
    """Render one frame in ``mesh.size`` row bands.

    Returns FrameOutputs whose image and depth hold every band's rows,
    band after band, on every rank: the full frame for contiguous bands
    (``config.height`` must divide by the band count), and for
    ``interleave`` (tile rows k, k + n, … per band, which spreads uneven
    content over the bands) a stack to reassemble with
    ``deinterleave_rows(out.image, n, config.tile_h, config.height)``.
    ``shadow_map``: a map the caller holds (replicated, no collective);
    without it LIT_SHADOW and DEBUG rasterize a fresh one in bands.
    ``raster_overflow`` is the sum over the bands; ``shadow`` is (1, 1)
    zeros.  No DEBUG with ``interleave``."""
    n, comm = mesh.size, mesh.comm
    band_h, step = _band_geometry(config, n, interleave)
    if not interleave and config.height % n:
        raise ValueError(f"height {config.height} does not divide into "
                         f"{n} bands")
    first = [k * (step if interleave else band_h) for k in range(n)]
    out = render_band(scene, state, config, shadow_map=shadow_map,
                      band_h=band_h,
                      y0=first if comm is None else first[comm.rank],
                      band_stride=n if interleave else 1,
                      shadow_bands=n if shadow_map is None else 1,
                      comm=comm)
    image, depth, overflow = out.image, out.depth, out.raster_overflow
    if comm is not None:   # frame assembly
        image, depth = comm.all_gather(image), comm.all_gather(depth)
        overflow = comm.all_gather(overflow.reshape(1)).sum()
    return FrameOutputs(image=image, depth=depth,
                        shadow=torch.zeros((1, 1), dtype=torch.float32,
                                           device=image.device),
                        raster_overflow=overflow)


# ---------------------------------------------------------------------------
# Processes.

def _rank_main(rank: int, n: int, backend: str, directory: str, threads: int,
               job, args) -> None:
    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{directory}/init",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=600))
    try:
        result = job(rank, n, *args)
        torch.save(result, os.path.join(directory, f"result_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, job, args=(), backend: str = "gloo") -> list:
    """Run ``job(rank, n, *args)`` in n new processes joined in a process
    group of ``backend`` (a ``file://`` rendezvous in a temporary
    directory; with NCCL rank r takes card r) and return what each rank's
    call returned (saved with ``torch.save``, so tensors come back on the
    device they were on).  ``job`` must be a module-level function.  The
    processes end before this returns; a failing rank raises here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="kani_ranks_") as directory:
        mp.spawn(_rank_main, args=(n, backend, directory,
                                   torch.get_num_threads(), job, args),
                 nprocs=n, join=True)
        return [torch.load(os.path.join(directory, f"result_{r}.pt"),
                           weights_only=False) for r in range(n)]


# ---------------------------------------------------------------------------
# The dry run: tiny shapes through every form.

def _dryrun_frames(mesh: Mesh, device) -> dict:
    """The cube scene at 128 × 16n, fresh 32n² map, tile rows of 8, u8
    surface: (image, depth) on the CPU of the whole frame and of the frame
    in contiguous and interleaved bands reassembled, LIT_SHADOW (banded
    map, table path), and of DEBUG with the depth quad, whole and in
    contiguous bands (banded map gathered, depth gathered)."""
    from kanirenderer_tpu_torch.models.procedural import cube_scene
    n = mesh.size
    scene = cube_scene(device=device)
    cam = camera_state([60.0, 45.0, 80.0], np.deg2rad(np.float32(-127.0)),
                       np.deg2rad(np.float32(-20.0)), device)
    times = torch.linspace(2.0, 9.0, 256, device=device)
    state = frame_state(scene, cam, default_lights(device=device), times)
    cfg = RenderConfig(width=128, height=16 * n, shadow_dim=32 * n,
                       mode=RenderMode.LIT_SHADOW, tile_h=8, output_u8=True)
    dbg = cfg.with_(mode=RenderMode.DEBUG)
    frames = {
        "full": render_frame(scene, state, cfg),
        "contiguous": render_frame_sharded(scene, state, cfg, mesh),
        "interleaved": render_frame_sharded(scene, state, cfg, mesh,
                                            interleave=True),
        "debug_full": render_frame(scene, state, dbg),
        "debug_contiguous": render_frame_sharded(scene, state, dbg, mesh)}
    out = {k: (f.image, f.depth) for k, f in frames.items()}
    out["interleaved"] = tuple(deinterleave_rows(t, n, cfg.tile_h,
                                                 cfg.height)
                               for t in out["interleaved"])
    return {k: (im.cpu(), d.cpu()) for k, (im, d) in out.items()}


def _dryrun_job(rank: int, n: int, device: str) -> dict:
    dev = torch.device(f"cuda:{rank}") if device == "cuda" \
        else torch.device(device)
    return _dryrun_frames(make_mesh(), dev)


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """The banded frame on n bands at tiny shapes (``_dryrun_frames``),
    each reassembled frame held ``torch.equal`` (image and depth) to the
    whole frame.  ``device="cuda"``: n NCCL ranks, one card each, where
    there are n cards, else the n bands looped in one process on card 0;
    ``device="cpu"``: n gloo processes.  Prints which form ran and returns
    rank 0's frames; raises on a mismatch and, for "cuda", where there is
    no card."""
    if device == "cpu":
        form = f"{n} gloo processes on the CPU"
        frames = run_ranks(n, _dryrun_job, ("cpu",), "gloo")[0]
    elif not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda') needs a card")
    elif torch.cuda.device_count() >= n:
        form = f"{n} NCCL ranks on {n} cards"
        frames = run_ranks(n, _dryrun_job, ("cuda",), "nccl")[0]
    else:
        form = (f"{n} bands looped in one process on card 0 (the host has "
                f"{torch.cuda.device_count()} card(s))")
        frames = _dryrun_frames(make_mesh(n), torch.device("cuda", 0))
    for name, whole in (("contiguous", "full"), ("interleaved", "full"),
                        ("debug_contiguous", "debug_full")):
        if not all(map(torch.equal, frames[name], frames[whole])):
            raise AssertionError(f"dryrun_multichip({n}): {name} bands "
                                 "differ from the whole frame")
    image = frames["full"][0]
    print(f"dryrun_multichip({n}) OK, {form}: frame {tuple(image.shape)} "
          f"{image.dtype}, mean {image.float().mean().item():.4f}; "
          "LIT_SHADOW in contiguous and interleaved bands and DEBUG in "
          "contiguous bands equal to the whole frame", flush=True)
    return frames
