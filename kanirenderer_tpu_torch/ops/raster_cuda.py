"""The tile raster kernels: wrappers, launch counts and plain versions.

Counterpart of ``kanirenderer_tpu/ops/raster_pallas.py``:

* ``rasterize_depth`` (K1, csrc/raster_depth.cu) — depth-only raster of
  the shadow map, the reference's ``_raster_kernel`` with depth_only=True;
* ``rasterize_pixels`` (K2, csrc/raster_pixels.cu) — the fused visibility
  raster + record interpolation, the reference's ``_fused_kernel``; with
  ``wireframe=True`` its wireframe variant K2w (launch count
  ``rasterize_pixels_wireframe``);
* ``rasterize`` (K3, csrc/raster_visibility.cu) — the visibility buffer
  (triangle id, depth, barycentrics), the reference's ``_raster_kernel``
  with depth_only=False, with or without wireframe coverage.

All take binned inputs (ops/binning.bin_tiles), cull by bbox first and
fetch only the hits' planes from the (T, 16) setup rows
(csrc/raster_common.cuh); K2 therefore takes the setup rows beside its
records, whose lanes 0:12 hold the same values.  On a CUDA tensor a
wrapper launches its kernel and counts the launch in ``launch_counts``; on
a CPU tensor it runs its plain PyTorch version (``*_plain``), which
computes the same function with the same floating-point order and serves
as the oracle the kernels are checked against on the card.

Row bands: K1 takes ``y0`` and ``band_h`` (map rows [y0, y0 + band_h),
from the full map's bins), K2/K2w ``y0``, ``y_stride`` and ``band_h`` (band
row r is global row y0 + (r // tile_h)·y_stride·tile_h + r % tile_h, from
the band's bins: ops/binning ``bin_tiles(y0=…)`` or ``interleave_bins``).
Every plane is evaluated at the global pixel centre, so a band's values
are the full raster's bit for bit.  A call with band operands counts its
launch under the wrapper's name + ``_band``.

Wireframe coverage keeps a pixel when it passes the five-plane coverage
and its centre lies within ``wire_thresh`` pixels of the nearest edge,
d = (a·X + c)·g + (b·Y)·g with g = 1/sqrt(a² + b² + 1e-30), the order of
the reference kernel (raster_pallas.py:491-518); a NaN distance covers
nothing (the minimum over the edges is ``torch.minimum``'s, as the
reference's is ``jnp.minimum``'s).

Occlusion skip (the Pallas kernels' O1): where the bins carry the
chunks' depth bounds (``ChunkBins.bound``, from ``bin_tiles(occ_bound=)``,
whose lists then come nearest first), the kernels skip the chunks and
drop the hits that lie behind what their tile has resolved
(csrc/raster_common.cuh); the outputs are those without the skip bit for
bit.  ``occ_on`` resolves ``RenderConfig.occ_scope`` (and ``KANI_OCC``)
to whether a raster takes it.  A wrapper given ``counts`` (a (4,) int64
tensor on the card) launches the counting build of its kernel and adds
to it the kernel's own count of chunks tested and skipped, warp visits
of hits and hits dropped by the depth test (``OCC_COUNTS``; without the
skip only the visits); ops/occ_replay replays the same rule.  Without
``counts`` the build that counts nothing runs, and without bounds the
build without the skip: both are separate instantiations.  The plain
versions never skip: they are the oracle the skip is held against, and
leave ``counts`` as it is.

The kernels are built at first use with ``nvcc`` for sm_90a, one compiler
process per source started together, into one shared library with a plain
C interface under ``_build/`` (listed in .gitignore), named by a hash of
the sources, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from kanirenderer_tpu_torch.core.types import CHUNK_SIZE, RenderConfig
from kanirenderer_tpu_torch.ops.binning import (ChunkBins, bin_tiles,
                                                depth_bound)
from kanirenderer_tpu_torch.ops.interpolate import (FAT_LANES, LSUM0, PAR0,
                                                    REC0, PixelBuffer)
from kanirenderer_tpu_torch.ops.raster_xla import VisBuffer
from kanirenderer_tpu_torch.ops.vertex import NS, USED, TriangleSetup

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

# Kernel launches since the last reset, by wrapper name; "shade_forward"
# counts ops/shade_cuda.shade_surface, the one kernel of the library that
# is not a raster.
launch_counts = {"rasterize_depth": 0, "rasterize_pixels": 0,
                 "rasterize_pixels_wireframe": 0, "rasterize_visibility": 0,
                 "rasterize_depth_band": 0, "rasterize_pixels_band": 0,
                 "rasterize_pixels_wireframe_band": 0, "shade_forward": 0}

_lib = None
build_info: dict = {}

# The kernels' occlusion counters, in the order of csrc/raster_common.cuh
# OccCount.
OCC_COUNTS = ("chunks_tested", "chunks_skipped", "visits", "hits_dropped")


def occ_on(scope: str, depth_only: bool) -> bool:
    """Whether a raster takes the occlusion skip under ``scope``
    (RenderConfig.occ_scope; counterpart of ``_occ_on``,
    kanirenderer_tpu/ops/raster_pallas.py:702-726): "env" defers to
    ``KANI_OCC`` (default "shadow"); "auto" unresolved (the caller skipped
    the gate, api.run) is "shadow"; "shadow" the depth-only rasters (K1),
    "1" every raster, "0" none."""
    mode = os.environ.get("KANI_OCC", "shadow") if scope == "env" else scope
    if mode == "auto":
        mode = "shadow"
    if mode not in ("0", "shadow", "1"):
        raise ValueError(f"occlusion scope {mode!r}: not 0, shadow, 1 or "
                         "auto")
    return mode == "1" or (mode == "shadow" and depth_only)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _build() -> Path:
    """Compile every csrc/*.cu to an object, one nvcc process per source,
    all started together, and link them into one shared library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    lib = BUILD_DIR / f"libkani_raster_{digest.hexdigest()[:16]}.so"
    build_info["library"] = str(lib)
    if lib.exists():
        build_info.update(seconds=0.0, cached=True)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    logs = []
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
        logs.append(err)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas="".join(logs))
    return lib


def load_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kani_rasterize_depth.argtypes = \
            [ptr] * 4 + [i32, ptr] + [i32] * 7 + [ptr] * 3
        lib.kani_rasterize_pixels.argtypes = \
            [ptr] * 9 + [i32] * 9 + [ptr] * 3
        lib.kani_rasterize_pixels_wireframe.argtypes = \
            [ptr] * 9 + [i32] * 9 + [f32] + [ptr] * 3
        lib.kani_rasterize_visibility.argtypes = \
            [ptr] * 8 + [i32] * 7 + [f32] + [ptr] * 3
        for fn in (lib.kani_rasterize_depth, lib.kani_rasterize_pixels,
                   lib.kani_rasterize_pixels_wireframe,
                   lib.kani_rasterize_visibility):
            fn.restype = i32
        _lib = lib
    return _lib


def _check(t: Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_launch(rows: Tensor, lanes: int, bbox: Tensor, bins: ChunkBins,
                  width: int, height: int) -> None:
    dev = rows.device
    T = rows.shape[0]
    if T % CHUNK_SIZE:
        raise ValueError("triangle count must be a multiple of CHUNK_SIZE")
    _check(rows, "rows", (T, lanes), torch.float32, dev)
    _check(bbox, "bbox", (T, 4), torch.float32, dev)
    nt = bins.tiles_x * bins.tiles_y
    _check(bins.start, "bins.start", (nt,), torch.int32, dev)
    _check(bins.count, "bins.count", (nt,), torch.int32, dev)
    _check(bins.chunk, "bins.chunk", bins.chunk.shape, torch.int32, dev)
    _check(bins.pair_tile, "bins.pair_tile", bins.chunk.shape, torch.int32,
           dev)
    block = bins.tile_w * bins.tile_h
    if block % 32 or not 128 <= block <= 1024:
        raise ValueError(f"tile {bins.tile_w}x{bins.tile_h}: the block "
                         "size must be a multiple of 32 in [128, 1024]")
    if (bins.tiles_x * bins.tile_w < width
            or bins.tiles_y * bins.tile_h < height):
        raise ValueError("bins do not cover the raster")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _occ_args(bins: ChunkBins, blocks: int, counts: Tensor | None):
    """(bound pointer, counts pointer, per-block scratch or None) for a
    launch of ``blocks`` blocks; null pointers where there is no bound or
    no ``counts``."""
    bound = 0
    if bins.bound is not None:
        C = bins.bound.shape[0]
        _check(bins.bound, "bins.bound", (C,), torch.float32,
               bins.chunk.device)
        bound = bins.bound.data_ptr()
    if counts is None:
        return bound, 0, None
    _check(counts, "counts", (len(OCC_COUNTS),), torch.int64,
           bins.chunk.device)
    scratch = torch.empty((max(blocks, 1), len(OCC_COUNTS)),
                          dtype=torch.int32, device=counts.device)
    return bound, scratch.data_ptr(), scratch


def _add_counts(counts: Tensor | None, scratch: Tensor | None,
                blocks: int) -> None:
    if counts is not None and blocks > 0:
        counts += scratch.sum(0, dtype=torch.int64)


def band_entries(bins: ChunkBins, bands) -> list:
    """For each (y0, band_h) of ``bands``, [e0, e1): the run of bin
    entries of the tile rows that meet rows [y0, y0 + band_h).  Entries
    are sorted by tile and tiles are numbered row-major, so the run starts
    at the first tile of its first row; the last tile row's run ends at
    the last entry with a chunk (the padding after it is left out).  The
    bounds of all the bands are read back in one synchronisation."""
    tiles = []
    for y0, band_h in bands:
        r1 = min(-(-(y0 + band_h) // bins.tile_h), bins.tiles_y)
        tiles += [y0 // bins.tile_h * bins.tiles_x, r1 * bins.tiles_x]
    end = (bins.chunk >= 0).sum().to(bins.start.dtype).reshape(1)
    at = torch.cat([bins.start, end])[tiles].tolist()
    return list(zip(at[0::2], at[1::2]))


def rasterize_depth(setup: Tensor, bbox: Tensor, bins: ChunkBins, dim: int,
                    y0: int = 0, band_h: int | None = None,
                    entries: tuple | None = None,
                    counts: Tensor | None = None) -> Tensor:
    """K1: (dim, dim) depth map, the minimum covered depth, 1.0 where
    nothing covers.  ``setup``/``bbox``: (T, 16)/(T, 4) f32 from
    ops/vertex.TriangleSetup.  With ``band_h``: map rows [y0, y0 + band_h)
    only, a (band_h, dim) band of the same map, from the full map's
    ``bins``; ``entries``: the band's ``band_entries``, where the caller
    has them (without, the wrapper reads them back).  The occlusion skip
    and ``counts``: module docstring."""
    band_h = dim if band_h is None else band_h
    if setup.device.type == "cpu":
        return rasterize_depth_plain(setup, bbox, bins, dim, y0, band_h)
    _check_launch(setup, NS, bbox, bins, dim, dim)
    if not 0 <= y0 < y0 + band_h <= dim:
        raise ValueError(f"rows [{y0}, {y0 + band_h}) are not in the map")
    lib = load_kernels()
    # The kernel merges into a cleared map with atomicMin.
    out = torch.ones((band_h, dim), dtype=torch.float32, device=setup.device)
    whole = band_h == dim
    if entries is None:
        entries = (0, bins.chunk.shape[0]) if whole \
            else band_entries(bins, [(y0, band_h)])[0]
    e0, e1 = entries
    blocks = -(-(e1 - e0) // 8)       # csrc/raster_depth.cu kSlice
    bound, cptr, scratch = _occ_args(bins, blocks, counts)
    err = lib.kani_rasterize_depth(
        setup.data_ptr(), bbox.data_ptr(), bins.pair_tile[e0:].data_ptr(),
        bins.chunk[e0:].data_ptr(), e1 - e0, out.data_ptr(), dim, dim, y0,
        band_h, bins.tiles_x, bins.tile_w, bins.tile_h, bound, cptr,
        _stream())
    name = "rasterize_depth" if whole else "rasterize_depth_band"
    launch_counts[name] += 1
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _add_counts(counts, scratch, blocks)
    return out


def rasterize_pixels(records: Tensor, setup: Tensor, bbox: Tensor,
                     bins: ChunkBins, width: int, height: int,
                     wireframe: bool = False, wire_thresh: float = 0.7,
                     y0: int = 0, y_stride: int = 1,
                     band_h: int | None = None,
                     counts: Tensor | None = None) -> PixelBuffer:
    """K2 (K2w with ``wireframe``): visibility + interpolation →
    PixelBuffer (with ``tid``).  ``records``: (T, 76) f32 from
    ops/interpolate.build_tri_records_corners; ``setup``/``bbox``: the
    (T, 16)/(T, 4) f32 rows of the same triangles' TriangleSetup (the
    visibility phase reads its planes from ``setup``, whose lanes 0:12
    equal the records').  With ``band_h``: the band_h rows of a row band
    of the width × height frame (module docstring), from the band's
    ``bins``.  The occlusion skip and ``counts``: module docstring."""
    band_h = height if band_h is None else band_h
    if records.device.type == "cpu":
        return rasterize_pixels_plain(records, setup, bbox, bins, width,
                                      height, wireframe, wire_thresh, y0,
                                      y_stride, band_h)
    _check_launch(records, FAT_LANES, bbox, bins, width, band_h)
    _check(setup, "setup", (records.shape[0], NS), torch.float32,
           records.device)
    if y0 < 0 or y_stride < 1:
        raise ValueError(f"band y0 {y0}, y_stride {y_stride}")
    lib = load_kernels()
    dev = records.device
    z = torch.empty((band_h, width), dtype=torch.float32, device=dev)
    vary = torch.empty((USED, band_h, width), dtype=torch.float32, device=dev)
    ints = torch.empty((6, band_h, width), dtype=torch.int32, device=dev)
    blocks = bins.tiles_x * bins.tiles_y
    bound, cptr, scratch = _occ_args(bins, blocks, counts)
    args = [*(t.data_ptr() for t in (records, setup, bbox, bins.start,
                                      bins.count, bins.chunk, z, vary, ints)),
            width, height, band_h, y0, y_stride, bins.tiles_x, blocks,
            bins.tile_w, bins.tile_h]
    if wireframe:
        name = "rasterize_pixels_wireframe"
        err = lib.kani_rasterize_pixels_wireframe(*args, wire_thresh, bound,
                                                  cptr, _stream())
    else:
        name = "rasterize_pixels"
        err = lib.kani_rasterize_pixels(*args, bound, cptr, _stream())
    if (y0, y_stride, band_h) != (0, 1, height):
        name += "_band"
    launch_counts[name] += 1
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _add_counts(counts, scratch, blocks)
    return _pixel_buffer(z, vary, ints, bins)


def rasterize(setup: Tensor, bbox: Tensor, bins: ChunkBins, width: int,
              height: int, wireframe: bool = False,
              wire_thresh: float = 0.7,
              counts: Tensor | None = None) -> VisBuffer:
    """K3: visibility buffer (triangle id, depth, barycentrics) of the
    (T, 16) setup rows from ops/vertex.TriangleSetup.  The occlusion skip
    and ``counts``: module docstring."""
    if setup.device.type == "cpu":
        return rasterize_plain(setup, bbox, bins, width, height, wireframe,
                               wire_thresh)
    _check_launch(setup, NS, bbox, bins, width, height)
    lib = load_kernels()
    dev = setup.device
    tri = torch.empty((height, width), dtype=torch.int32, device=dev)
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    bary = torch.empty((height, width, 2), dtype=torch.float32, device=dev)
    blocks = bins.tiles_x * bins.tiles_y
    bound, cptr, scratch = _occ_args(bins, blocks, counts)
    err = lib.kani_rasterize_visibility(
        *(t.data_ptr() for t in (setup, bbox, bins.start, bins.count,
                                 bins.chunk, tri, z, bary)),
        width, height, bins.tiles_x, blocks, bins.tile_w, bins.tile_h,
        int(wireframe), wire_thresh, bound, cptr, _stream())
    launch_counts["rasterize_visibility"] += 1
    if err:
        raise RuntimeError(
            f"rasterize_visibility launch failed: CUDA error {err}")
    _add_counts(counts, scratch, blocks)
    return VisBuffer(tri=tri, z=z, bary=bary)


def rasterize_config(st: TriangleSetup, config: RenderConfig,
                     wireframe: bool = False) -> VisBuffer:
    """Bin ``st`` on the main view's tile grid and rasterize it with K3,
    as ``raster_pallas.rasterize(st, config, wireframe)``, with the
    occlusion skip where ``config.occ_scope`` turns it on."""
    cfg = config
    bound = depth_bound(st.setup, st.bbox, cfg.tile_w, cfg.tile_h) \
        if occ_on(cfg.occ_scope, depth_only=False) else None
    bins = bin_tiles(st.bbox, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h,
                     cfg.max_chunks_per_tile, occ_bound=bound)
    return rasterize(st.setup, st.bbox, bins, cfg.width, cfg.height,
                     wireframe, cfg.wire_thresh_px)


def _pixel_buffer(z, vary, ints, bins) -> PixelBuffer:
    return PixelBuffer(varyings=vary, mat_id=ints[0], tex_w=ints[1],
                       tex_h=ints[2], blk_base=ints[3], blk_w=ints[4],
                       mask=ints[5] >= 0, z=z, overflow=bins.overflow,
                       tid=ints[5])


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  They walk the binned (tile, chunk) pairs in
# batches: every triangle of the pair's chunk against every pixel of the
# pair's tile, the triangles whose bbox misses the tile masked out exactly
# as the kernels skip them.  They read the per-tile ``start``/``count`` of
# the bins and never ``pair_tile``.  Memory per batch ≈ 40 bytes ·
# PAIR_BATCH · CHUNK_SIZE · tile pixels (≈ 0.7 GB with 16×16 tiles).

PAIR_BATCH = 512


def _pairs(bins: ChunkBins):
    """(tile, chunk) int64 index pairs of every kept bin entry."""
    dev = bins.chunk.device
    count = bins.count.to(torch.int64)
    tile = torch.repeat_interleave(
        torch.arange(count.shape[0], device=dev), count)
    first = torch.cumsum(count, 0) - count
    pos = torch.arange(tile.shape[0], device=dev) - first[tile]
    chunk = bins.chunk.to(torch.int64)[bins.start.to(torch.int64)[tile] + pos]
    return tile, chunk


def _tile_origin(tile: Tensor, bins: ChunkBins, y0: int, y_stride: int):
    """Global (x, y) of each tile's first pixel: the bins' tile row j is
    global rows y0 + j·y_stride·tile_h onwards."""
    return (tile % bins.tiles_x * bins.tile_w,
            y0 + tile // bins.tiles_x * (y_stride * bins.tile_h))


def _bbox_hits(bbox: Tensor, tile: Tensor, chunk: Tensor, bins: ChunkBins,
               y0: int = 0, y_stride: int = 1):
    """(triangle ids (P, 128), hit (P, 128)): the triangles of each pair's
    chunk and whether their bbox meets the pair's tile, the kernels' cull."""
    tw, th = bins.tile_w, bins.tile_h
    tri = chunk[:, None] * CHUNK_SIZE \
        + torch.arange(CHUNK_SIZE, device=bbox.device)
    b = bbox[tri]
    tx0, ty0 = (o.to(torch.float32)[:, None]
                for o in _tile_origin(tile, bins, y0, y_stride))
    return tri, (b[..., 0] < tx0 + tw) & (b[..., 2] > tx0) \
        & (b[..., 1] < ty0 + th) & (b[..., 3] > ty0)


def _eval_pairs(rows: Tensor, bbox: Tensor, tile: Tensor, chunk: Tensor,
                bins: ChunkBins, width: int, height: int,
                wire_thresh: float | None = None, y0: int = 0,
                y_stride: int = 1, out_y0: int = 0,
                out_h: int | None = None):
    """Coverage and depth of every triangle of each pair's chunk at every
    pixel of its tile → (covered (P,128,px), z (P,128,px), pixel (P,px)),
    pixel = row-major index into the output of rows [out_y0, out_y0 +
    out_h) of the bins' grid (default: all ``height``), or width·out_h
    outside it or outside the width × height raster.  The grid's tile row
    j lies at global rows y0 + j·y_stride·tile_h (``_tile_origin``), where
    the planes are evaluated.  With ``wire_thresh``, coverage is the
    wireframe one."""
    dev = rows.device
    tw, th = bins.tile_w, bins.tile_h
    out_h = height if out_h is None else out_h
    lpix = torch.arange(tw * th, device=dev)
    tx0, ty0 = _tile_origin(tile, bins, y0, y_stride)
    x = tx0[:, None] + lpix % tw
    y = ty0[:, None] + lpix // tw
    row = (tile // bins.tiles_x * th - out_y0)[:, None] + lpix // tw
    X = (x.to(torch.float32) + 0.5)[:, None, :]
    Y = (y.to(torch.float32) + 0.5)[:, None, :]
    tri, hit = _bbox_hits(bbox, tile, chunk, bins, y0, y_stride)
    r = rows[:, :12][tri]                                 # (P, 128, 12)

    def plane(k):  # (a·X + c) + b·Y, the kernels' order
        return (r[..., k, None] * X + r[..., k + 2, None]) \
            + r[..., k + 1, None] * Y

    l0, l1, l2, z = plane(0), plane(3), plane(6), plane(9)
    covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0) \
        & (1.0 - z >= 0) & hit[..., None]
    if wire_thresh is not None:
        def dist(k):  # (a·X + c)·g + (b·Y)·g, raster_common.cuh edge_dist
            a, bb = r[..., k], r[..., k + 1]
            g = (1.0 / torch.sqrt(a * a + bb * bb + 1e-30))[..., None]
            return (a[..., None] * X + r[..., k + 2, None]) * g \
                + (bb[..., None] * Y) * g

        d = torch.minimum(torch.minimum(dist(0), dist(3)), dist(6))
        covered &= d <= wire_thresh
    inside = (x < width) & (y < height) & (row >= 0) & (row < out_h)
    pixel = torch.where(inside, row * width + x, width * out_h)
    return covered, z, pixel


def rasterize_depth_plain(setup: Tensor, bbox: Tensor, bins: ChunkBins,
                          dim: int, y0: int = 0,
                          band_h: int | None = None) -> Tensor:
    """Plain PyTorch K1 (same inputs and result as ``rasterize_depth``)."""
    band_h = dim if band_h is None else band_h
    out = torch.ones(band_h * dim + 1, dtype=torch.float32,
                     device=setup.device)
    tile, chunk = _pairs(bins)
    ty0 = tile // bins.tiles_x * bins.tile_h
    meets = (ty0 < y0 + band_h) & (ty0 + bins.tile_h > y0)
    tile, chunk = tile[meets], chunk[meets]
    for s in range(0, tile.shape[0], PAIR_BATCH):
        cov, z, pix = _eval_pairs(setup, bbox, tile[s:s + PAIR_BATCH],
                                  chunk[s:s + PAIR_BATCH], bins, dim, dim,
                                  out_y0=y0, out_h=band_h)
        zc = torch.where(cov, z, 1.0).amin(1)
        out.scatter_reduce_(0, pix.reshape(-1), zc.reshape(-1), "amin")
    return out[:-1].reshape(band_h, dim)


def _tournament(rows: Tensor, bbox: Tensor, bins: ChunkBins, width: int,
                height: int, wire_thresh: float | None, y0: int = 0,
                y_stride: int = 1, band_h: int | None = None):
    """Phase 1 of K2/K3: per pixel the lexicographic min of (z, triangle
    id) over candidates with z < 1 → (tid, z), each (band_h·W,), −1 and
    1.0 where nothing wins.  Each pair reduces its chunk to (z, lowest id
    at that z), then the pixel minimum of z is scattered and the lowest id
    among the pairs that reach it — the strict-< ascending tournament of
    the kernels."""
    dev = rows.device
    band_h = height if band_h is None else band_h
    hw = width * band_h
    tile, chunk = _pairs(bins)
    zbuf = torch.ones(hw + 1, dtype=torch.float32, device=dev)
    kept = []
    lane = torch.arange(CHUNK_SIZE, device=dev)[None, :, None]
    for s in range(0, tile.shape[0], PAIR_BATCH):
        ch = chunk[s:s + PAIR_BATCH]
        cov, z, pix = _eval_pairs(rows, bbox, tile[s:s + PAIR_BATCH], ch,
                                  bins, width, height, wire_thresh, y0,
                                  y_stride, out_h=band_h)
        zc = torch.where(cov & (z < 1.0), z, 2.0)
        pz = zc.amin(1)
        k = torch.where(zc == pz[:, None], lane, CHUNK_SIZE).amin(1)
        pid = (ch[:, None] * CHUNK_SIZE + k).to(torch.int32)
        zbuf.scatter_reduce_(0, pix.reshape(-1), pz.reshape(-1), "amin")
        kept.append((pz, pid, pix))
    big = torch.iinfo(torch.int32).max
    tbuf = torch.full((hw + 1,), big, dtype=torch.int32, device=dev)
    for pz, pid, pix in kept:
        cand = torch.where((pz < 1.0) & (pz == zbuf[pix]), pid, big)
        tbuf.scatter_reduce_(0, pix.reshape(-1), cand.reshape(-1), "amin")
    tid = torch.where(tbuf[:-1] == big, -1, tbuf[:-1])
    return tid, zbuf[:-1]


def _pixel_centres(width: int, height: int, device, y0: int = 0,
                   y_stride: int = 1, tile_h: int = 1):
    """Global pixel centres of the rows of a band: row r is global row
    y0 + (r // tile_h)·y_stride·tile_h + r % tile_h."""
    p = torch.arange(width * height, device=device)
    X = (p % width).to(torch.float32) + 0.5
    r = torch.div(p, width, rounding_mode="floor")
    y = y0 + r // tile_h * (y_stride * tile_h) + r % tile_h
    return X, y.to(torch.float32) + 0.5


def rasterize_pixels_plain(records: Tensor, setup: Tensor, bbox: Tensor,
                           bins: ChunkBins, width: int, height: int,
                           wireframe: bool = False, wire_thresh: float = 0.7,
                           y0: int = 0, y_stride: int = 1,
                           band_h: int | None = None) -> PixelBuffer:
    """Plain PyTorch K2/K2w (same inputs and result as
    ``rasterize_pixels``): the phase-1 tournament on the setup rows, then
    phase 2 on the records."""
    dev = records.device
    band_h = height if band_h is None else band_h
    tid, z_out = _tournament(setup, bbox, bins, width, height,
                             wire_thresh if wireframe else None, y0,
                             y_stride, band_h)

    # Phase 2: interpolate the winner's record at the pixel centre.
    covered = tid >= 0
    rec = records[tid.clamp(min=0).to(torch.int64)]        # (HW, 76)
    X, Y = _pixel_centres(width, band_h, dev, y0, y_stride, bins.tile_h)

    def plane(k):  # ((a·X) + (b·Y)) + c, the reference's phase-2 order
        return (rec[:, k] * X + rec[:, k + 1] * Y) + rec[:, k + 2]

    l1, l2, lsum = plane(3), plane(6), plane(LSUM0)
    lsafe = torch.where(lsum != 0.0, lsum, 1e-30)
    w1 = (l1 / lsafe)[:, None]
    w2 = (l2 / lsafe)[:, None]
    vary = (rec[:, REC0:REC0 + USED] + rec[:, REC0 + USED:REC0 + 2 * USED]
            * w1) + rec[:, REC0 + 2 * USED:REC0 + 3 * USED] * w2
    vary = torch.where(covered[:, None], vary, 0.0)
    par = rec[:, PAR0:PAR0 + 6].to(torch.int32)
    ints = torch.stack([par[:, 0], par[:, 1], par[:, 2],
                        par[:, 3] * 65536 + par[:, 4], par[:, 5]])
    default = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32,
                           device=dev)[:, None]
    ints = torch.cat([torch.where(covered, ints, default), tid[None]])
    return _pixel_buffer(z_out.reshape(band_h, width),
                         vary.T.reshape(USED, band_h, width),
                         ints.reshape(6, band_h, width), bins)


def rasterize_plain(setup: Tensor, bbox: Tensor, bins: ChunkBins, width: int,
                    height: int, wireframe: bool = False,
                    wire_thresh: float = 0.7) -> VisBuffer:
    """Plain PyTorch K3 (same inputs and result as ``rasterize``): the
    phase-1 tournament, then the winner's barycentrics from its phase-1
    plane values, lsum = (l0 + l1) + l2 (raster_pallas.py:557-566)."""
    tid, z = _tournament(setup, bbox, bins, width, height,
                         wire_thresh if wireframe else None)
    r = setup[tid.clamp(min=0).to(torch.int64)]            # (HW, 16)
    X, Y = _pixel_centres(width, height, setup.device)

    def plane(k):  # (a·X + c) + b·Y, the kernels' order
        return (r[:, k] * X + r[:, k + 2]) + r[:, k + 1] * Y

    l0, l1, l2 = plane(0), plane(3), plane(6)
    lsum = (l0 + l1) + l2
    lsafe = torch.where(lsum != 0.0, lsum, 1e-30)
    bary = torch.stack([l1 / lsafe, l2 / lsafe], -1)
    bary = torch.where((tid >= 0)[:, None], bary, 0.0)
    return VisBuffer(tri=tid.reshape(height, width),
                     z=z.reshape(height, width),
                     bary=bary.reshape(height, width, 2))
