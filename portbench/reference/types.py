"""Frozen copy of ``kanirenderer_tpu_torch/core/types.py`` (commit 1e399aa), the
benchmark's plain reference; only its imports were changed.

Core datatypes: scene, camera, lights, render settings (PyTorch).

Counterpart of ``kanirenderer_tpu/core/types.py``.  Dynamic state lives in
NamedTuples of tensors; static settings live in the frozen dataclass
``RenderConfig``.  Every tensor of a Scene or FrameState sits on one device,
which the caller chooses when it builds them.

Scene layout: all meshes are packed into flat arrays, triangles are
Morton-sorted at build time and padded to a multiple of ``CHUNK_SIZE`` so
binning works on chunk-granularity bounding boxes (ops/binning.py).

Every function here that builds tensors from host values places them on
the CUDA device unless the caller names another (``device="cpu"``, as the
tests do).  Without a card such a call fails; it never falls back.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# Triangles per binning chunk (the scene is padded to a multiple of it).
CHUNK_SIZE = 128
# The JAX package's DMA-run length; the port keeps the constant for layout
# parity, its kernels walk single chunks.
RUN_CHUNKS = 4
# Triangles per subbatch: the binner keeps a (tile, chunk) pair when any
# subbatch bounding box of the chunk overlaps the tile.
SUBBATCH = 16
SUBS_PER_CHUNK = CHUNK_SIZE // SUBBATCH
MASK_BITS = SUBS_PER_CHUNK


class RenderMode(enum.IntEnum):
    """Tab-cycled render modes (reference src/lib.rs:65-71)."""

    UNLIT = 0
    LIT = 1
    LIT_SHADOW = 2
    WIREFRAME = 3
    DEBUG = 4

    def next(self) -> "RenderMode":
        return RenderMode((int(self) + 1) % 5)


class DebugTexture(enum.IntEnum):
    SCENE_DEPTH = 0
    SHADOW_MAP = 1


class Scene(NamedTuple):
    """Packed scene, field for field the JAX package's ``Scene``."""

    position: Tensor        # (V, 3) f32
    uv: Tensor              # (V, 2) f32
    normal: Tensor          # (V, 3) f32
    tangent: Tensor         # (V, 3) f32
    bitangent: Tensor       # (V, 3) f32
    vertex_object: Tensor   # (V,) i32
    tri_idx: Tensor         # (T, 3) i32, Morton-sorted, chunk-padded
    tri_mat: Tensor         # (T,) i32
    tri_valid: Tensor       # (T,) bool, False for padding rows
    object_model: Tensor    # (O, 4, 4) f32
    object_normal: Tensor   # (O, 3, 3) f32
    tex_diffuse: Tensor     # (R, 128) u8 sqrt-encoded diffuse block rows
    tex_normal: Tensor      # (R, 128) u16/f32 normal-map block rows; both
    #                         are (0, 128) u8 where tex_combined serves
    mat_blk_base: Tensor    # (M,) i32 first table row per material
    mat_blk_w: Tensor       # (M,) i32 blocks per texture row
    mat_tex_size: Tensor    # (M, 2) i32 (w, h)
    tex_combined: Tensor    # (R, 128) u8 combined diffuse+normal block rows
    #                         of an all-u8 scene, else (0, 128)
    tri_extra: Tensor       # (6, T) f32 [mat, tex_w, tex_h, hi, lo, blk_w]
    corner_pos: Tensor      # (9, T) f32 rows corner·3 + comp
    corner_uv: Tensor       # (6, T) f32
    corner_normal: Tensor   # (9, T) f32
    corner_tangent: Tensor  # (9, T) f32
    corner_bitangent: Tensor  # (9, T) f32
    tri_object: Tensor      # (T,) i32

    @property
    def device(self) -> torch.device:
        return self.position.device


class CameraState(NamedTuple):
    position: Tensor  # (3,) f32
    yaw: Tensor       # () f32 radians
    pitch: Tensor     # () f32 radians


class MovableLight(NamedTuple):
    position: Tensor  # (3,)
    color: Tensor     # (3,)
    range: Tensor     # ()
    yaw: Tensor       # ()


class PointLights(NamedTuple):
    position: Tensor  # (P, 3)
    color: Tensor     # (P, 3)
    range: Tensor     # (P,)


class DirectionalLight(NamedTuple):
    color: Tensor             # (3,)
    direction: Tensor         # (3,)
    distance: Tensor          # ()
    intensity: Tensor         # ()
    shadow_scene_size: Tensor  # ()


class Lights(NamedTuple):
    movable: MovableLight
    points: PointLights
    directional: DirectionalLight


class FrameState(NamedTuple):
    camera: CameraState
    lights: Lights
    object_model: Tensor   # (O, 4, 4)
    object_normal: Tensor  # (O, 3, 3)
    frame_times_ms: Tensor  # (256,)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings; the fields of the JAX package's RenderConfig.

    The port reads width, height, mode, hdr, fovy_deg, znear, zfar,
    shadow_dim, the shadow biases, clear_color, debug_texture, deferred,
    output_u8, present_scale, wire_thresh_px, tile_w/tile_h/shadow_tile_h
    (one CUDA block per tile, one thread per pixel, so tile_w·tile_h is
    the block size) and the per-tile chunk caps max_chunks_per_tile /
    shadow_chunks_per_tile, and occ_scope, the occlusion skip's scope
    (ops/raster_cuda.occ_on): "env" defers to KANI_OCC (default
    "shadow": the depth-only shadow raster skips), "0" | "shadow" | "1"
    override it; api.run sets it from KANI_OCC, and KANI_OCC=auto picks
    "1" or "shadow" at load (ops/occ_replay.choose_occ_scope).  Every
    scope renders the same pixels.  cache_shadow_map is read by the
    interactive loop (runtime/loop.py), which then reuses the PCF table
    while the sun and the geometry stand still; ``render_frame`` itself renders what its
    arguments say.  The remaining fields tune the TPU path and are carried
    only so a configuration reads the same in both packages.
    """

    width: int = 1440
    height: int = 1080
    mode: RenderMode = RenderMode.LIT_SHADOW
    hdr: bool = False
    fovy_deg: float = 45.0
    znear: float = 0.1
    zfar: float = 10000.0
    shadow_dim: int = 2048
    shadow_bias_constant: float = 2.0
    shadow_bias_slope: float = 2.0
    clear_color: tuple = (0.1, 0.2, 0.3)
    debug_texture: DebugTexture = DebugTexture.SCENE_DEPTH
    raster_backend: str = "cuda"
    tile_h: int = 16
    tile_w: int = 16
    max_tiles_per_chunk: int = 64
    max_chunks_per_tile: int = 640
    max_global_chunks: int = 128
    shadow_chunks_per_tile: int = 640
    shadow_tile_h: int = 16
    cache_shadow_map: bool = True
    deferred: bool = False
    output_u8: bool = False
    present_scale: int = 1
    occ_scope: str = "env"
    wire_thresh_px: float = 0.7
    raster_tri_batch: int = 8

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def _f32(x, device) -> Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def default_lights(num_point_lights: int = 1, device="cuda") -> Lights:
    """Initial light rig (reference src/lib.rs:431-514)."""
    movable = MovableLight(
        position=_f32([0.0, 100.0, 0.0], device),
        color=_f32([20.0, 20.0, 20.0], device),
        range=_f32(256.0, device),
        yaw=_f32(np.deg2rad(np.float32(-90.0)), device),
    )
    points = PointLights(
        position=_f32(np.tile([99999.0, 999999.0, 99999.0],
                              (num_point_lights, 1)), device),
        color=_f32(np.zeros((num_point_lights, 3)), device),
        range=_f32(np.zeros(num_point_lights), device),
    )
    directional = DirectionalLight(
        color=_f32([1.0, 1.0, 1.0], device),
        direction=_f32([0.0, -0.9902682, -0.1391731], device),
        distance=_f32(-2000.0, device),
        intensity=_f32(2.0, device),
        shadow_scene_size=_f32(3000.0, device),
    )
    return Lights(movable=movable, points=points, directional=directional)


def spawn_point_lights(num: int, rng: np.random.RandomState | None = None,
                       device="cuda") -> PointLights:
    """The reference's (disabled) random light spawner
    (src/lib.rs:453-512): slot 0 is the far black dummy light; slots
    1..num-1 are red lights (colour [10, 0, 0], range 256) at random
    positions x, z ∈ [-1000, 1000), y ∈ [10, 15); with num >= 50 a green
    and a blue set of ``num`` lights each are appended, 3·num in all.  The
    draws come from ``rng`` in the order of the JAX package's function, so
    the same ``RandomState`` gives the same lights."""
    rng = rng or np.random.RandomState(0)

    def rand_pos(n):
        p = np.empty((n, 3), np.float32)
        p[:, 0] = rng.uniform(-1000.0, 1000.0, n)
        p[:, 1] = rng.uniform(10.0, 15.0, n)
        p[:, 2] = rng.uniform(-1000.0, 1000.0, n)
        return p

    num = max(int(num), 1)
    pos = rand_pos(num)
    pos[0] = [99999.0, 999999.0, 99999.0]          # the dummy seed light
    col = np.tile(np.array([10.0, 0.0, 0.0], np.float32), (num, 1))
    col[0] = 0.0
    rngs = np.full(num, 256.0, np.float32)
    rngs[0] = 0.0
    if num >= 50:
        pos = np.concatenate([pos, rand_pos(num), rand_pos(num)])
        col = np.concatenate([
            col,
            np.tile(np.array([0.0, 10.0, 0.0], np.float32), (num, 1)),
            np.tile(np.array([0.0, 0.0, 10.0], np.float32), (num, 1))])
        rngs = np.concatenate([rngs, np.full(2 * num, 256.0, np.float32)])
    return PointLights(position=_f32(pos, device), color=_f32(col, device),
                       range=_f32(rngs, device))


def camera_state(position, yaw, pitch, device="cuda") -> CameraState:
    """CameraState from host numbers (numpy or Python floats)."""
    return CameraState(position=_f32(position, device),
                       yaw=_f32(yaw, device), pitch=_f32(pitch, device))


def default_camera(device="cuda") -> CameraState:
    """Initial pose (reference src/lib.rs:382)."""
    return camera_state([0.0, 5.0, 10.0], np.deg2rad(np.float32(-90.0)),
                        np.deg2rad(np.float32(-20.0)), device)


def frame_state(scene: Scene, camera: CameraState, lights: Lights,
                frame_times_ms: Tensor | None = None) -> FrameState:
    if frame_times_ms is None:
        frame_times_ms = torch.zeros(256, dtype=torch.float32,
                                     device=scene.device)
    return FrameState(camera=camera, lights=lights,
                      object_model=scene.object_model,
                      object_normal=scene.object_normal,
                      frame_times_ms=frame_times_ms)


def _to_tensor(x, device) -> Tensor:
    # JAX-backed arrays are read-only: copy before torch.from_numpy.
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def from_reference(obj, device="cuda"):
    """The JAX package's Scene / FrameState / Lights / CameraState (any
    NamedTuple of arrays) as the port's tensors on ``device``.

    The reference object is read through ``numpy.asarray``, so this module
    never imports JAX; field names select the port's NamedTuple.
    """
    kinds = {cls.__name__: cls for cls in (
        Scene, CameraState, MovableLight, PointLights, DirectionalLight,
        Lights, FrameState)}
    cls = kinds[type(obj).__name__]
    vals = {}
    for name in cls._fields:
        v = getattr(obj, name)
        vals[name] = (from_reference(v, device) if hasattr(v, "_fields")
                      else _to_tensor(v, device))
    return cls(**vals)
