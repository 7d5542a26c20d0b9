"""The sponza-scale stand-in scene (counterpart of
``kanirenderer_tpu/models/procedural.sponza_standin_scene``).

An architectural scene matched to sponza's workload — about 262K
triangles, 25 textured materials, 256² textures — built from arrays, with
no file IO.  The same seed gives the same scene, array for array, as the
JAX package's scene packing on its numpy paths.
"""

from __future__ import annotations

import numpy as np

from kanirenderer_tpu_torch.core.types import Scene
from kanirenderer_tpu_torch.io.scene_loader import (MaterialTextures,
                                                    SceneBuilder, compute_tbn)


def _checker_texture(size: int, rgb_a, rgb_b, tiles: int = 8) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    m = ((xx * tiles // size + yy * tiles // size) % 2).astype(bool)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.where(m[..., None], rgb_a, rgb_b)
    img[..., 3] = 255
    return img


def _noise_normal_texture(size: int, rng: np.random.RandomState) -> np.ndarray:
    """A plausible tangent-space normal map with mild bumps."""
    h = rng.standard_normal((size, size)).astype(np.float32)
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5.0
    gx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * 2.0
    gy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * 2.0
    n = np.stack([-gx, -gy, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = ((n * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def _grid_quads(origin, du, dv, nu, nv, vbase):
    """Subdivided quad patch: returns (positions, uvs, normals, tris)."""
    origin = np.asarray(origin, np.float32)
    du = np.asarray(du, np.float32)
    dv = np.asarray(dv, np.float32)
    us = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    vs = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    P = origin[None, None] + us[None, :, None] * du + vs[:, None, None] * dv
    pos = P.reshape(-1, 3)
    uu, vv = np.meshgrid(us, vs)
    uv = np.stack([uu, vv], -1).reshape(-1, 2) * 4.0  # tile texture 4x
    n = np.cross(du, dv)
    n = n / max(np.linalg.norm(n), 1e-9)
    nrm = np.tile(n[None], (len(pos), 1)).astype(np.float32)
    idx = np.arange((nu + 1) * (nv + 1)).reshape(nv + 1, nu + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate([
        np.stack([a, c, b], -1),
        np.stack([b, c, d], -1),
    ]).astype(np.int32) + vbase
    return pos, uv, nrm, tris


def sponza_standin_scene(target_tris: int = 262_000, num_materials: int = 25,
                         tex_size: int = 256, seed: int = 0,
                         device="cuda") -> Scene:
    """Courtyard with floor, ceiling, walls and 24 columns: about
    ``target_tris`` triangles over ``num_materials`` checker/noise-normal
    materials.  Deterministic in ``seed``."""
    rng = np.random.RandomState(seed)
    b = SceneBuilder()

    for i in range(num_materials):
        col_a = rng.randint(60, 255, 3)
        col_b = (col_a * rng.uniform(0.3, 0.8)).astype(np.int64)
        b.textures.append(MaterialTextures(
            name=f"standin_{i}",
            diffuse=_checker_texture(tex_size, col_a, col_b,
                                     tiles=int(rng.choice([4, 8, 16]))),
            normal=_noise_normal_texture(tex_size, rng),
        ))

    S = 1200.0    # courtyard half-length
    H = 500.0
    blocks = [
        ((-S, 0, -S / 2), (2 * S, 0, 0), (0, 0, S)),      # floor
        ((-S, H, S / 2), (2 * S, 0, 0), (0, 0, -S)),      # ceiling
        ((-S, 0, -S / 2), (0, H, 0), (2 * S, 0, 0)),      # long walls
        ((S, 0, S / 2), (0, H, 0), (-2 * S, 0, 0)),
        ((S, 0, -S / 2), (0, H, 0), (0, 0, S)),           # end walls
        ((-S, 0, S / 2), (0, H, 0), (0, 0, -S)),
    ]
    ncols = 24
    for k in range(ncols):
        x = -S * 0.85 + (2 * S * 0.85) * (k % (ncols // 2)) / (ncols // 2 - 1)
        z = -S * 0.35 if k < ncols // 2 else S * 0.35
        w = 40.0
        blocks += [
            ((x - w, 0, z - w), (2 * w, 0, 0), (0, H * 0.8, 0)),
            ((x + w, 0, z + w), (-2 * w, 0, 0), (0, H * 0.8, 0)),
            ((x - w, 0, z + w), (0, 0, -2 * w), (0, H * 0.8, 0)),
            ((x + w, 0, z - w), (0, 0, 2 * w), (0, H * 0.8, 0)),
        ]

    per_patch = max(1, target_tris // (2 * len(blocks)))
    nu = max(1, int(np.sqrt(per_patch)))
    nv = max(1, per_patch // nu)

    positions, uvs, normals, tris, mats = [], [], [], [], []
    vbase = 0
    for i, (o, du, dv) in enumerate(blocks):
        p, u, n, t = _grid_quads(o, du, dv, nu, nv, vbase)
        positions.append(p)
        uvs.append(u)
        normals.append(n)
        tris.append(t)
        mats.append(np.full(len(t), i % num_materials, np.int32))
        vbase += len(p)

    pos = np.concatenate(positions)
    tex = np.concatenate(uvs)
    idx = np.concatenate(tris)
    t, bt = compute_tbn(pos, tex, idx)
    b.positions.append(pos)
    b.uvs.append(tex)
    b.normals.append(np.concatenate(normals))
    b.tangents.append(t)
    b.bitangents.append(bt)
    b.vertex_object.append(np.zeros(len(pos), np.int32))
    b.tri_idx.append(idx)
    b.tri_mat.append(np.concatenate(mats))
    b.object_transforms.append(
        (np.zeros(3, np.float32), np.zeros(4, np.float32)))
    return b.build(device)
