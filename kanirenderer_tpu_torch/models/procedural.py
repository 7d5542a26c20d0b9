"""Procedural scenes (counterpart of
``kanirenderer_tpu/models/procedural.py``): the default cube, the
sponza-scale stand-in and the layered occlusion scene.

The reference ships ``res/cube.obj`` (12 triangles, one untextured
material) and benchmarks against ``res/sponza.obj``.  ``cube_scene``
builds the same class of asset through the OBJ parser;
``sponza_standin_scene`` is an architectural scene matched to sponza's
workload — about 262K triangles, 25 textured materials, 256² textures —
and ``layered_scene`` stacks screen-filling walls in depth.  The last two
are built from arrays, with no file IO.  The same arguments give the same
scene, array for array, as the JAX package's scene packing on its numpy
paths.
"""

from __future__ import annotations

import numpy as np

from kanirenderer_tpu_torch.core.types import Scene
from kanirenderer_tpu_torch.io import obj as obj_mod
from kanirenderer_tpu_torch.io.scene_loader import (MaterialTextures,
                                                    SceneBuilder, compute_tbn)


def make_cube_obj(half: float = 25.0) -> str:
    """OBJ text for an axis-aligned cube — one coherently-unwrapped quad per
    face (CCW outward winding, unit-square UVs per face, so the generated
    tangent frames are orthonormal) — the same class of asset as
    res/cube.obj."""
    h = half
    # per-face: (normal, four CCW corners seen from outside)
    faces = [
        ((0, 0, 1), [(-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h)]),
        ((0, 0, -1), [(h, -h, -h), (-h, -h, -h), (-h, h, -h), (h, h, -h)]),
        ((1, 0, 0), [(h, -h, h), (h, -h, -h), (h, h, -h), (h, h, h)]),
        ((-1, 0, 0), [(-h, -h, -h), (-h, -h, h), (-h, h, h), (-h, h, -h)]),
        ((0, 1, 0), [(-h, h, h), (h, h, h), (h, h, -h), (-h, h, -h)]),
        ((0, -1, 0), [(-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)]),
    ]
    uvs = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    lines = ["o Cube", "mtllib none.mtl"]
    for _, corners in faces:
        for v in corners:
            lines.append(f"v {v[0]} {v[1]} {v[2]}")
    for n, _ in faces:
        lines.append(f"vn {n[0]} {n[1]} {n[2]}")
    for u in uvs:
        lines.append(f"vt {u[0]} {u[1]}")
    lines.append("usemtl Material")
    for fi in range(6):
        base = fi * 4 + 1
        ids = [(base + k, k + 1, fi + 1) for k in range(4)]
        for tri in ((0, 1, 2), (0, 2, 3)):
            lines.append("f " + " ".join(
                f"{ids[k][0]}/{ids[k][1]}/{ids[k][2]}" for k in tri))
    return "\n".join(lines) + "\n"


def cube_scene(instances: int = 1, device="cuda") -> Scene:
    """The default cube — reference ``load_default_cube``
    (src/resources.rs:296-303): an untextured material, so the default
    normal image stands in for both its diffuse and its normal map."""
    parsed = obj_mod.parse_obj(make_cube_obj(), mtl_loader=lambda p: None)
    b = SceneBuilder()
    b.add_model(parsed, tex_dir=".", file_type="opengl", instances=instances,
                rng=np.random.RandomState(0))
    return b.build(device)


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


def _add_patches(b: SceneBuilder, positions, uvs, normals, tris,
                 mats) -> None:
    """Append the patches as one object at the origin, each triangle
    keeping its patch's material."""
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


def layered_parts(layers: int = 4, target_tris: int = 260_000,
                  tex_size: int = 256, seed: int = 7):
    """The layered scene's host arrays, (textures, patches) as
    ``standin_parts`` gives them: one wall per patch and material."""
    rng = np.random.RandomState(seed)
    textures = []
    for i in range(layers):
        col_a = rng.randint(60, 255, 3)
        col_b = (col_a * 0.5).astype(np.int64)
        textures.append(MaterialTextures(
            name=f"layer_{i}",
            diffuse=_checker_texture(tex_size, col_a, col_b, tiles=8),
            normal=_noise_normal_texture(tex_size, rng)))

    per_layer = max(1, target_tris // (2 * layers))
    nu = max(1, int(np.sqrt(per_layer)))
    nv = max(1, per_layer // nu)
    patches = []
    vbase = 0
    for k in range(layers):
        z = -200.0 - 200.0 * k
        # Each wall fills the frustum slab at its depth (fovy 45°, the
        # −20° pitch shifts the view centre down) with a 1.4× margin.
        dist = 10.0 - z
        hh = dist * np.tan(np.deg2rad(22.5)) * 1.4
        hw = hh * (1920.0 / 1080.0)
        cy = 5.0 - dist * np.tan(np.deg2rad(20.0))
        p, u, n, t = _grid_quads((-hw, cy + hh, z), (2 * hw, 0, 0),
                                 (0, -2 * hh, 0), nu, nv, vbase)
        patches.append((p, u, n, t, np.full(len(t), k % layers, np.int32)))
        vbase += len(p)
    return textures, patches


def layered_scene(layers: int = 4, target_tris: int = 260_000,
                  tex_size: int = 256, seed: int = 7,
                  device="cuda") -> Scene:
    """Occlusion-heavy content: ``layers`` parallel screen-filling walls
    stacked in depth in front of the default camera (position (0, 5, 10)
    looking −Z), each subdivided to about target_tris/layers triangles.
    Everything behind the front wall is fully occluded."""
    b = SceneBuilder()
    textures, patches = layered_parts(layers, target_tris, tex_size, seed)
    b.textures.extend(textures)
    _add_patches(b, *zip(*patches))
    return b.build(device)


def standin_parts(target_tris: int = 262_000, num_materials: int = 25,
                  tex_size: int = 256, seed: int = 0):
    """The stand-in's host arrays: (textures, patches).  ``textures``: one
    MaterialTextures per material; ``patches``: per quad patch (positions,
    uvs, normals, triangles with scene-wide vertex indices, material ids
    per triangle).  ``sponza_standin_scene`` packs them; a writer can put
    the same geometry into an OBJ file."""
    rng = np.random.RandomState(seed)
    textures = []
    for i in range(num_materials):
        col_a = rng.randint(60, 255, 3)
        col_b = (col_a * rng.uniform(0.3, 0.8)).astype(np.int64)
        textures.append(MaterialTextures(
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

    patches = []
    vbase = 0
    for i, (o, du, dv) in enumerate(blocks):
        p, u, n, t = _grid_quads(o, du, dv, nu, nv, vbase)
        patches.append((p, u, n, t,
                        np.full(len(t), i % num_materials, np.int32)))
        vbase += len(p)
    return textures, patches


def sponza_standin_scene(target_tris: int = 262_000, num_materials: int = 25,
                         tex_size: int = 256, seed: int = 0,
                         device="cuda") -> Scene:
    """Courtyard with floor, ceiling, walls and 24 columns: about
    ``target_tris`` triangles over ``num_materials`` checker/noise-normal
    materials.  Deterministic in ``seed``."""
    b = SceneBuilder()
    textures, patches = standin_parts(target_tris, num_materials, tex_size,
                                      seed)
    b.textures.extend(textures)
    _add_patches(b, *zip(*patches))
    return b.build(device)
