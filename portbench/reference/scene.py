"""The scene packing of the plain reference: the stand-in's generated
arrays and the texture files the benchmark wrote → a ``Scene`` of
tensors, as the program's loader packs an OBJ + MTL + PNG scene.

``compute_tbn_plain``, ``morton_order_plain`` and the body of
``pack_scene`` are frozen copies of ``kanirenderer_tpu_torch/io/
scene_loader.py`` (commit 1e399aa: ``compute_tbn_plain``,
``morton_order_plain``, ``SceneBuilder.build``).  What the program's OBJ
parse and texture load do to the files is written out here: one mesh per
patch with its own tangent frames, the "opengl" file type's V-flip of
every texture and green inversion of the normal maps.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import math3d
from portbench.reference.sampling import CMB_BX, build_combined_blocks
from portbench.reference.types import CHUNK_SIZE, Scene


def _srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def compute_tbn_plain(positions: np.ndarray, texcoords: np.ndarray,
                      indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``compute_tbn`` in numpy: per-triangle T/B from UV deltas, summed
    into each corner vertex, divided by the incident-triangle count.
    Degenerate UV triangles contribute zero instead of inf/nan."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    uv0 = texcoords[indices[:, 0]]
    uv1 = texcoords[indices[:, 1]]
    uv2 = texcoords[indices[:, 2]]

    dp1 = v1 - v0
    dp2 = v2 - v0
    du1 = uv1 - uv0
    du2 = uv2 - uv0

    det = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    safe = np.abs(det) > 1e-20
    r = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)[:, None]

    tangent = (dp1 * du2[:, 1:2] - dp2 * du1[:, 1:2]) * r
    bitangent = (dp2 * du1[:, 0:1] - dp1 * du2[:, 0:1]) * (-r)

    vt = np.zeros_like(positions)
    vb = np.zeros_like(positions)
    counts = np.zeros(len(positions), np.float32)
    for corner in range(3):
        idx = indices[:, corner]
        np.add.at(vt, idx, tangent)
        np.add.at(vb, idx, bitangent)
        np.add.at(counts, idx, 1.0)
    denom = 1.0 / np.maximum(counts, 1.0)[:, None]
    return (vt * denom).astype(np.float32), (vb * denom).astype(np.float32)


def morton_order_plain(centroids: np.ndarray, bits: int = 10) -> np.ndarray:
    """Stable sort order of 3D points along a Morton (Z-order) curve."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    scale = np.where(hi > lo, (2 ** bits - 1) / np.maximum(hi - lo, 1e-30), 0.0)
    q = np.clip(((centroids - lo) * scale), 0, 2 ** bits - 1).astype(np.uint64)

    def spread(x: np.ndarray) -> np.ndarray:
        x = x & np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def pack_scene(patches, diffuse_rgb, normal_rgb, device) -> Scene:
    """``patches``: per patch (positions, uvs, normals, triangles with
    scene-wide vertex indices, material id per triangle), as
    ``portbench.scenefiles.standin_geometry`` gives them; ``diffuse_rgb``,
    ``normal_rgb``: per material the (H, W, 3) u8 images of its texture
    files, as stored, all of one size.  Every patch is one OBJ mesh of
    one object at the origin (one instance)."""
    positions, uvs, normals, tangents, bitangents, tri_idxs, tri_mats = \
        [], [], [], [], [], [], []
    vbase = 0
    for pos, uv, nrm, tris, mats in patches:
        t, b = compute_tbn_plain(pos, uv, tris - vbase)
        vbase += len(pos)
        positions.append(pos)
        uvs.append(uv)
        normals.append(nrm)
        tangents.append(t)
        bitangents.append(b)
        tri_idxs.append(tris)
        tri_mats.append(mats)
    vertex_object = [np.zeros(sum(len(p) for p in positions), np.int32)]
    textures = []
    for d, n in zip(diffuse_rgb, normal_rgb):
        n = n[::-1].copy()
        n[..., 1] = 255 - n[..., 1]
        textures.append((d[::-1].copy(), n))
    object_transforms = [(np.zeros(3, np.float32), np.zeros(4, np.float32))]

    def cat(parts, empty):
        return np.concatenate(parts) if parts else empty

    position = cat(positions, np.zeros((1, 3), np.float32))
    uv = cat(uvs, np.zeros((1, 2), np.float32))
    normal = cat(normals, np.zeros((1, 3), np.float32))
    tangent = cat(tangents, np.zeros((1, 3), np.float32))
    bitangent = cat(bitangents, np.zeros((1, 3), np.float32))
    vertex_object = cat(vertex_object, np.zeros(1, np.int32))
    tri_idx = cat(tri_idxs, np.zeros((0, 3), np.int32))
    tri_mat = cat(tri_mats, np.zeros(0, np.int32))

    # Morton-order triangles by centroid for spatially compact chunks.
    if len(tri_idx):
        order = morton_order_plain(position[tri_idx].mean(axis=1))
        tri_idx = tri_idx[order]
        tri_mat = tri_mat[order]

    # Pad the triangle count to a chunk multiple.
    ntris = len(tri_idx)
    pad = (-ntris) % CHUNK_SIZE or (CHUNK_SIZE if ntris == 0 else 0)
    tri_valid = np.ones(ntris + pad, bool)
    if pad:
        tri_idx = np.concatenate([tri_idx, np.zeros((pad, 3), np.int32)])
        tri_mat = np.concatenate([tri_mat, np.zeros(pad, np.int32)])
        tri_valid[ntris:] = False

    # The combined block table of an all-u8 scene.  Diffuse: sRGB u8 →
    # linear → round(sqrt(linear)·255).
    rows, blk_base, blk_w, tex_size = [], [], [], []
    base = 0
    for diffuse, nmap in textures:
        d = _srgb_to_linear_np(diffuse.astype(np.float32) / 255.0)
        d8 = np.round(np.sqrt(np.clip(d, 0.0, 1.0)) * 255.0) \
            .astype(np.uint8)
        h, w = d8.shape[:2]
        rows.append(build_combined_blocks(d8, nmap))
        blk_base.append(base)
        blk_w.append(-(-w // CMB_BX))
        tex_size.append((w, h))
        base += rows[-1].shape[0]
    tex_combined = np.concatenate(rows)
    tex_diffuse = tex_normal = np.zeros((0, 128), np.uint8)
    mat_blk_base = np.asarray(blk_base, np.int32)
    mat_blk_w = np.asarray(blk_w, np.int32)
    mat_tex_size = np.asarray(tex_size, np.int32)

    n_obj = max(len(object_transforms), 1)
    models = np.tile(np.eye(4, dtype=np.float32), (n_obj, 1, 1))
    normals_m = np.tile(np.eye(3, dtype=np.float32), (n_obj, 1, 1))
    for i, (pos, quat) in enumerate(object_transforms):
        q = torch.from_numpy(np.asarray(quat, np.float32))
        models[i] = math3d.instance_to_model_matrix(
            torch.from_numpy(np.asarray(pos, np.float32)), q).numpy()
        normals_m[i] = math3d.quat_to_mat3(q).numpy()

    # Static material lanes, planar (6, T): the material assignment
    # never changes after the build.
    tm = np.asarray(tri_mat, np.int64)
    mbase = mat_blk_base.astype(np.int64)[tm]
    tri_extra = np.stack(
        [tm, mat_tex_size[tm, 0], mat_tex_size[tm, 1],
         mbase // 65536, mbase % 65536,
         mat_blk_w.astype(np.int64)[tm]], axis=0).astype(np.float32)

    ti = np.asarray(tri_idx, np.int64)

    def corners(attr):  # (V, n) → (3·n, T) planes
        a = np.asarray(attr, np.float32)
        return np.concatenate([a[ti[:, k]].T for k in range(3)], axis=0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Scene(
        position=t(position), uv=t(uv), normal=t(normal),
        tangent=t(tangent), bitangent=t(bitangent),
        vertex_object=t(vertex_object), tri_idx=t(tri_idx),
        tri_mat=t(tri_mat), tri_valid=t(tri_valid),
        object_model=t(models), object_normal=t(normals_m),
        tex_diffuse=t(tex_diffuse), tex_normal=t(tex_normal),
        mat_blk_base=t(mat_blk_base), mat_blk_w=t(mat_blk_w),
        mat_tex_size=t(mat_tex_size), tex_combined=t(tex_combined),
        tri_extra=t(tri_extra),
        corner_pos=t(corners(position)), corner_uv=t(corners(uv)),
        corner_normal=t(corners(normal)),
        corner_tangent=t(corners(tangent)),
        corner_bitangent=t(corners(bitangent)),
        tri_object=t(np.asarray(vertex_object, np.int64)[ti[:, 0]]
                     .astype(np.int32)),
    )
