"""Scene packing: host-side geometry + textures → a Scene of tensors.

Counterpart of the numpy paths of ``kanirenderer_tpu/io/scene_loader.py``
(reference src/resources.rs:63-294): averaged per-vertex tangent frames,
Morton-ordered triangles padded to whole chunks, the combined
diffuse+normal block table, the static per-triangle material lanes and the
corner-major attribute planes.  ``SceneBuilder.add_model`` takes a parsed
OBJ with its textures (default-normal fallback for missing files and
missing material slots, src/resources.rs:105-178; instances spawned at
``rand(i..=10i)`` diagonal positions with a zero quaternion,
src/resources.rs:269-280); procedural scenes fill the lists of a
``SceneBuilder`` directly.  All-u8 scenes pack diffuse and normal maps
into one combined table; a normal map of 16 bits or floats keeps separate
tables at its source depth (src/texture.rs:113-129).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import os

import numpy as np
import torch

from kanirenderer_tpu_torch.core import math3d
from kanirenderer_tpu_torch.core.types import CHUNK_SIZE, Scene
from kanirenderer_tpu_torch.io import image as image_mod
from kanirenderer_tpu_torch.io import obj as obj_mod
from kanirenderer_tpu_torch.io.image import default_normal_image
from kanirenderer_tpu_torch.ops.sampling import (CMB_BX, MAT_BX,
                                                 build_combined_blocks,
                                                 build_material_blocks)


def _srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def compute_tbn(positions: np.ndarray, texcoords: np.ndarray,
                indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Averaged per-vertex tangent/bitangent (reference
    src/resources.rs:204-245): per-triangle T/B from UV deltas, summed into
    each corner vertex, divided by the incident-triangle count.  Degenerate
    UV triangles contribute zero instead of inf/nan."""
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


def morton_order(centroids: np.ndarray, bits: int = 10) -> np.ndarray:
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


@dataclass
class MaterialTextures:
    """Decoded RGBA8 textures for one material."""

    name: str
    diffuse: np.ndarray
    normal: np.ndarray


@dataclass
class SceneBuilder:
    """Accumulates models (each with instances) and textures, then packs a
    Scene on a device.  The reference's mutable ``Vec<Model>`` with its
    file-drop append (src/lib.rs:2122-2137) as a host-side accumulator: the
    lists stay on the host, so ``build`` can be called again."""

    positions: list = field(default_factory=list)
    uvs: list = field(default_factory=list)
    normals: list = field(default_factory=list)
    tangents: list = field(default_factory=list)
    bitangents: list = field(default_factory=list)
    vertex_object: list = field(default_factory=list)
    tri_idx: list = field(default_factory=list)
    tri_mat: list = field(default_factory=list)
    textures: list = field(default_factory=list)   # MaterialTextures per slot
    object_transforms: list = field(default_factory=list)  # (pos, quat)
    load_seconds: dict = field(default_factory=dict)  # set by the API's load

    def add_model(self, obj_scene: obj_mod.ObjScene, tex_dir: str,
                  file_type: str = "opengl", instances: int = 1,
                  rng: np.random.RandomState | None = None) -> None:
        """Append a parsed OBJ: one texture slot per material (a default
        one when the MTL defines none) and every mesh once per instance."""
        if file_type not in ("opengl", "default"):
            raise ValueError(f"unknown file type {file_type!r}")
        opengl = file_type == "opengl"
        rng = rng or np.random.RandomState(0)

        mat_base = len(self.textures)
        mats = obj_scene.materials \
            or [obj_mod.ObjMaterial(name="default material")]
        for m in mats:
            self.textures.append(MaterialTextures(
                name=m.name,
                diffuse=_load_or_default(tex_dir, m.diffuse_texture, False,
                                         opengl),
                normal=_load_or_default(tex_dir, m.normal_texture, True,
                                        opengl)))

        mesh_blocks = [(mesh, *compute_tbn(mesh.positions, mesh.texcoords,
                                           mesh.indices))
                       for mesh in obj_scene.meshes]
        vert_base = sum(len(p) for p in self.positions)
        for inst in range(instances):
            # One uniform draw in [i, 10i] shared by the three axes, zero
            # rotation quaternion; instance 0 sits at the origin.
            p = rng.uniform(inst, inst * 10.0) if inst > 0 else 0.0
            obj_id = len(self.object_transforms)
            self.object_transforms.append(
                (np.array([p, p, p], np.float32), np.zeros(4, np.float32)))
            for mesh, t, b in mesh_blocks:
                nverts = len(mesh.positions)
                self.positions.append(mesh.positions)
                self.uvs.append(mesh.texcoords)
                self.normals.append(mesh.normals)
                self.tangents.append(t)
                self.bitangents.append(b)
                self.vertex_object.append(np.full(nverts, obj_id, np.int32))
                self.tri_idx.append(mesh.indices + vert_base)
                self.tri_mat.append(np.full(
                    len(mesh.indices), mat_base + mesh.material_id, np.int32))
                vert_base += nverts

    def build(self, device="cuda") -> Scene:
        def cat(parts, empty):
            return np.concatenate(parts) if parts else empty

        position = cat(self.positions, np.zeros((1, 3), np.float32))
        uv = cat(self.uvs, np.zeros((1, 2), np.float32))
        normal = cat(self.normals, np.zeros((1, 3), np.float32))
        tangent = cat(self.tangents, np.zeros((1, 3), np.float32))
        bitangent = cat(self.bitangents, np.zeros((1, 3), np.float32))
        vertex_object = cat(self.vertex_object, np.zeros(1, np.int32))
        tri_idx = cat(self.tri_idx, np.zeros((0, 3), np.int32))
        tri_mat = cat(self.tri_mat, np.zeros(0, np.int32))

        # Morton-order triangles by centroid for spatially compact chunks.
        if len(tri_idx):
            order = morton_order(position[tri_idx].mean(axis=1))
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

        # Block-window texel tables.  Diffuse: sRGB u8 → linear →
        # round(sqrt(linear)·255).  The normal map is resampled to the
        # diffuse resolution and kept at its source depth.
        textures = self.textures or [MaterialTextures(
            "default", default_normal_image(), default_normal_image())]
        texdata = []
        for t in textures:
            d = _srgb_to_linear_np(t.diffuse[..., :3].astype(np.float32)
                                   / 255.0)
            d8 = np.round(np.sqrt(np.clip(d, 0.0, 1.0)) * 255.0) \
                .astype(np.uint8)
            n = t.normal[..., :3]
            if n.dtype == np.float64:
                n = n.astype(np.float32)
            h, w = d8.shape[:2]
            if n.shape[:2] != (h, w):
                yi = (np.arange(h) * n.shape[0] // h)
                xi = (np.arange(w) * n.shape[1] // w)
                n = n[yi][:, xi]
            texdata.append((d8, n, w, h))

        ndts = {n.dtype for _, n, _, _ in texdata}
        if any(np.issubdtype(dt, np.floating) for dt in ndts):
            ndt = np.float32
        elif np.dtype(np.uint16) in ndts:
            ndt = np.uint16
        else:
            ndt = np.uint8

        empty_u8 = np.zeros((0, 128), np.uint8)
        blk_base, blk_w, tex_size = [], [], []
        base = 0
        if ndt == np.uint8:
            # All-u8 scene: one combined table, one gather per pixel.
            rows = []
            for d8, n, w, h in texdata:
                rows.append(build_combined_blocks(d8, n))
                blk_base.append(base)
                blk_w.append(-(-w // CMB_BX))
                tex_size.append((w, h))
                base += rows[-1].shape[0]
            tex_combined = np.concatenate(rows)
            tex_diffuse = tex_normal = empty_u8
        else:
            # A deeper normal map is present: separate tables, the normal
            # one at the deepest source depth; mixed scenes promote
            # losslessly (u8 → u16 is ×257).
            def promote(b):
                if b.dtype == ndt:
                    return b
                if ndt == np.uint16:
                    return b.astype(np.uint16) * 257
                if b.dtype == np.uint8:
                    return b.astype(np.float32) / 255.0
                if b.dtype == np.uint16:
                    return b.astype(np.float32) / 65535.0
                return b.astype(np.float32)

            dblocks, nblocks = [], []
            for d8, n, w, h in texdata:
                dblocks.append(build_material_blocks(d8))
                nblocks.append(promote(build_material_blocks(n)))
                blk_base.append(base)
                blk_w.append(-(-w // MAT_BX))
                tex_size.append((w, h))
                base += dblocks[-1].shape[0]
            tex_diffuse = np.concatenate(dblocks)
            tex_normal = np.concatenate(nblocks)
            tex_combined = empty_u8
        mat_blk_base = np.asarray(blk_base, np.int32)
        mat_blk_w = np.asarray(blk_w, np.int32)
        mat_tex_size = np.asarray(tex_size, np.int32)

        n_obj = max(len(self.object_transforms), 1)
        models = np.tile(np.eye(4, dtype=np.float32), (n_obj, 1, 1))
        normals_m = np.tile(np.eye(3, dtype=np.float32), (n_obj, 1, 1))
        for i, (pos, quat) in enumerate(self.object_transforms):
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


def _load_or_default(tex_dir: str, tex_name: str | None, is_normal: bool,
                     opengl: bool) -> np.ndarray:
    """Texture resolution with the reference's fallback chain
    (src/resources.rs:105-163): a missing name or a failed load gives the
    default normal map, as the diffuse fallback too.  The file is looked
    for relative to the CWD (src/resources.rs:18-22), then in the model's
    directory.  Normal maps keep their source bit depth."""
    if tex_name:
        for cand in (tex_name, os.path.join(tex_dir, tex_name)):
            if os.path.exists(cand):
                if is_normal:
                    return image_mod.load_texture_native(cand, True, opengl)
                return image_mod.load_texture_rgba8(cand, False, opengl)
    return default_normal_image()


def load_scene(path: str, file_type: str = "opengl", instances: int = 1,
               rng: np.random.RandomState | None = None,
               device="cuda") -> Scene:
    """Load an OBJ file into a packed Scene on ``device`` (≈ reference
    load_model, src/resources.rs:63-294)."""
    builder = SceneBuilder()
    builder.add_model(obj_mod.load_obj(path),
                      os.path.dirname(os.path.abspath(path)),
                      file_type=file_type, instances=instances, rng=rng)
    return builder.build(device)
