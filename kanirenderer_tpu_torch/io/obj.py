"""Wavefront OBJ / MTL parsing to packed numpy arrays.

Behavioral model: the reference parses OBJ via ``tobj`` with
``triangulate: true, single_index: true`` (reference src/resources.rs:84-101):

* faces with >3 vertices are fan-triangulated;
* every distinct (position, texcoord, normal) index triple becomes one vertex
  (single indexing), so vertices shared with different UVs/normals duplicate;
* missing texcoords/normals are filled with zeros;
* material resolution falls back to ``cube.mtl`` when the .mtl is missing
  (src/resources.rs:94-99) and a default material is injected when the MTL
  defines none (src/resources.rs:165-178 — handled by the scene loader).

Own copy of ``kanirenderer_tpu/io/obj.py`` (host-side numpy), without that
module's optional C++ parser for large files: every file goes through
``parse_obj``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjMaterial:
    name: str
    diffuse_texture: str | None = None
    normal_texture: str | None = None
    # Unused by the reference's shading, parsed for completeness:
    diffuse: tuple = (0.8, 0.8, 0.8)
    specular: tuple = (0.5, 0.5, 0.5)
    ambient: tuple = (1.0, 1.0, 1.0)
    shininess: float = 250.0
    dissolve: float = 1.0


@dataclass
class ObjMesh:
    """One ``o``/``g``-and-material section, single-indexed & triangulated."""

    name: str
    positions: np.ndarray   # (V, 3) f32
    texcoords: np.ndarray   # (V, 2) f32 (zeros when absent)
    normals: np.ndarray     # (V, 3) f32 (zeros when absent)
    indices: np.ndarray     # (T, 3) i32
    material_id: int = 0


@dataclass
class ObjScene:
    meshes: list[ObjMesh] = field(default_factory=list)
    materials: list[ObjMaterial] = field(default_factory=list)


def parse_mtl(text: str) -> list[ObjMaterial]:
    materials: list[ObjMaterial] = []
    cur: ObjMaterial | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        key = parts[0]
        rest = parts[1].strip() if len(parts) > 1 else ""
        if key == "newmtl":
            cur = ObjMaterial(name=rest)
            materials.append(cur)
        elif cur is None:
            continue
        elif key == "map_Kd":
            cur.diffuse_texture = rest.split()[-1] if rest else None
        elif key in ("map_Bump", "map_bump", "bump", "norm", "map_Kn"):
            # take the last token: skips -bm multiplier options
            cur.normal_texture = rest.split()[-1] if rest else None
        elif key == "Kd":
            cur.diffuse = tuple(float(x) for x in rest.split()[:3])
        elif key == "Ks":
            cur.specular = tuple(float(x) for x in rest.split()[:3])
        elif key == "Ka":
            cur.ambient = tuple(float(x) for x in rest.split()[:3])
        elif key == "Ns":
            cur.shininess = float(rest.split()[0])
        elif key == "d":
            cur.dissolve = float(rest.split()[0])
    return materials


# Minimal cube.mtl-equivalent fallback (reference src/resources.rs:94-99 falls
# back to the embedded res/cube.mtl, a single untextured "Material").
_FALLBACK_MTL = "newmtl Material\nNs 250.0\nKd 0.8 0.8 0.8\nKs 0.5 0.5 0.5\n"


def _resolve_index(tok: str, count: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else count + i


def parse_obj(text: str, mtl_loader=None, name: str = "obj") -> ObjScene:
    """Parse OBJ text.  ``mtl_loader(path) -> str|None`` supplies MTL text."""
    positions: list[tuple] = []
    texcoords: list[tuple] = []
    normals: list[tuple] = []

    materials: list[ObjMaterial] = []
    mat_index: dict[str, int] = {}
    cur_mat = -1

    # per-mesh accumulation: split on material change (tobj models are split
    # by object/group; per-face material switches also split so each mesh has
    # a single material_id, matching Mesh.material usage in the reference).
    meshes: list[ObjMesh] = []
    vert_map: dict[tuple, int] = {}
    verts: list[tuple] = []
    tris: list[tuple] = []
    mesh_name = name

    def flush():
        nonlocal verts, tris, vert_map
        if tris:
            def pick(table, i, zero):
                return table[i] if 0 <= i < len(table) else zero
            v = np.array([pick(positions, p, (0, 0, 0)) for p, _, _ in verts],
                         np.float32)
            vt = np.array([pick(texcoords, t, (0, 0)) for _, t, _ in verts],
                          np.float32)
            vn = np.array([pick(normals, n, (0, 0, 0)) for _, _, n in verts],
                          np.float32)
            meshes.append(ObjMesh(
                name=mesh_name,
                positions=v, texcoords=vt, normals=vn,
                indices=np.array(tris, np.int32),
                material_id=max(cur_mat, 0),
            ))
        verts, tris, vert_map = [], [], {}

    def vkey(tok: str) -> int:
        pi = ti = ni = -1
        comps = tok.split("/")
        pi = _resolve_index(comps[0], len(positions))
        if len(comps) > 1 and comps[1]:
            ti = _resolve_index(comps[1], len(texcoords))
        if len(comps) > 2 and comps[2]:
            ni = _resolve_index(comps[2], len(normals))
        key = (pi, ti, ni)
        idx = vert_map.get(key)
        if idx is None:
            idx = len(verts)
            vert_map[key] = idx
            verts.append(key)
        return idx

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0]
        if key == "v":
            positions.append(tuple(float(x) for x in parts[1:4]))
        elif key == "vt":
            texcoords.append(tuple(float(x) for x in parts[1:3]))
        elif key == "vn":
            normals.append(tuple(float(x) for x in parts[1:4]))
        elif key == "f":
            idx = [vkey(tok) for tok in parts[1:]]
            for k in range(1, len(idx) - 1):  # fan triangulation
                tris.append((idx[0], idx[k], idx[k + 1]))
        elif key in ("o", "g"):
            flush()
            mesh_name = parts[1] if len(parts) > 1 else name
        elif key == "usemtl":
            mtl_name = parts[1] if len(parts) > 1 else ""
            new_mat = mat_index.get(mtl_name, -1)
            if new_mat != cur_mat:
                flush()
            cur_mat = new_mat
        elif key == "mtllib":
            mtl_text = None
            if mtl_loader is not None:
                mtl_text = mtl_loader(" ".join(parts[1:]))
            if mtl_text is None:
                mtl_text = _FALLBACK_MTL
            for m in parse_mtl(mtl_text):
                if m.name not in mat_index:
                    mat_index[m.name] = len(materials)
                    materials.append(m)
    flush()
    return ObjScene(meshes=meshes, materials=materials)


def load_obj(path: str) -> ObjScene:
    """Load an OBJ file; MTLs resolve relative to the CWD first (the reference
    reads every asset from the CWD, src/resources.rs:18-22) then the OBJ dir."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    obj_dir = os.path.dirname(os.path.abspath(path))

    def mtl_loader(mtl_path: str) -> str | None:
        for cand in (mtl_path, os.path.join(obj_dir, mtl_path)):
            try:
                with open(cand, "r", errors="replace") as f:
                    return f.read()
            except OSError:
                continue
        return None

    name = os.path.splitext(os.path.basename(path))[0]
    return parse_obj(text, mtl_loader, name=name)
