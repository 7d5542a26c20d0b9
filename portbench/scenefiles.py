"""The scene of a configuration: made by the generator that its
``geometry.generator`` names, written once per checkout as OBJ + MTL + PNG
files into ``portbench/cache/<config>/``, and read back as arrays for the
reference.

A generator is a module ``scenes/<generator>.py``, found by its name, with
two functions of the configuration's ``geometry`` object:
``patches(geometry)``, a list of quad patches (positions, uvs, normals,
triangles with scene-wide vertex indices, material id per triangle), and
``textures(geometry, texture_size)``, a list of (name, diffuse RGBA,
normal RGBA) per material.  The reference takes the patches anew and the
textures from the files, so it never pays for making the maps.

``write_scene_obj`` is a copy of ``chip_smoke.write_scene_obj`` (commit
1e399aa) with the benchmark's own PNG writer (``reference/png.py``).  The
scene depends on the configuration alone, never on ``--seed``.
"""

from __future__ import annotations

import importlib.util
import os
import re
import shutil
from pathlib import Path

from portbench.reference import png

HERE = Path(__file__).resolve().parent
CACHE = HERE / "cache"
SCENES = HERE / "scenes"
# A generator's name: a benchmark name, so never a path.
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def generator(name: str):
    """The generator module ``scenes/<name>.py``; raises where there is
    none, before anything is generated or loaded."""
    scenes = SCENES
    path = scenes / f"{name}.py"
    if not isinstance(name, str) or not NAME.match(name) \
            or not path.is_file():
        known = sorted(p.stem for p in scenes.glob("*.py"))
        raise ValueError(f"no scene generator {name!r} in {scenes} "
                         f"(there are {known})")
    spec = importlib.util.spec_from_file_location(
        "portbench_scene_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_scene_obj(directory: Path, textures, patches,
                    name: str = "scene") -> Path:
    """Write ``textures`` and ``patches`` as ``<name>.obj`` +
    ``<name>.mtl`` + one PNG diffuse and one PNG normal map per material
    into ``directory``; returns the OBJ's path.  One ``g`` section per
    patch, floats as %.9g so that float32 values round-trip."""
    mtl = []
    for i, (tname, diffuse, normal) in enumerate(textures):
        (directory / f"{name}_{i}_d.png").write_bytes(
            png.encode(diffuse[..., :3]))
        (directory / f"{name}_{i}_n.png").write_bytes(
            png.encode(normal[..., :3]))
        mtl.append(f"newmtl {tname}\nmap_Kd {name}_{i}_d.png\n"
                   f"map_Bump {name}_{i}_n.png\n")
    (directory / f"{name}.mtl").write_text("".join(mtl))

    lines = [f"mtllib {name}.mtl"]
    for k, (pos, uv, nrm, tris, mats) in enumerate(patches):
        lines.append(f"g patch_{k}")
        lines += ["v %.9g %.9g %.9g" % tuple(p) for p in pos.tolist()]
        lines += ["vt %.9g %.9g" % tuple(p) for p in uv.tolist()]
        lines += ["vn %.9g %.9g %.9g" % tuple(p) for p in nrm.tolist()]
        lines.append(f"usemtl {textures[int(mats[0])][0]}")
        lines += ["f %d/%d/%d %d/%d/%d %d/%d/%d" % (a, a, a, b, b, b, c, c, c)
                  for a, b, c in (tris + 1).tolist()]
    path = directory / f"{name}.obj"
    path.write_text("\n".join(lines) + "\n")
    return path


def scene_dir(config: dict, cache: Path = CACHE) -> Path:
    """The directory that holds the configuration's scene files, written
    on first use.  Files are written into ``<name>.partial`` and the
    directory renamed when complete, so a run cut short leaves no scene
    that looks whole."""
    geo = config["geometry"]
    make = generator(geo["generator"])
    final = cache / config["name"]
    if (final / "scene.obj").exists():
        return final
    part = cache / (config["name"] + ".partial")
    shutil.rmtree(part, ignore_errors=True)
    part.mkdir(parents=True)
    write_scene_obj(part, make.textures(geo, config["texture_size"]),
                    make.patches(geo))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(part, final)
    return final


def reference_inputs(config: dict, directory: Path):
    """(patches, diffuse RGB images, normal RGB images) for the reference:
    the geometry generated anew, the textures read from the files."""
    patches = generator(config["geometry"]["generator"]).patches(
        config["geometry"])
    n = len(list(directory.glob("scene_*_d.png")))
    diffuse = [png.decode((directory / f"scene_{i}_d.png").read_bytes())
               for i in range(n)]
    normal = [png.decode((directory / f"scene_{i}_n.png").read_bytes())
              for i in range(n)]
    return patches, diffuse, normal
