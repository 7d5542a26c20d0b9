"""The port's loaders against the JAX package's: OBJ/MTL parsing, PNG and
JPEG decoding, the texture pipeline, scene packing from files, the
separate texture tables and their sampler, the point-light spawner.

Every file is written by the test into ``tmp_path`` and goes through both
packages.  Tolerance: exact (``assert_array_equal``, equal dtypes) for
everything that is host numpy code on both sides — parsers, decoders,
texture loaders and every ``Scene`` array; 1e-6 absolute for
``sample_materials_blocks``, whose lane sum runs in another order than the
reference's selector product.  The reference's optional native library is
patched off, so it takes its numpy paths (a Morton tie broken differently
would reorder every chunk).
"""

import dataclasses
import io as _io

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kanirenderer_tpu.core import types as ref_types
from kanirenderer_tpu.io import image as ref_image
from kanirenderer_tpu.io import jpeg as ref_jpeg
from kanirenderer_tpu.io import native as ref_native
from kanirenderer_tpu.io import obj as ref_obj
from kanirenderer_tpu.io import scene_loader as ref_loader
from kanirenderer_tpu.models import procedural as ref_procedural
from kanirenderer_tpu.ops import sampling as ref_sampling

import kanirenderer_tpu_torch as port
from kanirenderer_tpu_torch.io import image, jpeg, obj, scene_loader
from kanirenderer_tpu_torch.models import procedural
from kanirenderer_tpu_torch.ops import sampling

# The suite runs several workers on one host: keep each worker's PyTorch
# from taking every core.
torch.set_num_threads(2)


PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(ref_native, "compute_tbn", lambda *a: None)
    monkeypatch.setattr(ref_native, "morton_order", lambda *a: None)


QUAD_OBJ = """\
# two materials, a quad (fan-triangulated), negative indices, a face that
# names a vertex that does not exist, a face without vt/vn
mtllib two.mtl
o first
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
f -4/-4/-1 -3/-3/-1 -2/-2/-1
g second
v 2 0 1
v 3 0 1
v 2 1 1
usemtl blue
f 5//1 6//1 7//1
f 5 6 99
usemtl red
f 1/1 2/2 7/3
"""
TWO_MTL = """\
# comment
newmtl red
Kd 0.9 0.1 0.1
Ks 0.2 0.2 0.2
Ka 0.3 0.3 0.3
Ns 96.0
d 0.5
map_Kd red_d.png
map_Bump -bm 0.3 red_n.png
newmtl blue
map_Kd blue_d.png
norm blue_n.png
"""


def _assert_obj_scenes_equal(ref, ours):
    assert len(ref.meshes) == len(ours.meshes)
    for a, b in zip(ref.meshes, ours.meshes):
        assert (a.name, a.material_id) == (b.name, b.material_id)
        for f in ("positions", "texcoords", "normals", "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert [dataclasses.asdict(m) for m in ref.materials] \
        == [dataclasses.asdict(m) for m in ours.materials]


def test_parse_mtl_field_for_field():
    ref, ours = ref_obj.parse_mtl(TWO_MTL), obj.parse_mtl(TWO_MTL)
    assert [dataclasses.asdict(m) for m in ref] \
        == [dataclasses.asdict(m) for m in ours]
    assert ours[0].normal_texture == "red_n.png"      # -bm option skipped
    assert ours[1].normal_texture == "blue_n.png" and ours[0].dissolve == 0.5


@pytest.mark.parametrize("case", ["two_materials", "no_mtl", "cube"])
def test_parse_obj_field_for_field(case):
    text = {"two_materials": QUAD_OBJ, "no_mtl": QUAD_OBJ,
            "cube": procedural.make_cube_obj(10.0)}[case]
    loader = (lambda p: TWO_MTL) if case == "two_materials" \
        else (lambda p: None)
    ref = ref_obj.parse_obj(text, mtl_loader=loader, name="n")
    ours = obj.parse_obj(text, mtl_loader=loader, name="n")
    _assert_obj_scenes_equal(ref, ours)
    if case == "two_materials":
        assert [m.material_id for m in ours.meshes] == [0, 1, 0]
        # the quad fans into two triangles; negative indices resolve to the
        # same vertices, so no new vertex rows appear
        assert ours.meshes[0].indices.tolist() == [[0, 1, 2], [0, 2, 3],
                                                   [0, 1, 2]]
        # the missing vertex 99 becomes a zero position, not a crash
        np.testing.assert_array_equal(ours.meshes[1].positions[-1], 0.0)
    if case == "no_mtl":
        assert [m.name for m in ours.materials] == ["Material"]
    assert procedural.make_cube_obj() == ref_procedural.make_cube_obj()


def _write_scene_files(tmp_path, normal_dtype):
    """cube.obj + two.mtl-style materials with PNG textures; the normal map
    of the first material in ``normal_dtype``."""
    rng = np.random.RandomState(11)
    d8 = rng.randint(0, 256, (12, 20, 3), np.uint8)
    image.write_png(str(tmp_path / "a_d.png"), d8)
    if normal_dtype == np.uint16:
        n = rng.randint(0, 65536, (12, 20, 3)).astype(np.uint16)
    else:
        n = rng.randint(0, 256, (6, 10, 3), np.uint8)   # resampled at pack
    image.write_png(str(tmp_path / "a_n.png"), n)
    image.write_png(str(tmp_path / "b_d.png"),
                    rng.randint(0, 256, (8, 8, 4), np.uint8))
    (tmp_path / "m.mtl").write_text(
        "newmtl A\nmap_Kd a_d.png\nmap_Bump a_n.png\n"
        "newmtl B\nmap_Kd b_d.png\nmap_Bump missing.png\n")
    text = procedural.make_cube_obj().replace("mtllib none.mtl",
                                              "mtllib m.mtl")
    faces = text.splitlines()
    cut = len(faces) - 6        # the last three faces take material B
    text = "\n".join(faces[:cut] + ["usemtl B"] + faces[cut:]) + "\n"
    text = text.replace("usemtl Material", "usemtl A")
    path = tmp_path / "cube.obj"
    path.write_text(text)
    return str(path)


def test_load_obj_reads_the_mtl_beside_it(tmp_path):
    path = _write_scene_files(tmp_path, np.uint8)
    ref, ours = ref_obj.load_obj(path), obj.load_obj(path)
    _assert_obj_scenes_equal(ref, ours)
    assert [m.name for m in ours.materials] == ["A", "B"]
    assert [m.material_id for m in ours.meshes] == [0, 1]
    assert ours.meshes[0].name == "Cube"


@pytest.mark.parametrize("normal_dtype", [np.uint8, np.uint16],
                         ids=["all_u8", "u16_normal"])
@pytest.mark.parametrize("file_type", ["opengl", "default"])
def test_load_scene_every_array_equal(tmp_path, normal_dtype, file_type):
    """cube + textures, three instances: every Scene array equals the JAX
    package's in shape, dtype and value."""
    path = _write_scene_files(tmp_path, normal_dtype)
    ref = ref_loader.load_scene(path, file_type, instances=3,
                                rng=np.random.RandomState(7))
    ours = scene_loader.load_scene(path, file_type, instances=3,
                                   rng=np.random.RandomState(7),
                                   device="cpu")
    for name in port.Scene._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(ours.tri_valid.sum()) == 36 and ours.object_model.shape[0] == 3
    if normal_dtype == np.uint16:
        assert ours.tex_normal.dtype == torch.uint16
        assert ours.tex_combined.shape[0] == 0
        # material B's missing normal map is the u8 default, promoted ×257
        assert int(ours.tex_normal[int(ours.mat_blk_base[1]), 2]) == 255 * 257
    else:
        assert ours.tex_combined.shape[0] > 0
        assert ours.tex_diffuse.shape[0] == 0


def test_builder_appends_models_and_cube_scene_matches():
    ref = ref_procedural.cube_scene(instances=2)
    ours = procedural.cube_scene(instances=2, device="cpu")
    for name in port.Scene._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(ours, name).numpy(),
                                      err_msg=name)
    b = scene_loader.SceneBuilder()
    parsed = obj.parse_obj(procedural.make_cube_obj(),
                           mtl_loader=lambda p: None)
    b.add_model(parsed, ".", instances=1)
    b.add_model(parsed, ".", instances=1)
    scene = b.build("cpu")
    assert int(scene.tri_valid.sum()) == 24
    assert scene.object_model.shape[0] == 2
    assert int(scene.tri_idx.max()) == 47
    with pytest.raises(ValueError):
        b.add_model(parsed, ".", file_type="directx")


def test_layered_scene_matches_reference():
    kw = dict(layers=3, target_tris=3000, tex_size=16)
    ref = ref_procedural.layered_scene(**kw)
    ours = procedural.layered_scene(**kw, device="cpu")
    for name in port.Scene._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _png_cases():
    rng = np.random.RandomState(5)
    return {
        "rgb8": rng.randint(0, 256, (9, 7, 3), np.uint8),
        "rgba8": rng.randint(0, 256, (5, 11, 4), np.uint8),
        "gray8": rng.randint(0, 256, (6, 6, 1), np.uint8),
        "rgb16": rng.randint(0, 65536, (7, 5, 3)).astype(np.uint16),
        "rgba16": rng.randint(0, 65536, (4, 4, 4)).astype(np.uint16),
    }


@pytest.mark.parametrize("case", _png_cases().keys())
def test_png_encode_decode_equal(case):
    img = _png_cases()[case]
    data = image.encode_png(img)
    assert data == ref_image.encode_png(img)
    got, ref = image.decode_png(data), ref_image.decode_png(data)
    assert got.dtype == ref.dtype == img.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)
    a, b = image.load_image_bytes(data), ref_image.load_image_bytes(data)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("filtered", ["sub_up_avg_paeth", "palette"])
def test_png_decode_of_filtered_and_palette_files(filtered):
    """PIL writes adaptive row filters and palettes, which the port's own
    encoder never produces: the pure decoder must undo them."""
    rng = np.random.RandomState(2)
    base = np.kron(rng.randint(0, 256, (4, 4, 3)),
                   np.ones((4, 4, 1))).astype(np.uint8)
    base[::3] += np.arange(16, dtype=np.uint8)[:, None]
    pil = PIL.fromarray(base)
    if filtered == "palette":
        pil = pil.convert("P", palette=PIL.ADAPTIVE, colors=8)
    buf = _io.BytesIO()
    pil.save(buf, "PNG", bits=8)
    got = image.decode_png(buf.getvalue())
    np.testing.assert_array_equal(got, ref_image.decode_png(buf.getvalue()))
    np.testing.assert_array_equal(got, np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_jpeg_decode_equal(subsampling, monkeypatch):
    rng = np.random.RandomState(0)
    img = (np.kron(rng.rand(5, 5, 3), np.ones((8, 8, 1))) * 255) \
        .astype(np.uint8)[:36, :38]
    buf = _io.BytesIO()
    PIL.fromarray(img).save(buf, "JPEG", quality=92, subsampling=subsampling)
    data = buf.getvalue()
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, ref_jpeg.decode_jpeg(data))
    assert got.shape == (36, 38, 3)
    # without PIL the loader routes JPEG bytes to the pure decoder
    monkeypatch.setattr(image, "_HAVE_PIL", False)
    np.testing.assert_array_equal(image.load_image_bytes(data), got)


def test_progressive_jpeg_raises():
    buf = _io.BytesIO()
    PIL.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
        buf, "JPEG", progressive=True)
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(buf.getvalue())


@pytest.mark.parametrize("kind", ["png8", "png16", "jpeg", "gray", "missing"])
@pytest.mark.parametrize("opengl", [True, False])
def test_texture_loaders_equal(tmp_path, kind, opengl):
    """load_texture_rgba8 / load_texture_native, as diffuse and as normal
    map, in both file conventions: arrays and dtypes equal."""
    rng = np.random.RandomState(3)
    path = tmp_path / ("t.jpg" if kind == "jpeg" else "t.png")
    if kind == "png8":
        image.write_png(str(path), rng.randint(0, 256, (6, 5, 3), np.uint8))
    elif kind == "png16":
        image.write_png(str(path), rng.randint(0, 65536, (6, 5, 4))
                        .astype(np.uint16))
    elif kind == "gray":
        image.write_png(str(path), rng.randint(0, 256, (6, 5, 1), np.uint8))
    elif kind == "jpeg":
        PIL.fromarray(rng.randint(0, 256, (16, 16, 3), np.uint8)).save(
            str(path), "JPEG", quality=90)
    for is_normal in (False, True):
        for fn in ("load_texture_rgba8", "load_texture_native"):
            a = getattr(image, fn)(str(path), is_normal, opengl)
            b = getattr(ref_image, fn)(str(path), is_normal, opengl)
            assert a.dtype == b.dtype and a.shape == b.shape, (fn, is_normal)
            np.testing.assert_array_equal(a, b)
            assert a.shape[-1] == 4
    if kind == "png16":
        assert image.load_texture_native(str(path), True, opengl).dtype \
            == np.uint16
        assert image.load_texture_rgba8(str(path), True, opengl).dtype \
            == np.uint8
    if kind == "missing":
        assert tuple(a[0, 0]) == (128, 128, 255, 255)


def test_texture_pipeline_pieces():
    img = np.zeros((2, 2, 4), np.uint8)
    img[0, 0] = (10, 100, 30, 255)
    assert tuple(image.flip_vertical(img)[1, 0]) == (10, 100, 30, 255)
    assert image.invert_green(img)[0, 0, 1] == 155
    img16 = np.zeros((1, 1, 3), np.uint16)
    img16[0, 0] = (0, 1000, 0)
    assert image.invert_green(img16)[0, 0, 1] == 64535
    f = np.full((1, 1, 3), 0.25, np.float32)
    assert image.invert_green(f)[0, 0, 1] == 0.75
    for arr in (img16, f, np.full((2, 2, 2), 7, np.uint8)):
        np.testing.assert_array_equal(image.to_rgba8(arr),
                                      ref_image.to_rgba8(arr))
        a, b = image.to_rgba_native(arr), ref_image.to_rgba_native(arr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(image.default_normal_image(),
                                  ref_image.default_normal_image())


TABLE_DTYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}


@pytest.mark.parametrize("kind", TABLE_DTYPES.keys())
def test_material_blocks_and_sampler(kind):
    """build_material_blocks equal; sample_materials_blocks within 1e-6 of
    the reference for u8, u16 and f32 normal tables (Repeat addressing:
    the coordinates run outside [0, 1])."""
    rng = np.random.RandomState(9)
    h, w = 10, 14
    d8 = rng.randint(0, 256, (h, w, 3), np.uint8)
    if kind == "f32":
        n = rng.rand(h, w, 3).astype(np.float32)
    else:
        n = rng.randint(0, np.iinfo(TABLE_DTYPES[kind]).max + 1,
                        (h, w, 3)).astype(TABLE_DTYPES[kind])
    dblk, nblk = (sampling.build_material_blocks(t) for t in (d8, n))
    for ours, tex in ((dblk, d8), (nblk, n)):
        ref = ref_sampling.build_material_blocks(tex)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    assert sampling.MAT_BX == ref_sampling.MAT_BX

    shape = (7, 9)
    u = rng.uniform(-1.5, 2.5, shape).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, shape).astype(np.float32)
    ints = [np.zeros(shape, np.int32), np.full(shape, -(-w // 6), np.int32),
            np.full(shape, w, np.int32), np.full(shape, h, np.int32)]
    rd, rn = ref_sampling.sample_materials_blocks(
        jnp.asarray(dblk), jnp.asarray(nblk), *map(jnp.asarray, ints),
        jnp.asarray(u), jnp.asarray(v))
    od, on = sampling.sample_materials_blocks(
        torch.from_numpy(dblk), torch.from_numpy(nblk),
        *map(torch.from_numpy, ints), torch.from_numpy(u),
        torch.from_numpy(v))
    np.testing.assert_allclose(od.numpy(), np.asarray(rd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(on.numpy(), np.asarray(rn), rtol=0, atol=1e-6)
    assert od.shape == (3,) + shape and float(on.std()) > 0.05


def test_16bit_normal_map_keeps_source_precision(tmp_path):
    """A 16-bit normal map reaches the sampler at better than 8-bit
    precision (reference src/texture.rs:113-129)."""
    h = w = 24
    g = np.arange(h * w, dtype=np.uint32).reshape(h, w) * 7 + 129
    n16 = np.stack([g % 65536, g * 3 % 65536, np.full((h, w), 33000)],
                   axis=-1).astype(np.uint16)
    image.write_png(str(tmp_path / "n16.png"), n16)
    image.write_png(str(tmp_path / "d8.png"), np.full((h, w, 3), 180,
                                                      np.uint8))
    (tmp_path / "m.mtl").write_text(
        "newmtl m\nmap_Kd d8.png\nmap_Bump n16.png\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
        "usemtl m\nf 1/1/1 2/2/2 3/3/3\n")
    scene = scene_loader.load_scene(str(tmp_path / "q.obj"),
                                    file_type="default", device="cpu")
    assert scene.tex_normal.dtype == torch.uint16
    one = torch.ones((1, 1), dtype=torch.int32)
    _, normal = sampling.sample_materials_blocks(
        scene.tex_diffuse, scene.tex_normal, one * 0,
        one * scene.mat_blk_w[0], one * w, one * h,
        torch.tensor([[(3 + 0.5) / w]]), torch.tensor([[(5 + 0.5) / h]]))
    want = n16[5, 3].astype(np.float64) / 65535.0
    err = np.abs(normal[:, 0, 0].numpy() - want).max()
    assert err < 1e-4 and err < (0.5 / 255.0) / 4, err


@pytest.mark.parametrize("num", [1, 7, 50])
def test_spawn_point_lights_equal(num):
    ref = ref_types.spawn_point_lights(num, np.random.RandomState(4))
    ours = port.spawn_point_lights(num, np.random.RandomState(4),
                                   device="cpu")
    for a, b in zip(ref, ours):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert ours.position.shape == ((150, 3) if num == 50 else (num, 3))
