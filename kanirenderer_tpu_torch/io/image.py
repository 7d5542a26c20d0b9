"""Texture decode and preprocessing.

Behavioral parity with the reference texture pipeline (src/texture.rs):

* ``load_image``        — decode PNG/JPEG to an RGBA uint8/uint16/f32 array
                          (the wgpu build converts everything to RGBA8 on
                          upload, src/texture.rs:104; we keep higher depths
                          through preprocessing then quantize identically).
* ``flip_vertical``     — "opengl" file-type V-flip (src/texture.rs:90).
* ``invert_green``      — normal-map green-channel inversion at every bit
                          depth (src/texture.rs:10-58).
* ``to_rgba8``          — the ``to_rgba8`` conversion applied before upload.
* default-texture fallback: any load failure yields the embedded default
  normal map (src/resources.rs:51-61) — a flat +Z normal (128, 128, 255).

Decoding uses PIL when available, with minimal built-in PNG and baseline
JPEG decoders (io/jpeg.py) as a fallback, so the package has no hard
dependency on it.  Own copy of ``kanirenderer_tpu/io/image.py``.
"""

from __future__ import annotations

import io as _io
import os
import struct
import zlib

import numpy as np

try:
    from PIL import Image as _PILImage
    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


def default_normal_image(size: int = 4) -> np.ndarray:
    """Flat tangent-space normal map, the fallback for every missing texture.

    Mirrors the role of res/default_normal.png (reference
    src/resources.rs:51-61): RGB (128, 128, 255) = +Z normal.  Also used as
    the fallback *diffuse* texture, exactly like the reference does.
    """
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = 128
    img[..., 1] = 128
    img[..., 2] = 255
    img[..., 3] = 255
    return img


# ---------------------------------------------------------------------------
# Minimal PNG decode (fallback path; 8/16-bit RGB(A)/gray, non-interlaced)
# ---------------------------------------------------------------------------

def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """Decode a non-interlaced PNG to (H, W, C) uint8 or uint16."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = bytearray()
    width = height = bitdepth = colortype = None
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _, _, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if interlace:
                raise ValueError("interlaced PNG unsupported by fallback decoder")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctype == b"IDAT":
            idat.extend(chunk)
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(bytes(idat))
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colortype]
    if bitdepth == 8:
        bypp = channels
    elif bitdepth == 16:
        bypp = channels * 2
    else:
        raise ValueError(f"bitdepth {bitdepth} unsupported by fallback decoder")
    stride = width * bypp
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1:off + 1 + stride], np.uint8).astype(np.int32)
        off += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = line.copy()
            for i in range(bypp, stride):
                cur[i] = (cur[i] + cur[i - bypp]) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 3:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bypp] if i >= bypp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bypp] if i >= bypp else 0
                ul = prev[i - bypp] if i >= bypp else 0
                cur[i] = (cur[i] + _paeth(left, int(prev[i]), ul)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    if bitdepth == 16:
        arr16 = out.reshape(height, width, channels, 2)
        img = (arr16[..., 0].astype(np.uint16) << 8) | arr16[..., 1]
    else:
        img = out.reshape(height, width, channels)
    if colortype == 3:  # palette
        rgb = palette[img[..., 0]]
        if trns is not None:
            a = np.full(img.shape[:2], 255, np.uint8)
            a[img[..., 0] < len(trns)] = trns[img[..., 0][img[..., 0] < len(trns)]]
            img = np.concatenate([rgb, a[..., None]], -1)
        else:
            img = rgb
    return img


def load_image_bytes(data: bytes) -> np.ndarray:
    """Decode image bytes to (H, W, C) with native dtype (uint8/uint16/f32)."""
    # 16-bit RGB(A) PNGs: PIL silently converts to 8-bit "RGB" mode, which
    # would defeat the reference's format-by-source-depth normal maps
    # (src/texture.rs:113-129) — decode those with the native-path decoder.
    if (data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 24
            and data[24] == 16):
        return decode_png(data)
    if _HAVE_PIL:
        try:
            img = _PILImage.open(_io.BytesIO(data))
            mode = img.mode
            if mode in ("I;16", "I;16B", "I"):
                arr = np.asarray(img, np.uint16)[..., None]
            elif mode == "F":
                arr = np.asarray(img, np.float32)[..., None]
            else:
                if mode == "P":
                    img = img.convert("RGBA")
                elif mode not in ("L", "LA", "RGB", "RGBA"):
                    img = img.convert("RGBA")
                arr = np.asarray(img)
                if arr.ndim == 2:
                    arr = arr[..., None]
            return arr
        except Exception:
            pass
    if data[:2] == b"\xff\xd8":
        from kanirenderer_tpu_torch.io.jpeg import decode_jpeg
        return decode_jpeg(data)
    return decode_png(data)


def load_image(path: str) -> np.ndarray | None:
    try:
        with open(path, "rb") as f:
            return load_image_bytes(f.read())
    except Exception:
        return None


def flip_vertical(img: np.ndarray) -> np.ndarray:
    """OpenGL-convention V-flip (reference src/texture.rs:90)."""
    return img[::-1].copy()


def invert_green(img: np.ndarray) -> np.ndarray:
    """Invert the green channel at the image's native bit depth
    (reference src/texture.rs:10-58)."""
    if img.shape[-1] < 2:
        return img
    out = img.copy()
    if img.dtype == np.uint8:
        out[..., 1] = 255 - img[..., 1]
    elif img.dtype == np.uint16:
        out[..., 1] = 65535 - img[..., 1]
    else:
        out[..., 1] = 1.0 - img[..., 1]
    return out


def to_rgba8(img: np.ndarray) -> np.ndarray:
    """Convert any decoded image to RGBA8 (reference src/texture.rs:104)."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    elif img.dtype in (np.float32, np.float64):
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    c = img.shape[-1]
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if c == 1:      # L
        out[..., :3] = img
        out[..., 3] = 255
    elif c == 2:    # LA
        out[..., :3] = img[..., :1]
        out[..., 3] = img[..., 1]
    elif c == 3:
        out[..., :3] = img
        out[..., 3] = 255
    else:
        out[:] = img[..., :4]
    return out


def to_rgba_native(img: np.ndarray) -> np.ndarray:
    """Convert a decoded image to 4-channel RGBA at its NATIVE bit depth
    (u8/u16/float preserved) — the reference keeps Rgba16Unorm /
    Rgba32Float for high-depth normal maps (src/texture.rs:113-129)."""
    if img.dtype == np.uint8:
        return to_rgba8(img)
    one = np.uint16(65535) if img.dtype == np.uint16 else img.dtype.type(1)
    c = img.shape[-1]
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), img.dtype)
    if c == 1:      # L
        out[..., :3] = img
        out[..., 3] = one
    elif c == 2:    # LA
        out[..., :3] = img[..., :1]
        out[..., 3] = img[..., 1]
    elif c == 3:
        out[..., :3] = img
        out[..., 3] = one
    else:
        out[:] = img[..., :4]
    return out


def load_texture_rgba8(path: str, is_normal_map: bool,
                       opengl_mode: bool) -> np.ndarray:
    """Full reference-texture load pipeline → RGBA8.

    "default" file type: decode only (reference Texture::from_bytes,
    src/texture.rs:61-75).  "opengl": V-flip always, plus green-channel
    inversion for normal maps (Texture::from_opengl_bytes,
    src/texture.rs:77-95).  Any failure → default normal map
    (src/resources.rs:51-61).
    """
    img = load_image(path)
    if img is None:
        img = default_normal_image()
        return img
    if opengl_mode:
        img = flip_vertical(img)
        if is_normal_map:
            img = invert_green(img)
    return to_rgba8(img)


def load_texture_native(path: str, is_normal_map: bool,
                        opengl_mode: bool) -> np.ndarray:
    """Like ``load_texture_rgba8`` but preserving the source bit depth
    (u8/u16/float), for normal maps — the reference selects Rgba8Unorm /
    Rgba16Unorm / Rgba32Float by source color type (texture.rs:113-129).
    The V-flip and green-inversion already operate at native depth."""
    img = load_image(path)
    if img is None:
        return default_normal_image()
    if opengl_mode:
        img = flip_vertical(img)
        if is_normal_map:
            img = invert_green(img)
    return to_rgba_native(img)


# ---------------------------------------------------------------------------
# Minimal PNG encode (for frame dumps; see runtime/display.py)
# ---------------------------------------------------------------------------

def encode_png(img: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8 — or uint16 (16-bit PNG) — to PNG bytes
    (filter 0, zlib level 6)."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    ctype = {1: 0, 3: 2, 4: 6}[c]
    depth = 16 if img.dtype == np.uint16 else 8
    if depth == 16:
        img = img.astype(">u2")  # PNG stores 16-bit big-endian
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    comp = zlib.compress(raw, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", comp) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
