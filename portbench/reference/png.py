"""The PNG files of the benchmark's scenes: 8-bit RGB, filter 0 on every
row, one IDAT chunk.  ``encode`` writes them, ``decode`` reads them back
for the reference (and reads nothing else)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 → PNG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("RGB images only")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes written by ``encode`` → (H, W, 3) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w, h = 8, [], 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError("8-bit RGB only")
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError("filter 0 rows only")
    return raw[:, 1:].reshape(h, w, 3).copy()
