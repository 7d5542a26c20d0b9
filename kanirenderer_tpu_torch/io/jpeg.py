"""Minimal baseline JPEG decoder (pure numpy) — the no-PIL fallback.

The reference decodes JPEG textures natively through the Rust ``image``
crate (reference src/texture.rs:61-75); this module keeps OBJ+JPEG scenes
loadable on a PIL-less host.  Scope: baseline sequential DCT (SOF0),
8-bit, grayscale or YCbCr with 4:4:4 / 4:2:2 / 4:2:0 chroma subsampling,
restart markers.  Progressive (SOF2) and arithmetic coding raise
``ValueError`` (callers fall back to the default texture, matching the
reference's load_texture fallback, src/resources.rs:51-61).

Pure host-side Python: runs once per texture at scene load, never in the
frame loop.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# 8-point IDCT basis: block = C.T @ coeffs @ C with orthonormal C.
_C = np.zeros((8, 8), np.float64)
for _k in range(8):
    for _n in range(8):
        _C[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16) \
            * (np.sqrt(1 / 8) if _k == 0 else np.sqrt(2 / 8))


class _Huff:
    """Canonical JPEG Huffman table with a flat 16-bit lookup."""

    def __init__(self, counts: bytes, symbols: bytes):
        self.max_len = 16
        lut_bits = 16
        self.lut = np.zeros(1 << lut_bits, np.int32)      # (len<<8)|symbol
        code = 0
        k = 0
        for ln in range(1, 17):
            for _ in range(counts[ln - 1]):
                sym = symbols[k]
                k += 1
                lo = code << (lut_bits - ln)
                hi = (code + 1) << (lut_bits - ln)
                self.lut[lo:hi] = (ln << 8) | sym
                code += 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over entropy-coded data with FF00 unstuffing."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 48 and self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0
                if nxt == 0x00:
                    self.pos += 1          # stuffed FF
                else:
                    self.pos -= 1          # a marker: stop feeding
                    b = None
                    break
            self.acc = (self.acc << 8) | b
            self.nbits += 8

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        if self.nbits >= 16:
            return (self.acc >> (self.nbits - 16)) & 0xFFFF
        return ((self.acc << (16 - self.nbits)) & 0xFFFF) if self.nbits \
            else 0

    def drop(self, n: int):
        if self.nbits < n:
            self._fill()
        take = min(n, self.nbits)
        self.nbits -= take
        self.acc &= (1 << self.nbits) - 1

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        if self.nbits < n:
            # past the end: pad with zeros (tolerate truncated streams)
            v = (self.acc << (n - self.nbits)) & ((1 << n) - 1)
            self.acc = 0
            self.nbits = 0
            return v
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def align_restart(self):
        """Drop to a byte boundary and consume an RSTn marker."""
        self.acc = 0
        self.nbits = 0
        d = self.data
        while self.pos < len(d) - 1:
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1


def _extend(v: int, n: int) -> int:
    """JPEG signed-magnitude extension (ITU T.81 F.2.2.1)."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def _decode_huff(r: _BitReader, h: _Huff) -> int:
    entry = int(h.lut[r.peek16()])
    ln = entry >> 8
    if ln == 0:
        raise ValueError("invalid Huffman code")
    r.drop(ln)
    return entry & 0xFF


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode baseline JPEG bytes → (H, W, 3) uint8 RGB (or (H, W, 1))."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    pos = 2
    qt: dict[int, np.ndarray] = {}
    hdc: dict[int, _Huff] = {}
    hac: dict[int, _Huff] = {}
    comps: list[dict] = []
    H = W = 0
    restart = 0

    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    tbl = np.frombuffer(seg[p:p + 128], ">u2").astype(
                        np.float64)
                    p += 128
                else:
                    tbl = np.frombuffer(seg[p:p + 64], np.uint8).astype(
                        np.float64)
                    p += 64
                qt[tq] = tbl
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = seg[p + 1:p + 17]
                n = sum(counts)
                syms = seg[p + 17:p + 17 + n]
                (hdc if tc == 0 else hac)[th] = _Huff(counts, syms)
                p += 17 + n
        elif marker == 0xC0:  # SOF0 baseline
            prec, H, W, nc = seg[0], *struct.unpack(">HH", seg[1:5]), seg[5]
            if prec != 8:
                raise ValueError("only 8-bit baseline JPEG supported")
            for i in range(nc):
                cid, hv, tq = seg[6 + i * 3:9 + i * 3]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError(f"unsupported JPEG SOF marker {marker:#x} "
                             "(progressive/extended)")
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:  # SOS → entropy data follows
            ns = seg[0]
            for i in range(ns):
                cs, tt = seg[1 + i * 2], seg[2 + i * 2]
                for c in comps:
                    if c["id"] == cs:
                        c["td"], c["ta"] = tt >> 4, tt & 15
            pos += seglen
            return _decode_scan(data, pos, comps, qt, hdc, hac, H, W,
                                restart)
        pos += seglen
    raise ValueError("no SOS marker found")


def _decode_scan(data, pos, comps, qt, hdc, hac, H, W, restart):
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-W // (8 * hmax))
    mcuy = -(-H // (8 * vmax))
    for c in comps:
        c["w"] = mcux * 8 * c["h"]
        c["hgt"] = mcuy * 8 * c["v"]
        c["plane"] = np.zeros((c["hgt"], c["w"]), np.float64)
        c["dc"] = 0
        c["q"] = qt[c["tq"]]                # zigzag (scan) order, like zz

    r = _BitReader(data[pos:])
    zz = np.zeros(64, np.float64)
    nmcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and nmcu and nmcu % restart == 0:
                r.align_restart()
                for c in comps:
                    c["dc"] = 0
            nmcu += 1
            for c in comps:
                dch, ach = hdc[c["td"]], hac[c["ta"]]
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        zz[:] = 0.0
                        t = _decode_huff(r, dch)
                        c["dc"] += _extend(r.bits(t), t)
                        zz[0] = c["dc"]
                        k = 1
                        while k < 64:
                            rs = _decode_huff(r, ach)
                            rr, ss = rs >> 4, rs & 15
                            if ss == 0:
                                if rr == 15:
                                    k += 16
                                    continue
                                break        # EOB
                            k += rr
                            if k > 63:
                                break
                            zz[k] = _extend(r.bits(ss), ss)
                            k += 1
                        coeffs = np.zeros(64, np.float64)
                        coeffs[ZIGZAG] = zz * c["q"]
                        blk = _C.T @ coeffs.reshape(8, 8) @ _C + 128.0
                        y0 = (my * c["v"] + by) * 8
                        x0 = (mx * c["h"] + bx) * 8
                        c["plane"][y0:y0 + 8, x0:x0 + 8] = blk

    # upsample to full resolution and crop.  Factor-2 axes use libjpeg's
    # triangular "fancy" filter (out[2i] = (3·p[i] + p[i−1] + 1)/4 with
    # edge replication) so results match common decoders; other factors
    # fall back to sample replication.
    def up2(p, axis):
        p = np.moveaxis(p, axis, 0)
        prev = np.concatenate([p[:1], p[:-1]])
        nxt = np.concatenate([p[1:], p[-1:]])
        out = np.empty((p.shape[0] * 2,) + p.shape[1:], p.dtype)
        out[0::2] = (3.0 * p + prev + 1.0) / 4.0
        out[1::2] = (3.0 * p + nxt + 2.0) / 4.0
        return np.moveaxis(out, 0, axis)

    planes = []
    for c in comps:
        p = c["plane"]
        fy, fx = vmax // c["v"], hmax // c["h"]
        # crop to the component's true extent before filtering so block
        # padding doesn't bleed into edge pixels
        p = p[: -(-H // fy), : -(-W // fx)]
        while fy > 1:
            p = up2(p, 0) if fy == 2 else np.repeat(p, fy, axis=0)
            fy = 1 if fy != 2 else fy // 2
        while fx > 1:
            p = up2(p, 1) if fx == 2 else np.repeat(p, fx, axis=1)
            fx = 1 if fx != 2 else fx // 2
        planes.append(p[:H, :W])

    if len(planes) == 1:
        y = np.clip(planes[0], 0, 255).astype(np.uint8)
        return y[..., None]
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    rgb = np.stack([
        y + 1.402 * cr,
        y - 0.344136 * cb - 0.714136 * cr,
        y + 1.772 * cb], axis=-1)
    return np.clip(rgb + 0.5, 0, 255).astype(np.uint8)
