"""A baseline JFIF encoder: the traffic's JPEG files.

Frozen from the port's ``codec/encode.py`` (the Annex K.3 typical Huffman
tables of ISO/IEC 10918-1, 4:4:4 components, no restart markers), so a later
change to the port's encoder cannot change the benchmark's inputs.  It walks
only a block's nonzero coefficients; the bytes are those a full scan of the
block would write.
"""
from __future__ import annotations

import functools

import numpy as np

SOI, EOI, SOS, DQT, DHT, SOF0 = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xC0

# ISO/IEC 10918-1 Annex K.3 typical Huffman tables: (counts[16], symbols).
_STD = {
    # K.3.1 luminance DC
    ("dc", 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                list(range(12))),
    # K.3.2 chrominance DC
    ("dc", 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                list(range(12))),
    # K.3.3.1 luminance AC
    ("ac", 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
                [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
                 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
                 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
                 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
                 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
                 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
                 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
                 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
                 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
                 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
                 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
                 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
                 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
                 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
                 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
                 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
                 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
                 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
                 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
                 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
                 0xF9, 0xFA]),
    # K.3.3.2 chrominance AC
    ("ac", 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
                 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
                 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
                 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
                 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
                 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
                 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
                 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
                 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
                 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
                 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
                 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
                 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
                 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
                 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
                 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
                 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
                 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
                 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
                 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
                 0xF9, 0xFA]),
}


@functools.lru_cache(maxsize=None)
def _codes(kind: str, cls: int) -> dict[int, tuple[int, int]]:
    """symbol -> (code, length): the canonical codes of a table."""
    counts, symbols = _STD[(kind, cls)]
    out, code, si = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[si]] = (code, length)
            si += 1
            code += 1
        code <<= 1
    return out


class _Bits:
    """MSB-first bit writer with 0xFF byte stuffing."""

    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            pad = 8 - self.n
            self.put((1 << pad) - 1, pad)
        return bytes(self.out)


def _size(v: int) -> int:
    return abs(v).bit_length()


def _bits(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


def _block(w: _Bits, zz: np.ndarray, pred: int, dc, ac) -> int:
    dc_v = int(zz[0])
    diff = dc_v - pred
    s = _size(diff)
    if s > 11:
        raise ValueError(f"DC difference {diff} exceeds size category 11")
    w.put(*dc[s])
    if s:
        w.put(_bits(diff, s), s)
    prev = 0
    for k in np.flatnonzero(zz[1:]) + 1:
        v = int(zz[k])
        run = int(k) - prev - 1
        while run > 15:
            w.put(*ac[0xF0])      # ZRL
            run -= 16
        s = _size(v)
        if s > 10:
            raise ValueError(f"AC coefficient {v} exceeds size category 10")
        w.put(*ac[(run << 4) | s])
        w.put(_bits(v, s), s)
        prev = int(k)
    if prev < 63:
        w.put(*ac[0x00])          # EOB
    return dc_v


def _seg(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode(components: np.ndarray, qtable: np.ndarray) -> bytes:
    """Baseline JFIF bytes of ``components`` ``(C, by, bx, 64)`` integer
    zigzag coefficients (C = 1 or 3, full resolution each), all under the
    zigzag table ``qtable`` (integers 1..255)."""
    comps = np.asarray(components, np.int64)
    ncomp, by, bx, _ = comps.shape
    q = np.asarray(qtable, np.int64).reshape(64)
    if ncomp not in (1, 3) or q.min() < 1 or q.max() > 255:
        raise ValueError("1 or 3 components and 8-bit table entries")
    out = bytearray([0xFF, SOI])
    out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _seg(DQT, bytes([0]) + bytes(int(v) for v in q))
    sof = bytearray([8]) + (by * 8).to_bytes(2, "big") \
        + (bx * 8).to_bytes(2, "big") + bytes([ncomp])
    for i in range(ncomp):
        sof += bytes([i + 1, 0x11, 0])
    out += _seg(SOF0, bytes(sof))
    classes = [0] if ncomp == 1 else [0, 1]
    for cls in classes:
        for tc, kind in ((0, "dc"), (1, "ac")):
            counts, symbols = _STD[(kind, cls)]
            out += _seg(DHT, bytes([(tc << 4) | cls]) + bytes(counts)
                        + bytes(symbols))
    sos = bytearray([ncomp])
    for i in range(ncomp):
        cls = 0 if i == 0 else 1
        sos += bytes([i + 1, (cls << 4) | cls])
    out += _seg(SOS, bytes(sos) + bytes([0, 63, 0]))
    maps = [(_codes("dc", min(i, 1)), _codes("ac", min(i, 1)))
            for i in range(ncomp)]
    preds = [0] * ncomp
    w = _Bits()
    for y in range(by):
        for x in range(bx):
            for i in range(ncomp):
                preds[i] = _block(w, comps[i, y, x], preds[i], *maps[i])
    out += w.flush()
    out += bytes([0xFF, EOI])
    return bytes(out)
