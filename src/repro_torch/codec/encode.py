"""Baseline JFIF entropy encoder — the bit-exact twin of ``codec.bitstream``.

Takes per-component quantized zigzag coefficient tensors (the same
integers :func:`codec.bitstream.decode_jpeg` produces) and emits a
spec-conformant baseline JFIF byte string: SOI, APP0, DQT, SOF0, DHT
(the ISO/IEC 10918-1 Annex K "typical" Huffman tables), optional DRI,
SOS with DC prediction / run-length / Huffman coding, EOI.

Round trip: ``decode_jpeg(encode_baseline(...))`` returns the input
coefficients **bit-exactly** (entropy coding is lossless), which is what
the codec conformance tests lean on; third-party decoders (libjpeg/PIL)
accept the output, which is what pins the bitstream format itself.

Value range: the Annex K tables cover DC difference size categories up to
11 and AC size categories up to 10, exactly the range reachable from
8-bit samples (|AC| ≤ 1023, |DC diff| ≤ 2047).  Out-of-range inputs raise
rather than emitting an undecodable stream.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import dct as dctlib
from repro_torch.codec import bitstream as bs

__all__ = ["encode_baseline", "encode_pixels", "quantize_pixels",
           "STD_HUFFMAN"]


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

#: (counts, symbols) per (kind, class) — exported so tests can build
#: decoder LUTs from the exact tables the encoder writes.
STD_HUFFMAN = {k: (np.asarray(c, np.uint8), np.asarray(s, np.uint8))
               for k, (c, s) in _STD.items()}


def _code_map(kind: str, cls: int) -> dict[int, tuple[int, int]]:
    """symbol -> (code, length) for a standard table (canonical codes)."""
    counts, symbols = STD_HUFFMAN[(kind, cls)]
    out: dict[int, tuple[int, int]] = {}
    code, si = 0, 0
    for length in range(1, 17):
        for _ in range(int(counts[length - 1])):
            out[int(symbols[si])] = (code, length)
            si += 1
            code += 1
        code <<= 1
    return out


class _BitWriter:
    """MSB-first bit accumulator with JPEG 0xFF byte stuffing."""

    __slots__ = ("out", "acc", "nbits")

    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, length: int) -> None:
        if length == 0:
            return
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)  # pad with 1-bits (spec §F.1.2.3)
        return bytes(self.out)


def _size_category(v: int) -> int:
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def _value_bits(v: int, s: int) -> int:
    """Inverse of EXTEND: the low ``s`` bits that encode signed ``v``."""
    return v if v >= 0 else v + (1 << s) - 1


def _encode_block(w: _BitWriter, zz: np.ndarray, pred: int,
                  dc_map, ac_map) -> int:
    diff = int(zz[0]) - pred
    s = _size_category(diff)
    if s > 11:
        raise ValueError(f"DC difference {diff} exceeds size category 11")
    code, length = dc_map[s]
    w.put(code, length)
    w.put(_value_bits(diff, s), s)
    run = 0
    last = int(np.max(np.nonzero(zz)[0])) if np.any(zz[1:]) else 0
    for k in range(1, dctlib.NFREQ):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            code, length = ac_map[0xF0]  # ZRL
            w.put(code, length)
            run -= 16
        s = _size_category(v)
        if s > 10:
            raise ValueError(f"AC coefficient {v} exceeds size category 10")
        code, length = ac_map[(run << 4) | s]
        w.put(code, length)
        w.put(_value_bits(v, s), s)
        run = 0
    if last < dctlib.NFREQ - 1:
        code, length = ac_map[0x00]  # EOB
        w.put(code, length)
    return int(zz[0])


def _seg(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode_baseline(
    components: list[np.ndarray],
    qtables: list[np.ndarray],
    *,
    width: int | None = None,
    height: int | None = None,
    sampling: list[tuple[int, int]] | None = None,
    restart_interval: int = 0,
) -> bytes:
    """Entropy-encode quantized zigzag coefficients into baseline JFIF bytes.

    ``components[i]`` is ``(blocks_y, blocks_x, 64)`` integer zigzag
    coefficients on component ``i``'s sampling grid; ``qtables[i]`` its
    zigzag quantization vector (integer 1..65535; values > 255 use 16-bit
    DQT precision).  Component 0 is coded with the luminance Annex K
    tables, the rest with the chrominance ones.  ``sampling`` gives
    per-component (h, v) factors (default all (1, 1) = 4:4:4); grids must
    be full-MCU multiples of them.  ``width``/``height`` default to the
    full coefficient grid in pixels.
    """
    ncomp = len(components)
    if ncomp not in (1, 3):
        raise ValueError(f"1 or 3 components, got {ncomp}")
    if len(qtables) != ncomp:
        raise ValueError("need one quantization table per component")
    sampling = sampling or [(1, 1)] * ncomp
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    comps = [np.asarray(c) for c in components]
    for i, (c, (h, v)) in enumerate(zip(comps, sampling)):
        if c.ndim != 3 or c.shape[-1] != dctlib.NFREQ:
            raise ValueError(f"component {i}: want (by, bx, 64), "
                             f"got {c.shape}")
        if c.shape[0] % v or c.shape[1] % h:
            raise ValueError(f"component {i}: grid {c.shape[:2]} not a "
                             f"multiple of sampling ({v}, {h})")
    mcuy = comps[0].shape[0] // sampling[0][1]
    mcux = comps[0].shape[1] // sampling[0][0]
    for i, (c, (h, v)) in enumerate(zip(comps, sampling)):
        if (c.shape[0] // v, c.shape[1] // h) != (mcuy, mcux):
            raise ValueError(f"component {i}: MCU grid mismatch")
    if height is None:
        height = mcuy * vmax * dctlib.BLOCK
    if width is None:
        width = mcux * hmax * dctlib.BLOCK

    out = bytearray(b"\xff\xd8")  # SOI
    out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")

    # DQT — dedupe identical tables; 16-bit precision when needed
    table_ids: list[int] = []
    seen: list[np.ndarray] = []
    for q in qtables:
        q = np.asarray(q, np.int64).reshape(dctlib.NFREQ)
        if np.any(q < 1) or np.any(q > 65535):
            raise ValueError("quantization entries must be in [1, 65535]")
        for tid, prev in enumerate(seen):
            if np.array_equal(prev, q):
                table_ids.append(tid)
                break
        else:
            table_ids.append(len(seen))
            seen.append(q)
    for tid, q in enumerate(seen):
        if q.max() > 255:
            body = bytes([0x10 | tid]) + b"".join(
                int(v).to_bytes(2, "big") for v in q)
        else:
            body = bytes([tid]) + bytes(int(v) for v in q)
        out += _seg(bs.DQT, body)

    # SOF0
    sof = bytearray([8])
    sof += int(height).to_bytes(2, "big") + int(width).to_bytes(2, "big")
    sof.append(ncomp)
    for i, (h, v) in enumerate(sampling):
        sof += bytes([i + 1, (h << 4) | v, table_ids[i]])
    out += _seg(bs.SOF0, sof)

    # DHT — the Annex K tables actually used
    classes = [0] if ncomp == 1 else [0, 1]
    for cls in classes:
        for tc, kind in ((0, "dc"), (1, "ac")):
            counts, symbols = STD_HUFFMAN[(kind, cls)]
            out += _seg(bs.DHT, bytes([(tc << 4) | cls]) + bytes(counts)
                        + bytes(symbols))

    if restart_interval:
        out += _seg(bs.DRI, int(restart_interval).to_bytes(2, "big"))

    # SOS header
    sos = bytearray([ncomp])
    for i in range(ncomp):
        cls = 0 if i == 0 else 1
        sos += bytes([i + 1, (cls << 4) | cls])
    sos += bytes([0, 63, 0])  # Ss, Se, Ah/Al — fixed for baseline
    out += _seg(bs.SOS, sos)

    # entropy-coded data
    maps = [( _code_map("dc", 0 if i == 0 else 1),
              _code_map("ac", 0 if i == 0 else 1)) for i in range(ncomp)]
    n_mcus = mcuy * mcux
    preds = [0] * ncomp
    w = _BitWriter()
    rst = 0
    for mcu in range(n_mcus):
        if restart_interval and mcu and mcu % restart_interval == 0:
            out += w.flush()
            out += bytes([0xFF, bs.RST0 + rst])
            rst = (rst + 1) % 8
            w = _BitWriter()
            preds = [0] * ncomp
        my, mx = divmod(mcu, mcux)
        for i, (c, (h, v)) in enumerate(zip(comps, sampling)):
            dc_map, ac_map = maps[i]
            for vy in range(v):
                for vx in range(h):
                    preds[i] = _encode_block(
                        w, c[my * v + vy, mx * h + vx], preds[i],
                        dc_map, ac_map)
    out += w.flush()
    out += b"\xff\xd9"  # EOI
    return bytes(out)


# --------------------------------------------------------------------------
# Pixel-level convenience encoder (synthetic corpora → real JPEG bytes)
# --------------------------------------------------------------------------


def quantize_pixels(img: np.ndarray, qtable: np.ndarray, *,
                    pixel_scale: float = 128.0) -> np.ndarray:
    """Steps 1–5 for one plane: ``(H, W)`` pixels in ~[-1, 1) → quantized
    zigzag integers ``(H/8, W/8, 64)`` under quantization vector ``qtable``.

    The orthonormal 8×8 DCT coincides with the JPEG standard's definition,
    and the network convention ``x = (p − 128)/128`` makes the file-domain
    coefficients exactly ``pixel_scale ·`` the network-domain ones — so
    this is ``round(DCT(x) · 128 / q)``, the bit-true file integers.
    """
    h, w = img.shape
    b = dctlib.BLOCK
    if h % b or w % b:
        raise ValueError(f"plane ({h}x{w}) not divisible into 8x8 blocks")
    blocks = img.reshape(h // b, b, w // b, b).transpose(0, 2, 1, 3)
    coef = dctlib.dct2(blocks.astype(np.float64)) * pixel_scale
    zz = coef.reshape(h // b, w // b, dctlib.NFREQ)[
        ..., dctlib.zigzag_permutation()]
    q = np.asarray(qtable, np.float64).reshape(dctlib.NFREQ)
    return np.rint(zz / q).astype(np.int32)


def encode_pixels(img: np.ndarray, *, quality: int = 50,
                  qtable: np.ndarray | None = None,
                  subsample: bool = False,
                  restart_interval: int = 0) -> bytes:
    """Encode ``(H, W)`` or ``(C, H, W)`` pixels in ~[-1, 1) to baseline
    JFIF bytes (the repo's canonical quantization table by default).

    This is how the synthetic corpora become *real compressed traffic*
    for the bytes-in serving path and the ingest benchmarks: channels are
    treated as the file's components directly (the network is
    colorspace-agnostic).  ``subsample=True`` writes 4:2:0 — chroma is
    2×2 box-averaged before the DCT, exercising the coefficient-domain
    upsampling on decode.
    """
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        img = img[None]
    c, h, w = img.shape
    q = (np.asarray(qtable, np.int64) if qtable is not None
         else np.rint(dctlib.quantization_table(quality)).astype(np.int64))
    if subsample and c > 1:
        if h % 16 or w % 16:
            raise ValueError("4:2:0 needs dims divisible by 16")
        comps = [quantize_pixels(img[0], q)]
        for i in range(1, c):
            sub = img[i].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
            comps.append(quantize_pixels(sub, q))
        sampling = [(2, 2)] + [(1, 1)] * (c - 1)
    else:
        comps = [quantize_pixels(img[i], q) for i in range(c)]
        sampling = [(1, 1)] * c
    return encode_baseline(comps, [q] * c, width=w, height=h,
                           sampling=sampling,
                           restart_interval=restart_interval)
