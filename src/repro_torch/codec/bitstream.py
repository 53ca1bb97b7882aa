"""Baseline JFIF bitstream parser + numpy Huffman entropy decoder.

This is the ingest half of the compressed-domain serving story: raw JPEG
bytes go to **quantized zigzag coefficients** — the file's own step-5
integers — without ever materialising pixels.  ``codec.normalize`` then
rescales them into the network's canonical quantization-table convention
and ``codec.ingest`` packs batches for the compiled plan.

Scope: baseline sequential DCT (SOF0), 8-bit precision, Huffman entropy
coding, optional restart intervals — i.e. the JFIF files libjpeg emits by
default.  Progressive (SOF2) and arithmetic coding raise
:class:`UnsupportedJpegError` loudly rather than mis-decoding.

Decoder shape
-------------
The entropy decode is structured for numpy rather than per-bit python:

* each entropy-coded segment is byte-unstuffed **vectorially** (drop the
  ``0x00`` after every ``0xFF``);
* a 24-bit window array over the unstuffed bytes is precomputed in one
  vector pass (8 bytes per input byte — never a per-bit expansion), so
  peeking the next 16 bits at any bit position is one index + shift;
* per Huffman table a flat 2¹⁶ lookup table maps the next 16 bits to
  ``(symbol, code length)`` — the canonical-code walk of spec §F.16
  collapses to ``lut[peek]``, and RECEIVE of ``s`` value bits is the
  same peek shifted.

Only the MCU walk itself (a few symbols per block) remains a python loop.

Coefficients come out in **zigzag order** (the file's native order, which
is also the repo-wide convention — ``core.dct.zigzag_permutation``), with
the DC prediction already undone, one ``(blocks_y, blocks_x, 64)`` int32
array per component on that component's own (MCU-padded) sampling grid.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from repro_torch.core import dct as dctlib

__all__ = [
    "CodecError",
    "JpegError",
    "TruncatedJpegError",
    "MarkerError",
    "HuffmanError",
    "EntropyError",
    "UnsupportedJpegError",
    "HuffmanTable",
    "FrameComponent",
    "DecodedJpeg",
    "Scan",
    "WalkArrays",
    "build_huffman_lut",
    "parse_segments",
    "prepare_scan",
    "decode_segment",
    "assemble_blocks",
    "decode_scan",
    "decode_jpeg",
]

# marker bytes (second byte after 0xFF)
SOI, EOI, SOS, DQT, DHT, DRI, COM = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xFE
SOF0 = 0xC0
DAC = 0xCC  # arithmetic-coding conditioning — arithmetic streams only
RST0, RST7 = 0xD0, 0xD7
_SOF_ALL = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}  # SOFn family
_SUPPORTED_SOF = {0xC0, 0xC1}  # baseline + extended sequential (Huffman)

#: human names for the SOFn variants this decoder rejects.
_SOF_KIND = {
    0xC2: "progressive (SOF2)",
    0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "differential arithmetic-coded sequential (SOF13)",
    0xCE: "differential arithmetic-coded progressive (SOF14)",
    0xCF: "differential arithmetic-coded lossless (SOF15)",
}

_UNSUPPORTED_HINT = (
    "supported markers are SOF0 (baseline) and SOF1 (extended sequential "
    "Huffman) — re-encode the file as baseline (libjpeg/PIL defaults), or "
    'see the ROADMAP item "progressive (SOF2) decode" for the planned '
    "extension")


def _rebuild_codec_error(cls, message, offset, marker):
    """Unpickle helper (module-level so spawn pool workers can ship
    :class:`CodecError` instances back to the parent with context intact)."""
    return cls(message, offset=offset, marker=marker)


class CodecError(ValueError):
    """Base of the codec error hierarchy: malformed, truncated, or
    unsupported compressed input.

    Carries structured context for fault isolation and debugging:
    ``offset`` — the byte offset of the failure (relative to the buffer
    being parsed: file-relative during marker parsing, segment-relative
    during entropy decode) — and ``marker`` — the JPEG marker byte being
    handled, when one is implicated.  Both land in ``str(err)``.

    A ``CodecError`` means *this input* is bad, never that the decoder is
    unhealthy: the serving stack fails the offending request individually
    and keeps serving (``serving.scheduler``), and these errors do not
    feed the circuit breaker.  Subclasses ``ValueError`` so pre-existing
    ``except ValueError`` call sites keep working.
    """

    def __init__(self, message: str, *, offset: int | None = None,
                 marker: int | None = None):
        self.raw_message = message
        self.offset = offset
        self.marker = marker
        ctx = []
        if marker is not None:
            ctx.append(f"marker 0x{marker:02X}")
        if offset is not None:
            ctx.append(f"byte {offset}")
        super().__init__(message + (f" [{', '.join(ctx)}]" if ctx else ""))

    def __reduce__(self):  # keep offset/marker across process boundaries
        return (_rebuild_codec_error,
                (type(self), self.raw_message, self.offset, self.marker))


class JpegError(CodecError):
    """Malformed or truncated JPEG bitstream."""


class TruncatedJpegError(JpegError):
    """The stream ended before the structure it promised (cut file,
    missing EOI, segment shorter than its length field)."""


class MarkerError(JpegError):
    """Structurally invalid marker sequence or segment body."""


class HuffmanError(JpegError):
    """Inconsistent or overfull Huffman table definition (DHT)."""


class EntropyError(JpegError):
    """The entropy-coded data itself is invalid: unknown Huffman prefix,
    bit reads past the segment, coefficient runs past the block.
    ``offset`` is the bit cursor's byte position *within the segment*."""


class UnsupportedJpegError(JpegError):
    """Valid JPEG, but outside the baseline-sequential scope."""


class HuffmanTable(NamedTuple):
    """A decoded DHT table plus its flat 16-bit decode LUT.

    ``lut[peek]`` packs ``(symbol << 8) | code_length`` for the code that
    prefixes the 16-bit window ``peek``; ``-1`` marks invalid prefixes.
    """

    counts: np.ndarray   # (16,) codes per length 1..16
    symbols: np.ndarray  # (sum(counts),) symbol values
    lut: np.ndarray      # (65536,) int32


class FrameComponent(NamedTuple):
    ident: int   # component id from SOF (1=Y, 2=Cb, 3=Cr conventionally)
    h: int       # horizontal sampling factor
    v: int       # vertical sampling factor
    tq: int      # quantization table id


class DecodedJpeg(NamedTuple):
    """Entropy-decoded file: quantized zigzag coefficients, no pixels.

    ``coefficients[i]`` is ``(blocks_y, blocks_x, 64)`` int32 on component
    ``i``'s MCU-padded grid; ``blocks(i)`` gives the true (unpadded) block
    dims.  ``qtables`` are the file's zigzag-ordered DQT vectors.
    """

    width: int
    height: int
    components: tuple[FrameComponent, ...]
    qtables: dict[int, np.ndarray]
    coefficients: list[np.ndarray]
    restart_interval: int = 0

    def blocks(self, i: int) -> tuple[int, int]:
        """True (blocks_y, blocks_x) of component ``i`` before MCU padding."""
        c = self.components[i]
        hmax = max(fc.h for fc in self.components)
        vmax = max(fc.v for fc in self.components)
        w = -(-self.width * c.h // hmax)   # ceil(width * h / hmax)
        h = -(-self.height * c.v // vmax)
        return -(-h // dctlib.BLOCK), -(-w // dctlib.BLOCK)

    def qtable(self, i: int) -> np.ndarray:
        return self.qtables[self.components[i].tq]


# --------------------------------------------------------------------------
# Huffman tables
# --------------------------------------------------------------------------


def build_huffman_lut(counts: np.ndarray, symbols: np.ndarray) -> HuffmanTable:
    """Canonical-code LUT: every 16-bit window starting with code ``c`` of
    length ``l`` maps to that code's symbol (spec §C.2 code assignment)."""
    counts = np.asarray(counts, np.int64)
    symbols = np.asarray(symbols, np.int64)
    if counts.shape != (16,) or symbols.shape[0] != int(counts.sum()):
        raise HuffmanError("inconsistent DHT counts/symbols", marker=DHT)
    lut = np.full(1 << 16, -1, np.int32)
    code = 0
    si = 0
    for length in range(1, 17):
        n = int(counts[length - 1])
        for _ in range(n):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            if hi > (1 << 16):
                raise HuffmanError("Huffman code overflows 16 bits",
                                   marker=DHT)
            lut[lo:hi] = (int(symbols[si]) << 8) | length
            si += 1
            code += 1
        code <<= 1
    return HuffmanTable(counts, symbols, lut)


@functools.lru_cache(maxsize=256)
def _cached_table(counts: bytes, symbols: bytes) -> HuffmanTable:
    """LUT build keyed on the DHT wire format.  Serving traffic reuses a
    handful of tables (often just Annex K's four), so rebuilding the 2¹⁶
    LUT per file would dominate parse time; the wire-format key also lets
    worker processes rebuild tables from pickled ``(counts, symbols)``
    bytes without ever shipping the LUTs themselves."""
    return build_huffman_lut(np.frombuffer(counts, np.uint8),
                             np.frombuffer(symbols, np.uint8))


# --------------------------------------------------------------------------
# Segment-level parsing
# --------------------------------------------------------------------------


def _u16(data: bytes, at: int) -> int:
    if at + 2 > len(data):
        raise TruncatedJpegError("truncated segment length", offset=at)
    return (data[at] << 8) | data[at + 1]


def parse_segments(data: bytes):
    """Yield ``(marker, payload, ecs, offset)`` tuples in file order.

    ``payload`` is the marker segment body (without the length field);
    ``ecs`` is the entropy-coded byte string following an SOS marker (up to
    but excluding the next non-RST marker), ``b""`` elsewhere.  RST markers
    stay embedded in ``ecs`` — the entropy decoder splits on them.
    ``offset`` is the file offset of the payload's first byte (of the
    position after the marker code for payload-less markers), so structural
    errors inside a segment can name their absolute byte position.
    """
    if data[:2] != b"\xff\xd8":
        raise MarkerError("missing SOI marker — not a JPEG", offset=0)
    yield SOI, b"", b"", 2
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise MarkerError("expected a marker", offset=pos)
        while pos < n and data[pos] == 0xFF:  # fill bytes are legal
            pos += 1
        if pos >= n:
            raise TruncatedJpegError("truncated marker", offset=pos)
        marker = data[pos]
        pos += 1
        if marker == EOI:
            yield EOI, b"", b"", pos
            return
        if RST0 <= marker <= RST7 or marker == 0x01:
            yield marker, b"", b"", pos
            continue
        length = _u16(data, pos)
        if length < 2 or pos + length > n:
            raise MarkerError(f"bad segment length {length}", offset=pos,
                              marker=marker)
        payload = data[pos + 2: pos + length]
        payload_off = pos + 2
        pos += length
        ecs = b""
        if marker == SOS:
            # vector scan for the first 0xFF not followed by a stuffed 0x00
            # or an RST marker — the byte loop here dominated parse time
            start = pos
            arr = np.frombuffer(data, np.uint8)
            nxt = arr[start + 1: n]
            stop = np.nonzero((arr[start: n - 1] == 0xFF) & (nxt != 0x00)
                              & ~((RST0 <= nxt) & (nxt <= RST7)))[0]
            if stop.size == 0:
                raise TruncatedJpegError(
                    "entropy-coded data ran past end of file", offset=start,
                    marker=SOS)
            pos = start + int(stop[0])
            ecs = data[start:pos]
        yield marker, payload, ecs, payload_off
    raise TruncatedJpegError("missing EOI marker", offset=n)


def _parse_dqt(payload: bytes, qtables: dict[int, np.ndarray],
               base: int = 0) -> None:
    at = 0
    while at < len(payload):
        pq, tq = payload[at] >> 4, payload[at] & 0x0F
        at += 1
        n = dctlib.NFREQ
        if pq == 0:
            vals = np.frombuffer(payload[at:at + n], np.uint8)
            at += n
        elif pq == 1:
            vals = np.frombuffer(payload[at:at + 2 * n],
                                 np.uint8).reshape(n, 2)
            vals = vals[:, 0].astype(np.int64) * 256 + vals[:, 1]
            at += 2 * n
        else:
            raise MarkerError(f"bad DQT precision {pq}",
                              offset=base + at - 1, marker=DQT)
        if vals.shape[0] != n:
            raise TruncatedJpegError("truncated DQT", offset=base + at,
                                     marker=DQT)
        qtables[tq] = vals.astype(np.int64)


def _parse_dht(payload: bytes, tables: dict[tuple[int, int], HuffmanTable],
               base: int = 0) -> None:
    at = 0
    while at < len(payload):
        tc, th = payload[at] >> 4, payload[at] & 0x0F
        at += 1
        counts = np.frombuffer(payload[at:at + 16], np.uint8)
        if counts.shape[0] != 16:
            raise TruncatedJpegError("truncated DHT", offset=base + at,
                                     marker=DHT)
        at += 16
        total = int(counts.sum())
        symbols = np.frombuffer(payload[at:at + total], np.uint8)
        if symbols.shape[0] != total:
            raise TruncatedJpegError("truncated DHT symbols",
                                     offset=base + at, marker=DHT)
        at += total
        tables[(tc, th)] = _cached_table(counts.tobytes(), symbols.tobytes())


def _parse_sof(marker: int, payload: bytes, base: int = 0):
    if marker not in _SUPPORTED_SOF:
        kind = _SOF_KIND.get(marker, f"SOF{marker - 0xC0}")
        raise UnsupportedJpegError(f"{kind} JPEG; {_UNSUPPORTED_HINT}",
                                   marker=marker)
    if len(payload) < 6:
        raise TruncatedJpegError("truncated SOF", offset=base, marker=marker)
    precision = payload[0]
    if precision != 8:
        raise UnsupportedJpegError(f"{precision}-bit precision (want 8)",
                                   offset=base, marker=marker)
    height = (payload[1] << 8) | payload[2]
    width = (payload[3] << 8) | payload[4]
    ncomp = payload[5]
    if height == 0 or width == 0:
        raise UnsupportedJpegError("DNL-deferred dimensions not supported",
                                   offset=base, marker=marker)
    if ncomp == 0 or len(payload) < 6 + 3 * ncomp:
        raise TruncatedJpegError(f"SOF lists {ncomp} components in "
                                 f"{len(payload)} bytes", offset=base,
                                 marker=marker)
    comps = []
    for i in range(ncomp):
        cid, hv, tq = payload[6 + 3 * i: 9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 0x0F <= 4):
            raise MarkerError(f"component {cid} sampling factors "
                              f"{hv >> 4}x{hv & 0x0F} outside 1..4",
                              offset=base, marker=marker)
        comps.append(FrameComponent(cid, hv >> 4, hv & 0x0F, tq))
    return width, height, tuple(comps)


# --------------------------------------------------------------------------
# Entropy decoding
# --------------------------------------------------------------------------


def _unstuff(ecs: np.ndarray) -> np.ndarray:
    """Drop the stuffed 0x00 after every 0xFF (vectorised)."""
    if ecs.size == 0:
        return ecs
    drop = np.zeros(ecs.shape[0], bool)
    ff = ecs[:-1] == 0xFF
    drop[1:] = ff & (ecs[1:] == 0x00)
    bad = ff & (ecs[1:] != 0x00)
    if bad.any():
        raise EntropyError("unescaped marker inside entropy-coded segment",
                           offset=int(np.nonzero(bad)[0][0]))
    return ecs[~drop]


def _windows(raw: np.ndarray) -> tuple[np.ndarray, int]:
    """Unstuff ``raw`` and build the 24-bit peek windows.

    ``w24[i] = bytes[i:i+3]`` big-endian (padded with the spec's 1-bit
    pad value), so the 16 bits starting at bit position ``pos`` are
    ``(w24[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF`` — O(1) per peek,
    8 bytes of table per input byte.  Returns ``(w24, n_bits)``; shared
    by the scalar :class:`_BitReader` and the lockstep decoder
    (``codec.lockstep``), which concatenates many streams' windows.
    """
    data = _unstuff(raw)
    padded = np.concatenate([data,
                             np.full(3, 0xFF, np.uint8)]).astype(np.int64)
    w24 = (padded[:-2] << 16) | (padded[1:-1] << 8) | padded[2:]
    return w24, data.shape[0] * 8


class _BitReader:
    """Bit cursor over unstuffed bytes via precomputed 24-bit windows
    (see :func:`_windows`); reads past ``n`` are caught by the callers."""

    __slots__ = ("w24", "pos", "n")

    def __init__(self, raw: np.ndarray):
        self.w24, self.n = _windows(raw)
        self.pos = 0

    def _peek16(self, pos: int) -> int:
        return (int(self.w24[pos >> 3]) >> (8 - (pos & 7))) & 0xFFFF

    def read_code(self, table: HuffmanTable) -> int:
        if self.pos >= self.n:
            raise EntropyError("bit stream exhausted mid-block",
                               offset=self.pos >> 3)
        packed = int(table.lut[self._peek16(self.pos)])
        if packed < 0:
            raise EntropyError("invalid Huffman code", offset=self.pos >> 3)
        self.pos += packed & 0xFF
        if self.pos > self.n:
            raise EntropyError("Huffman code ran past end of segment",
                               offset=self.pos >> 3)
        return packed >> 8

    def receive(self, s: int) -> int:
        if s == 0:
            return 0
        if self.pos + s > self.n:
            raise EntropyError("value bits ran past end of segment",
                               offset=self.pos >> 3)
        v = self._peek16(self.pos) >> (16 - s)
        self.pos += s
        return v


def _extend(v: int, s: int) -> int:
    """Spec §F.12 EXTEND: map ``s`` received bits to a signed value."""
    if s == 0:
        return 0
    return v if v >= (1 << (s - 1)) else v - (1 << s) + 1


def _split_restarts(ecs: bytes) -> list[np.ndarray]:
    """Split an SOS entropy segment at embedded RST markers."""
    arr = np.frombuffer(ecs, np.uint8)
    if arr.size == 0:
        return [arr]
    is_rst = np.zeros(arr.shape[0], bool)
    ff = arr[:-1] == 0xFF
    is_rst[:-1] = ff & (arr[1:] >= RST0) & (arr[1:] <= RST7)
    cuts = np.where(is_rst)[0]
    parts, start = [], 0
    for c in cuts:
        parts.append(arr[start:c])
        start = c + 2  # skip FF Dn
    parts.append(arr[start:])
    return parts


def _decode_block(br: _BitReader, dc: HuffmanTable, ac: HuffmanTable,
                  out: np.ndarray) -> int:
    """Decode one block's coefficients into ``out`` (64,); returns DC diff."""
    s = br.read_code(dc)
    if s > 15:
        raise EntropyError(f"bad DC size category {s}", offset=br.pos >> 3)
    diff = _extend(br.receive(s), s)
    k = 1
    while k < dctlib.NFREQ:
        rs = br.read_code(ac)
        r, s = rs >> 4, rs & 0x0F
        if s == 0:
            if r == 15:       # ZRL: sixteen zeros
                k += 16
                continue
            break             # EOB
        k += r
        if k >= dctlib.NFREQ:
            raise EntropyError("AC run past end of block",
                               offset=br.pos >> 3)
        out[k] = _extend(br.receive(s), s)
        k += 1
    return diff


class WalkArrays(NamedTuple):
    """Vectorised MCU-walk: for every block of the scan, in entropy-decode
    order, its component index, scan-component slot (→ Huffman table
    pair), and target grid position.  ``per_mcu`` blocks per MCU."""

    ci: np.ndarray  # (n_blocks,) int16 component index
    j: np.ndarray   # (n_blocks,) int16 scan-component slot
    y: np.ndarray   # (n_blocks,) int32 block row on the component grid
    x: np.ndarray   # (n_blocks,) int32 block col on the component grid
    per_mcu: int


class Scan(NamedTuple):
    """A parsed + validated single-scan file, ready for entropy decode.

    ``segments`` are the (still stuffed) entropy-coded byte runs between
    restart markers; ``seg_mcus[i]`` is segment ``i``'s half-open MCU
    range.  Every segment resets the DC predictors and bit alignment, so
    each ``(segment, mcu_range)`` pair is independently decodable — the
    unit of work for both the scalar reference loop and the parallel
    decoders (``codec.lockstep``, the ingest worker pool).
    """

    width: int
    height: int
    comps: tuple[FrameComponent, ...]
    qtables: dict[int, np.ndarray]
    restart_interval: int
    order: tuple[int, ...]
    tables: tuple[tuple[HuffmanTable, HuffmanTable], ...]
    interleaved: bool
    grid: tuple[tuple[int, int], ...]  # per component (blocks_y, blocks_x)
    mcux: int
    n_mcus: int
    segments: list[np.ndarray]
    seg_mcus: tuple[tuple[int, int], ...]

    @property
    def walk(self) -> WalkArrays:
        hv = tuple((c.h, c.v) for c in self.comps)
        return _walk_arrays(self.interleaved, self.order, hv, self.grid,
                            self.mcux, self.n_mcus)

    @property
    def n_blocks(self) -> int:
        return self.n_mcus * self.walk.per_mcu


@functools.lru_cache(maxsize=256)
def _walk_arrays(interleaved, order, hv, grid, mcux, n_mcus) -> WalkArrays:
    if interleaved:
        tpl = []
        for jj, ci in enumerate(order):
            h, v = hv[ci]
            for vy in range(v):
                for vx in range(h):
                    tpl.append((ci, jj, vy, vx, v, h))
        t = np.tile(np.asarray(tpl, np.int64), (n_mcus, 1))
        per_mcu = len(tpl)
        m = np.repeat(np.arange(n_mcus, dtype=np.int64), per_mcu)
        ci, j = t[:, 0], t[:, 1]
        y = (m // mcux) * t[:, 4] + t[:, 2]
        x = (m % mcux) * t[:, 5] + t[:, 3]
    else:
        # single-component scan: the MCU is one block on the component's
        # own grid
        per_mcu = 1
        _, bx = grid[order[0]]
        ar = np.arange(n_mcus, dtype=np.int64)
        ci = np.full(n_mcus, order[0], np.int64)
        j = np.zeros(n_mcus, np.int64)
        y, x = ar // bx, ar % bx
    return WalkArrays(ci.astype(np.int16), j.astype(np.int16),
                      y.astype(np.int32), x.astype(np.int32), per_mcu)


def prepare_scan(data: bytes) -> Scan:
    """Parse + validate baseline JFIF bytes up to (but excluding) the
    entropy decode: markers, tables, scan geometry, restart segmentation.

    All structural errors are raised here; what remains is the pure
    per-segment bit consumption, so callers can fan the returned
    ``(segment, mcu_range)`` pairs out to parallel decoders.
    """
    qtables: dict[int, np.ndarray] = {}
    huffman: dict[tuple[int, int], HuffmanTable] = {}
    frame = None
    restart_interval = 0
    scan = None

    for marker, payload, ecs, off in parse_segments(data):
        if marker == DQT:
            _parse_dqt(payload, qtables, base=off)
        elif marker == DHT:
            _parse_dht(payload, huffman, base=off)
        elif marker == DAC:
            raise UnsupportedJpegError(
                "arithmetic-coded JPEG (DAC conditioning marker); "
                + _UNSUPPORTED_HINT, offset=off, marker=DAC)
        elif marker == DRI:
            restart_interval = _u16(payload, 0)
        elif marker in _SOF_ALL:
            if frame is not None:
                raise UnsupportedJpegError("multi-frame (hierarchical) JPEG",
                                           offset=off, marker=marker)
            frame = _parse_sof(marker, payload, base=off)
        elif marker == SOS:
            if frame is None:
                raise MarkerError("SOS before SOF", offset=off, marker=SOS)
            if scan is not None:
                raise UnsupportedJpegError("multi-scan JPEG (progressive?)",
                                           offset=off, marker=SOS)
            scan = (payload, ecs)
        # APPn / COM / others: skipped

    if frame is None or scan is None:
        raise MarkerError("no image data (missing SOF/SOS)")
    width, height, comps = frame
    payload, ecs = scan
    ns = payload[0]
    if ns != len(comps):
        raise UnsupportedJpegError("partial-component scan", marker=SOS)
    by_id = {c.ident: i for i, c in enumerate(comps)}
    order, tables = [], []
    for j in range(ns):
        cs, tdta = payload[1 + 2 * j: 3 + 2 * j]
        if cs not in by_id:
            raise MarkerError(f"scan references unknown component {cs}",
                              marker=SOS)
        order.append(by_id[cs])
        td, ta = tdta >> 4, tdta & 0x0F
        try:
            tables.append((huffman[(0, td)], huffman[(1, ta)]))
        except KeyError as e:
            raise MarkerError(f"scan references missing Huffman table {e}",
                              marker=SOS)
    for c in comps:
        if c.tq not in qtables:
            raise MarkerError(
                f"component quantization table {c.tq} missing", marker=SOS)

    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mcux = -(-width // (dctlib.BLOCK * hmax))
    mcuy = -(-height // (dctlib.BLOCK * vmax))
    interleaved = ns > 1
    if not interleaved:
        c = comps[order[0]]
        # non-interleaved: the MCU is one block on the component's own grid
        bx = -(-(-(-width * c.h // hmax)) // dctlib.BLOCK)
        by = -(-(-(-height * c.v // vmax)) // dctlib.BLOCK)
        grid = ((by, bx),)
        n_mcus = by * bx
    else:
        grid = tuple((mcuy * c.v, mcux * c.h) for c in comps)
        n_mcus = mcuy * mcux

    segments = _split_restarts(ecs)
    expected = (-(-n_mcus // restart_interval)
                if restart_interval else 1)
    if (restart_interval and len(segments) == expected + 1
            and segments[-1].size == 0):
        # benign encoder shape: a restart marker emitted after the final
        # MCU row, immediately before EOI — an empty trailing segment
        # with no MCUs behind it.  Tolerate (drop) it; any non-empty
        # surplus segment is still a genuine mismatch below.
        segments = segments[:-1]
    if len(segments) != expected:
        raise MarkerError(
            f"restart markers disagree with DRI: {len(segments)} segments "
            f"for {n_mcus} MCUs at interval {restart_interval}")
    r = restart_interval or n_mcus
    seg_mcus = tuple((i * r, min((i + 1) * r, n_mcus))
                     for i in range(len(segments)))

    return Scan(width, height, comps, qtables, restart_interval,
                tuple(order), tuple(tables), interleaved, grid, mcux,
                n_mcus, segments, seg_mcus)


def decode_segment(scan: Scan, seg: np.ndarray, mcu0: int, mcu1: int
                   ) -> np.ndarray:
    """Decode one restart segment's blocks — the pure unit of parallelism.

    Returns ``(n_blocks, 64)`` int32 zigzag coefficients in MCU-walk
    order with the segment-local DC prediction undone.  Depends only on
    ``(scan tables/geometry, seg, mcu range)`` — never on neighbouring
    segments — because a restart resets both predictors and bit
    alignment.
    """
    walk = scan.walk
    b0, b1 = mcu0 * walk.per_mcu, mcu1 * walk.per_mcu
    br = _BitReader(seg)
    out = np.zeros((b1 - b0, dctlib.NFREQ), np.int32)
    preds = [0] * len(scan.comps)
    j_seq = walk.j[b0:b1].tolist()
    c_seq = walk.ci[b0:b1].tolist()
    for t in range(b1 - b0):
        dc_t, ac_t = scan.tables[j_seq[t]]
        ci = c_seq[t]
        preds[ci] += _decode_block(br, dc_t, ac_t, out[t])
        out[t, 0] = preds[ci]
    return out


def assemble_blocks(scan: Scan, blocks: np.ndarray) -> DecodedJpeg:
    """Scatter walk-ordered ``(n_blocks, 64)`` coefficients onto the
    per-component MCU-padded grids."""
    walk = scan.walk
    coef = [np.zeros((*scan.grid[i], dctlib.NFREQ), np.int32)
            for i in range(len(scan.comps))]
    for i in range(len(scan.comps)):
        m = walk.ci == i
        coef[i][walk.y[m], walk.x[m]] = blocks[m]
    return DecodedJpeg(scan.width, scan.height, scan.comps,
                       {k: v.copy() for k, v in scan.qtables.items()},
                       coef, scan.restart_interval)


def decode_scan(scan: Scan) -> DecodedJpeg:
    """Sequential reference decode: every segment through
    :func:`decode_segment`, in file order.  The parallel decoders are
    defined by producing bit-identical output to this loop."""
    parts = [decode_segment(scan, seg, m0, m1)
             for seg, (m0, m1) in zip(scan.segments, scan.seg_mcus)]
    blocks = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return assemble_blocks(scan, blocks)


def decode_jpeg(data: bytes) -> DecodedJpeg:
    """Entropy-decode baseline JFIF bytes to quantized zigzag coefficients.

    Bit-exact: the returned integers are the file's step-5 values with the
    DC prediction undone — re-encoding them (``codec.encode``) reproduces
    an equivalent bitstream, and ``codec.normalize`` turns them into the
    network's real-valued convention.  This is the sequential reference
    path; batched traffic goes through ``codec.ingest``, which fans
    restart segments across the lockstep decoder / worker pool and must
    match this function exactly.
    """
    return decode_scan(prepare_scan(data))
