"""Lockstep entropy decode: many restart segments advanced as one vector.

The per-symbol Huffman loop is the serving bottleneck (ROADMAP: the
``ingest`` benchmark row), and it cannot be vectorised *within* a stream
— the bit position after symbol ``k`` depends on symbol ``k``.  But DRI
restart segments are independently decodable by construction (each
resets the DC predictors and the bit alignment), so a *batch* of images
yields hundreds of independent bit streams: every image contributes one
stream per restart segment (a DRI-less image is one whole-file stream).

This module decodes all of them in lockstep: one numpy "iteration"
consumes exactly one Huffman code (plus its value bits) from **every**
still-active stream —

* peek 16 bits per stream from a concatenated 24-bit-window array
  (``bitstream._windows``), one gather + shift;
* one fused LUT gather ``luts[table_of_stream, peek]`` over the stacked
  per-table 2¹⁶ LUTs resolves symbol + code length for all streams;
* masked vector updates run the per-block state machine (DC size /
  EXTEND / AC run-length / ZRL / EOB) and scatter coefficients into a
  flat walk-ordered block matrix.

Python overhead is paid once per *symbol column* instead of once per
symbol: with ``S`` streams the interpreter cost drops by ``~S``, which
is what makes batched bytes→logits ingest faster than spatial
decompress-first serving even on one core.  Wall clock scales with the
longest stream, so restart intervals (balanced segments) help; skew only
costs idle lanes.

Correctness contract: **bit-exact** with the scalar reference
(``bitstream.decode_scan``).  Any stream that trips an error flag
(invalid code, overrun, bad DC size, AC run past end) aborts lockstep
for that *image only*, which is re-decoded on the scalar path so the
exact reference exception (or recovery) is reproduced.  Parity is
enforced by ``tests/test_codec_parallel.py`` across fixtures and
hypothesis round-trips.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import dct as dctlib
from repro_torch.codec import bitstream as bs

__all__ = ["LOCKSTEP_MIN_STREAMS", "LOCKSTEP_MIN_PARALLEL", "count_streams",
           "parallelism", "prefers_lockstep", "decode_scans"]

#: below this many independent streams the vector overhead outweighs the
#: amortisation and the scalar loop wins; callers use :func:`count_streams`
#: to pick a path.
LOCKSTEP_MIN_STREAMS = 8

#: a lockstep step costs the same whether one stream is active or all
#: are, and the loop runs as many steps as the longest stream has
#: symbols; so lockstep wins only where the batch's symbols spread over
#: enough streams.  :func:`parallelism` (total over longest) crosses
#: even with the scalar decoder at about 40 on a CPU host
#: (``tools/lockstep_crossover.py``); a batch of 8 images without
#: restart markers is about 6.
LOCKSTEP_MIN_PARALLEL = 48

_NF = dctlib.NFREQ


def _extend_lut() -> np.ndarray:
    """``ext[(s << 16) | peek16]`` = EXTEND(peek16 >> (16-s), s) — the
    spec §F.12 sign extension resolved straight from the 16-bit window,
    fusing RECEIVE+EXTEND into one gather (4 MiB, built once)."""
    lut = np.empty((16, 1 << 16), np.int32)
    peek = np.arange(1 << 16, dtype=np.int64)
    lut[0] = 0
    for s in range(1, 16):
        v = peek >> (16 - s)
        half = 1 << (s - 1)
        lut[s] = np.where(v >= half, v, v - 2 * half + 1)
    return lut.reshape(-1)


def _ac_luts() -> tuple[np.ndarray, np.ndarray]:
    """Per-AC-symbol ``k`` advance and EOB flag.

    ``adv[sym]``: 0 for EOB, 16 for ZRL, run+1 for a value symbol — the
    coefficient-index step after consuming the symbol (the value lands at
    ``k + run``, i.e. ``k_new - 1``).  ``eob[sym]``: size==0 and run<15.
    """
    sym = np.arange(256, dtype=np.int64)
    s, run = sym & 0x0F, sym >> 4
    adv = np.where(s > 0, run + 1, np.where(run == 15, 16, 0))
    return adv.astype(np.int32), ((s == 0) & (run < 15))


_EXT = _extend_lut()
_ADV, _EOB = _ac_luts()


def count_streams(scans: Sequence[bs.Scan]) -> int:
    """Total independently decodable bit streams across ``scans``."""
    return sum(len(s.segments) for s in scans)


def parallelism(scans: Sequence[bs.Scan]) -> float:
    """Total symbols over the longest stream's: how many streams a lockstep
    step advances on average.  Entropy-coded bytes stand in for symbols
    (each symbol with its value bits is a few bits), since they are known
    before decoding."""
    sizes = [int(seg.size) for sc in scans for seg in sc.segments]
    longest = max(sizes, default=0)
    return sum(sizes) / longest if longest else 0.0


def prefers_lockstep(scans: Sequence[bs.Scan]) -> bool:
    """Whether :func:`decode_scans` beats the scalar decoder on ``scans``:
    a :func:`parallelism` of at least ``LOCKSTEP_MIN_PARALLEL`` (which
    implies at least that many streams, so more than
    ``LOCKSTEP_MIN_STREAMS``).  Both decoders are bit-exact, so the choice
    changes only the time.  (The reference package chooses by the stream
    count alone.)"""
    return parallelism(scans) >= LOCKSTEP_MIN_PARALLEL


def _scalar(scan: bs.Scan) -> bs.DecodedJpeg:
    return bs.decode_scan(scan)


def decode_scans(scans: Sequence[bs.Scan]) -> list[bs.DecodedJpeg]:
    """Decode prepared scans jointly, one vector step per symbol column.

    Returns one :class:`bitstream.DecodedJpeg` per scan, bit-exact with
    :func:`bitstream.decode_scan`; scans whose streams flag an error fall
    back to the scalar reference decoder individually (reproducing its
    exception behaviour without poisoning the rest of the batch).
    """
    n_scans = len(scans)
    if n_scans == 0:
        return []

    # ---------------------------------------------------------- stream build
    # Stack every distinct Huffman LUT once; streams address tables by
    # stack index so one fused gather serves mixed-table traffic.
    stack_ix: dict[int, int] = {}
    luts: list[np.ndarray] = []

    def _tix(table: bs.HuffmanTable) -> int:
        key = id(table.lut)
        if key not in stack_ix:
            stack_ix[key] = len(luts)
            luts.append(table.lut)
        return stack_ix[key]

    fallback = np.zeros(n_scans, bool)
    streams: list[tuple[int, np.ndarray, int, int, int]] = []
    scan_tbl: list[tuple[np.ndarray, np.ndarray] | None] = []
    for si, sc in enumerate(scans):
        try:
            walk = sc.walk
            dc_of_j = np.array([_tix(sc.tables[j][0])
                                for j in range(len(sc.tables))], np.int16)
            ac_of_j = np.array([_tix(sc.tables[j][1])
                                for j in range(len(sc.tables))], np.int16)
            scan_tbl.append((dc_of_j[walk.j], ac_of_j[walk.j]))
            per = walk.per_mcu
            built = []
            for seg, (m0, m1) in zip(sc.segments, sc.seg_mcus):
                if m1 <= m0:
                    continue
                w24, nbits = bs._windows(seg)
                built.append((si, w24, nbits, m0 * per, m1 * per))
            streams.extend(built)
        except bs.JpegError:
            # e.g. an unescaped marker inside a segment: let the scalar
            # path raise it for this image alone
            scan_tbl.append(None)
            fallback[si] = True

    S = len(streams)
    if S == 0:
        return [_scalar(sc) for sc in scans]

    nb = np.array([b1 - b0 for _, _, _, b0, b1 in streams], np.int64)
    nbmax = int(nb.max())
    scan_of = np.array([si for si, *_ in streams], np.int64)

    lut_flat = np.concatenate(luts)  # table t at [t << 16, (t+1) << 16)

    # per-(stream, block) constants packed into one gatherable word:
    # dc table | ac table << 8 | component << 16
    TBL = np.zeros((S, nbmax), np.int32)
    ROW0 = np.zeros(S, np.int64)
    off = np.zeros(S, np.int64)
    nbits_s = np.zeros(S, np.int64)
    scan_rows = np.zeros(n_scans + 1, np.int64)
    chunks = []
    row = pos_w = 0
    pad = np.full(4, 0xFFFFFF, np.int32)  # overrun slack: no index clamp
    for i, (si, w24, nbits, b0, b1) in enumerate(streams):
        n = b1 - b0
        dcb, acb = scan_tbl[si]
        ci = scans[si].walk.ci[b0:b1].astype(np.int32)
        TBL[i, :n] = (dcb[b0:b1].astype(np.int32)
                      | (acb[b0:b1].astype(np.int32) << 8) | (ci << 16))
        ROW0[i] = row
        row += n
        off[i] = pos_w
        nbits_s[i] = nbits
        pos_w += w24.shape[0] + pad.shape[0]
        chunks.append(w24.astype(np.int32))
        chunks.append(pad)
        scan_rows[si + 1] = row
    np.maximum.accumulate(scan_rows, out=scan_rows)
    W = np.concatenate(chunks)
    tbl_flat = TBL.reshape(-1)
    OUT = np.zeros((row, _NF), np.int32)
    out_flat = OUT.reshape(-1)

    ncomp_max = max(len(sc.comps) for sc in scans)
    preds_flat = np.zeros(S * ncomp_max, np.int64)

    # ------------------------------------------------------------- main loop
    # Dynamic state is kept *compressed* to the active streams — no
    # per-iteration state gathers, flat 1-D fancy indexing only; arrays
    # shrink as streams finish.
    sid = np.nonzero(nb > 0)[0].astype(np.int64)
    p = np.zeros(sid.size, np.int64)    # bit cursor
    b = np.zeros(sid.size, np.int64)    # current block within stream
    kc = np.zeros(sid.size, np.int64)   # next coefficient index
    acp = np.zeros(sid.size, bool)      # False: expect DC code; True: AC
    off_c = off[sid]
    nbits_c = nbits_s[sid]
    nb_c = nb[sid]
    row0_c = ROW0[sid]
    tb_base = sid * nbmax               # flat index bases, kept compressed
    pr_base = sid * ncomp_max
    err_sids: list[np.ndarray] = []

    while sid.size:
        peek = (W[off_c + (p >> 3)] >> (8 - (p & 7))) & 0xFFFF
        tblw = tbl_flat[tb_base + b]
        tbl = (tblw >> (acp << 3)) & 0xFF  # dc table, or ac table if acp
        packed = lut_flat[(tbl.astype(np.int64) << 16) + peek]
        bad = packed < 0
        sym = (packed >> 8) & 0xFF  # garbage when bad; flagged below
        s = sym & 0x0F              # == sym for every legal DC size (<= 15)
        nacp = ~acp
        bad |= nacp & (sym > 15)    # DC size category > 15

        # invalid codes pack -1: their low byte reads as 255, which would
        # drive the speculative peek2 past the stream's pad words — hold
        # those lanes at p (they are flagged and discarded this iteration)
        p2 = p + np.where(packed < 0, 0, packed & 0xFF)
        peek2 = (W[off_c + (p2 >> 3)] >> (8 - (p2 & 7))) & 0xFFFF
        ext = _EXT[(s << 16) + peek2]
        p3 = p2 + s
        # a read past the segment's real bits means the scalar reference
        # would have raised (exhausted / ran past end); flag, don't decode
        errnow = bad | (p3 > nbits_c)
        ok = ~errnow

        rows = row0_c + b
        dcm = ok & nacp
        # DC: unmasked writes are safe — AC-phase lanes rewrite the value
        # their block's DC pass already stored (preds unchanged since),
        # and errored lanes' scans are discarded to the scalar fallback.
        pidx = pr_base + (tblw >> 16)
        preds_flat[pidx] += ext * dcm
        out_flat[rows << 6] = preds_flat[pidx]

        # AC bookkeeping via per-symbol LUTs: adv = 0 (EOB) / 16 (ZRL) /
        # run+1 (value, which lands at column k_new - 1)
        knew = kc + np.where(acp, _ADV[sym], 1)
        acok = ok & acp
        val = acok & (s > 0)
        run_err = val & (knew > _NF)  # k + run >= 64: run past block end
        val &= ~run_err
        out_flat[(rows[val] << 6) + knew[val] - 1] = ext[val]

        done = acok & (_EOB[sym] | (knew >= _NF))
        errnow |= run_err

        p = p3
        kc = knew * ~done
        acp = (acp | dcm) & ~done
        b = b + done
        rem = errnow | (done & (b == nb_c))
        if rem.any():
            if errnow.any():
                err_sids.append(sid[errnow])
            keep = ~rem
            sid, p, b, kc, acp = (sid[keep], p[keep], b[keep], kc[keep],
                                  acp[keep])
            off_c, nbits_c, nb_c, row0_c, tb_base, pr_base = (
                off_c[keep], nbits_c[keep], nb_c[keep], row0_c[keep],
                tb_base[keep], pr_base[keep])

    # ------------------------------------------------------------- assemble
    if err_sids:
        fallback[scan_of[np.concatenate(err_sids)]] = True
    out: list[bs.DecodedJpeg] = []
    for si, sc in enumerate(scans):
        if fallback[si]:
            out.append(_scalar(sc))
        else:
            out.append(bs.assemble_blocks(
                sc, OUT[scan_rows[si]:scan_rows[si + 1]]))
    return out
