"""Batched compressed ingest: JPEG bytes → network-ready coefficient batches.

Entropy-decode (:mod:`codec.bitstream`), normalize into the plan's
canonical convention (:mod:`codec.normalize`), and stack into the
``(N, bh, bw, C, 64)`` batch the plan walk consumes — or pack straight
into the tile-packed ``(N, bh, bw, C·w)`` layout the compiled schedule's
stem GEMM reads (``kernels/tiling.py``), so band truncation happens at
ingest and the 64-wide layout is never materialised on the serving path.

Decode runs in-process: the lockstep vector decoder when the batch carries
enough restart streams, the scalar decoder otherwise (bit-exact either
way).  Ingest also records per-band traffic statistics (:class:`IngestStats`).
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np

from repro_torch.core import dct as dctlib
from repro_torch.codec import bitstream as bslib
from repro_torch.codec import lockstep as lklib
from repro_torch.codec import normalize as nmlib

__all__ = ["IngestStats", "decode_bytes", "ingest_batch", "pack_tiles",
           "merge_stats"]


class IngestStats(NamedTuple):
    """Per-zigzag-index traffic statistics from one ingest pass.

    ``energy[k]`` — mean squared canonical coefficient at zigzag index
    ``k``; ``occupancy[k]`` — the fraction of blocks whose coefficient
    ``k`` is nonzero.
    """

    images: int
    blocks: int
    bytes_in: int
    energy: np.ndarray     # (64,) float64
    occupancy: np.ndarray  # (64,) float64

    @property
    def mean_nonzero(self) -> float:
        """Average nonzero coefficients per block (format sparsity)."""
        return float(self.occupancy.sum())


def merge_stats(parts: Iterable[IngestStats]) -> IngestStats:
    """Block-weighted merge of stats from several ingest passes."""
    parts = [p for p in parts if p is not None and p.blocks]
    if not parts:
        z = np.zeros(dctlib.NFREQ)
        return IngestStats(0, 0, 0, z, z.copy())
    blocks = sum(p.blocks for p in parts)
    energy = sum(p.energy * p.blocks for p in parts) / blocks
    occ = sum(p.occupancy * p.blocks for p in parts) / blocks
    return IngestStats(sum(p.images for p in parts), blocks,
                       sum(p.bytes_in for p in parts), energy, occ)


def decode_bytes(data: bytes, *, quality: int = 50,
                 grid: tuple[int, int] | None = None,
                 channels: int | None = None) -> np.ndarray:
    """One file → ``(bh, bw, C, 64)`` float32 canonical coefficients
    (entropy decode + per-image quantization normalization, no pixels)."""
    dec = bslib.decode_jpeg(data)
    return nmlib.normalize_image(dec, quality=quality, grid=grid,
                                 channels=channels)


def pack_tiles(coef: np.ndarray, width: int) -> np.ndarray:
    """``(..., C, 64) → (..., C·width)``: each channel keeps its first
    ``width`` zigzag lanes (zero-padded above 64), channel-major."""
    *lead, c, nf = coef.shape
    if width <= nf:
        out = coef[..., :width]
    else:
        out = np.zeros((*lead, c, width), coef.dtype)
        out[..., :nf] = coef
    return np.ascontiguousarray(out).reshape(*lead, c * width)


def ingest_batch(datas: Iterable[bytes], *, quality: int = 50,
                 grid: tuple[int, int] | None = None, channels: int = 3,
                 pack_width: int | None = None, with_stats: bool = True,
                 parallel: bool | None = None):
    """Decode + normalize a batch of JPEG byte strings.

    Returns ``(batch, stats)``: ``batch`` is ``(N, bh, bw, C, 64)``
    float32, or ``(N, bh, bw, C·pack_width)`` when ``pack_width`` is
    given.  ``parallel=False`` forces the scalar decoder, ``True`` the
    lockstep one; ``None`` picks lockstep when the batch has at least
    ``lockstep.LOCKSTEP_MIN_STREAMS`` restart streams.
    """
    datas = list(datas)
    if not datas:
        raise ValueError("empty ingest batch")
    if parallel is False:
        planes = [decode_bytes(d, quality=quality, grid=grid,
                               channels=channels) for d in datas]
    else:
        scans = [bslib.prepare_scan(d) for d in datas]
        if parallel or (lklib.count_streams(scans)
                        >= lklib.LOCKSTEP_MIN_STREAMS):
            decs = lklib.decode_scans(scans)
        else:
            decs = [bslib.decode_scan(s) for s in scans]
        planes = [nmlib.normalize_image(dec, quality=quality, grid=grid,
                                        channels=channels) for dec in decs]
    shapes = {p.shape for p in planes}
    if len(shapes) > 1:
        raise ValueError(
            f"mixed grids in one batch: {sorted(shapes)} — pass grid=")
    batch = np.stack(planes)
    stats = None
    if with_stats:
        flat = batch.reshape(-1, dctlib.NFREQ).astype(np.float64)
        stats = IngestStats(
            images=batch.shape[0], blocks=flat.shape[0],
            bytes_in=sum(len(d) for d in datas),
            energy=np.mean(flat * flat, axis=0),
            occupancy=np.mean(flat != 0.0, axis=0))
    if pack_width is not None:
        batch = pack_tiles(batch, pack_width)
    return batch, stats
