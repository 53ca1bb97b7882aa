"""Batched compressed ingest: JPEG bytes → network-ready coefficient batches.

Entropy-decode (:mod:`codec.bitstream`), normalize into the plan's
canonical convention (:mod:`codec.normalize`), and stack into the
``(N, bh, bw, C, 64)`` batch the plan walk consumes — or pack straight
into the tile-packed ``(N, bh, bw, C·w)`` layout the compiled schedule's
stem GEMM reads (``kernels/tiling.py``), so band truncation happens at
ingest and the 64-wide layout is never materialised on the serving path.

Decode fans out over a spawn-context process pool (``JPEG_INGEST_WORKERS``,
default the CPU count), supervised: a dead worker breaks the pool, which is
respawned with capped backoff up to ``JPEG_POOL_MAX_RESTARTS`` times
(:func:`pool_restarts` counts them) before the batch decodes in-process.
Within a worker, or in-process, the lockstep vector decoder runs where the
batch's symbols spread over enough restart streams
(``lockstep.prefers_lockstep``), the scalar decoder otherwise: bit-exact
either way.  ``on_error="isolate"`` fails single images instead of the
batch, and :func:`ingest_pipeline` decodes the next batch while the caller
runs the device on this one.  Ingest also records per-band traffic
statistics (:class:`IngestStats`).

The workers run numpy only and never touch CUDA; they are spawned, never
forked, so a process that has initialised CUDA can start them.  Importing
this module in a worker imports ``torch`` through the package's
``__init__`` (``chip_smoke.py`` prints a worker's start time).
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Iterable, Iterator, NamedTuple

import numpy as np

from repro_torch.core import dct as dctlib
from repro_torch.codec import bitstream as bslib
from repro_torch.codec import lockstep as lklib
from repro_torch.codec import normalize as nmlib

__all__ = ["IngestStats", "decode_bytes", "ingest_batch", "ingest_pipeline",
           "ingest_workers", "pack_tiles", "merge_stats", "pool_max_restarts",
           "pool_restarts", "shutdown_pool"]


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


# ---------------------------------------------------------------------------
# parallel decode: lockstep vectorisation and a supervised worker pool
# ---------------------------------------------------------------------------


def ingest_workers() -> int:
    """Decode workers: ``JPEG_INGEST_WORKERS`` if set, else the CPU count;
    ``1`` keeps decoding in-process."""
    env = os.environ.get("JPEG_INGEST_WORKERS")
    if env is not None:
        return max(1, int(env))
    return os.cpu_count() or 1


_POOL: ProcessPoolExecutor | None = None
_POOL_SIZE = 0
_POOL_RESTARTS = 0

#: supervisor backoff: the first respawn waits this long, doubling per
#: attempt, capped at 1 s
POOL_BACKOFF_S = 0.05


def pool_max_restarts() -> int:
    """Respawns per failed shard batch before the in-process last resort
    (``JPEG_POOL_MAX_RESTARTS``, default 2)."""
    return max(0, int(os.environ.get("JPEG_POOL_MAX_RESTARTS", "2")))


def pool_restarts() -> int:
    """How many times the supervisor has respawned a broken decode pool
    in this process (the serving health report exports it)."""
    return _POOL_RESTARTS


def _worker_ready() -> None:
    """A worker's initializer: unpickling it imports this module (and
    torch, through the package), before the worker takes a task."""


def _get_pool(workers: int) -> ProcessPoolExecutor:
    """The shared spawn-context pool, rebuilt if the worker count changes.
    Spawn, never fork: a worker inherits no CUDA context and no thread.

    The pool starts workers as batches need them; without the initializer
    a new worker would take a task first and then spend seconds importing
    the module to run it, while the batch waits on that one shard."""
    global _POOL, _POOL_SIZE
    if _POOL is None or _POOL_SIZE != workers:
        shutdown_pool()
        _POOL = ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_ready)
        _POOL_SIZE = workers
    return _POOL


def shutdown_pool() -> None:
    """Tear down the shared decode pool (tests, clean shutdown)."""
    global _POOL, _POOL_SIZE
    if _POOL is not None:
        _POOL.shutdown(wait=True, cancel_futures=True)
        _POOL = None
        _POOL_SIZE = 0


atexit.register(shutdown_pool)


def _decode_scans(scans: list, parallel: bool | None) -> list:
    """Entropy-decode prepared scans: the lockstep decoder when forced
    (``parallel=True``) or where it is the faster one, else the scalar."""
    if parallel or (parallel is None and lklib.prefers_lockstep(scans)):
        return lklib.decode_scans(scans)
    return [bslib.decode_scan(s) for s in scans]


def _decode_shard(datas: list[bytes], quality: int,
                  grid: tuple[int, int] | None, channels: int | None,
                  isolate: bool = False, parallel: bool | None = None
                  ) -> list[np.ndarray | Exception]:
    """One worker's share: decode its images jointly, then normalize.
    Module-level so spawn workers can import it; an error propagates
    through the future to the caller.

    ``isolate=True`` contains per-image failures: the joint decode runs
    first (healthy traffic pays nothing), and only if it raises does the
    shard decode image by image, returning the exception in place of the
    plane at each failed index (``CodecError.__reduce__`` keeps its
    context across the pickle boundary).
    """
    try:
        scans = [bslib.prepare_scan(d) for d in datas]
        return [nmlib.normalize_image(dec, quality=quality, grid=grid,
                                      channels=channels)
                for dec in _decode_scans(scans, parallel)]
    except Exception:
        if not isolate:
            raise
    out: list[np.ndarray | Exception] = []
    for d in datas:
        try:
            out.append(decode_bytes(d, quality=quality, grid=grid,
                                    channels=channels))
        except Exception as e:
            out.append(e)
    return out


def _pool_shards(shards: list[list[bytes]], quality: int,
                 grid: tuple[int, int] | None, channels: int | None,
                 isolate: bool, workers: int, parallel: bool | None,
                 on_shard=None
                 ) -> list[tuple[int, list[np.ndarray | Exception]]] | None:
    """Run shards on the shared pool under supervision.

    A worker dying mid-decode surfaces as :class:`BrokenProcessPool` on
    every outstanding future: the pool is torn down, respawned with
    capped exponential backoff, and the whole shard batch retried up to
    :func:`pool_max_restarts` times; ``None`` means supervision is
    exhausted and the caller decodes in-process.

    ``on_shard(shard_index, n_images, t0_s, t1_s)`` reports each shard's
    submit→done wall on ``time.monotonic`` (done is stamped by the
    future's callback); only the attempt that succeeded reports.
    """
    global _POOL_RESTARTS
    attempts = pool_max_restarts() + 1
    for attempt in range(attempts):
        pool = _get_pool(workers)
        try:
            # submit is inside the try: a worker killed between batches
            # marks the pool broken and submit itself raises
            futs = []
            done_at: dict[int, float] = {}
            for i, shard in enumerate(shards):
                if not shard:
                    continue
                t_sub = time.monotonic()
                fut = pool.submit(_decode_shard, shard, quality, grid,
                                  channels, isolate, parallel)
                if on_shard is not None:
                    fut.add_done_callback(
                        lambda f, i=i: done_at.__setitem__(
                            i, time.monotonic()))
                futs.append((i, t_sub, fut))
            results = [(i, fut.result()) for i, _, fut in futs]
            if on_shard is not None:
                for i, t_sub, fut in futs:
                    on_shard(i, len(shards[i]), t_sub,
                             done_at.get(i, time.monotonic()))
            return results
        except BrokenProcessPool:
            _POOL_RESTARTS += 1
            shutdown_pool()
            if attempt + 1 < attempts:
                time.sleep(min(POOL_BACKOFF_S * (2 ** attempt), 1.0))
    return None


def _decode_planes(datas: list[bytes], *, quality: int,
                   grid: tuple[int, int] | None, channels: int | None,
                   parallel: bool | None, isolate: bool = False,
                   on_shard=None) -> list[np.ndarray | Exception]:
    """Decode a batch to normalized planes, in order.

    ``parallel=False``: the scalar decoder image by image, in-process.
    ``True``: the lockstep decoder (and the pool when workers > 1).
    ``None``: the pool when workers > 1, and within each shard the
    decoder :func:`lockstep.prefers_lockstep` picks.  Bit-exact either
    way.  ``isolate=True`` returns each failed image's exception in place
    of its plane.  ``on_shard(batch_indices, t0_s, t1_s)`` reports each
    pool shard's wall with the original batch indices it decoded.
    """
    if parallel is False:
        out: list[np.ndarray | Exception] = []
        for d in datas:
            try:
                out.append(decode_bytes(d, quality=quality, grid=grid,
                                        channels=channels))
            except Exception as e:
                if not isolate:
                    raise
                out.append(e)
        return out
    workers = ingest_workers()
    if workers > 1 and len(datas) >= 2:
        shards = [datas[i::workers] for i in range(workers)]
        cb = None
        if on_shard is not None:
            def cb(i, n, ta, tb):
                # shard i holds datas[i::workers]
                on_shard(list(range(i, len(datas), workers))[:n], ta, tb)
        results = _pool_shards(shards, quality, grid, channels, isolate,
                               workers, parallel, on_shard=cb)
        if results is not None:
            planes: list = [None] * len(datas)
            for i, shard_planes in results:
                for j, plane in enumerate(shard_planes):
                    planes[i + j * workers] = plane
            return planes
        # supervision exhausted: decode in-process
    return _decode_shard(datas, quality, grid, channels, isolate, parallel)


def ingest_batch(datas: Iterable[bytes], *, quality: int = 50,
                 grid: tuple[int, int] | None = None, channels: int = 3,
                 pack_width: int | None = None, with_stats: bool = True,
                 parallel: bool | None = None, on_error: str = "raise",
                 on_shard=None):
    """Decode + normalize a batch of JPEG byte strings.

    Returns ``(batch, stats)``: ``batch`` is ``(N, bh, bw, C, 64)``
    float32, or ``(N, bh, bw, C·pack_width)`` when ``pack_width`` is
    given; all images must land on one grid (pass ``grid`` for mixed
    sizes).  ``stats`` covers all 64 lanes of the decoded coefficients,
    computed here in the parent.  ``parallel`` picks the decoder (see
    :func:`_decode_planes`); batch, stats and errors are the same on every
    path.

    ``on_error="isolate"`` contains per-image decode failures: the return
    is ``(batch, stats, errors)``, ``errors`` mapping each failed image's
    index to its exception (a :class:`~repro_torch.codec.CodecError`) and
    ``batch`` stacking the survivors in order; with every image failed it
    is ``(0, gh, gw, C, 64)`` (``grid`` given) or ``(0,)``.

    ``on_shard(batch_indices, t0_s, t1_s)`` reports each pool shard's
    decode wall (the flight recorder's ``decode-shard`` spans).
    """
    datas = list(datas)
    if not datas:
        raise ValueError("empty ingest batch")
    if on_error not in ("raise", "isolate"):
        raise ValueError(
            f"on_error must be 'raise' or 'isolate', got {on_error!r}")
    isolate = on_error == "isolate"
    planes = _decode_planes(datas, quality=quality, grid=grid,
                            channels=channels, parallel=parallel,
                            isolate=isolate, on_shard=on_shard)
    errors: dict[int, Exception] = {
        i: p for i, p in enumerate(planes) if isinstance(p, Exception)}
    planes = [p for p in planes if not isinstance(p, Exception)]
    n_bytes = sum(len(d) for i, d in enumerate(datas) if i not in errors)
    if not planes:
        if grid is not None:
            batch = np.zeros((0, grid[0], grid[1], channels or 3,
                              dctlib.NFREQ), np.float32)
            if pack_width is not None:
                batch = pack_tiles(batch, pack_width)
        else:
            batch = np.zeros((0,), np.float32)
        return batch, (merge_stats([]) if with_stats else None), errors
    shapes = {p.shape for p in planes}
    if len(shapes) > 1:
        raise ValueError(
            f"mixed grids in one batch: {sorted(shapes)} — pass grid=")
    batch = np.stack(planes)
    stats = None
    if with_stats:
        flat = batch.reshape(-1, dctlib.NFREQ).astype(np.float64)
        stats = IngestStats(
            images=batch.shape[0], blocks=flat.shape[0], bytes_in=n_bytes,
            energy=np.mean(flat * flat, axis=0),
            occupancy=np.mean(flat != 0.0, axis=0))
    if pack_width is not None:
        batch = pack_tiles(batch, pack_width)
    if isolate:
        return batch, stats, errors
    return batch, stats


def ingest_pipeline(batches: Iterable[Iterable[bytes]], *, depth: int = 2,
                    **kw) -> Iterator[tuple]:
    """Double-buffered ingest: the decode of batch ``N+1`` overlaps what
    the consumer does with batch ``N``.  Yields ``ingest_batch(batch,
    **kw)`` results in order, decoded ``depth`` batches ahead on a
    producer thread with ``data.pipeline.prefetch``'s lifecycle: closing
    the generator (or a consumer exception) joins the thread, and a
    decode error re-raises at the consumer's ``next()``."""
    from repro_torch.data import pipeline as pipe  # it imports the codec

    def produce():
        for datas in batches:
            yield ingest_batch(datas, **kw)

    return pipe.prefetch(produce(), depth=depth)
