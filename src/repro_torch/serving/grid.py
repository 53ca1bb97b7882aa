"""Plan grid: one captured executor per (batch bucket × band tier) cell.

The band ladder (``serving.ladder``) made quality a runtime knob; the grid
makes batch shape one too, as aphrodite/vLLM capture a ladder of padded
batch sizes:

* **buckets** follow the aphrodite capture schedule: 1, 2, 4, then
  multiples of 8 up to ``max_batch`` (:func:`batch_buckets`); a batch of
  ``n`` requests runs in the smallest covering bucket (:func:`bucket_for`:
  1→1, 3→4, 9→16, 17→24 …);
* **tiers** are the ladder's band tiers; tiers that share a schedule share
  a column and its cells;
* each cell is one ``torch.cuda.CUDAGraph`` of the tier's schedule at the
  bucket's shape (``core.plan.capture_compiled``): a served batch is one
  host-to-device copy from a pinned staging buffer (:class:`PinnedPool`)
  and one graph replay, where the eager walk issues every kernel, cuDNN
  call and copy from Python.  Every graph of a grid shares one memory pool
  (``torch.cuda.graph_pool_handle()``) for its intermediates, so sixteen
  cells do not hold sixteen copies of the activations;
* **capture accounting**: every capture fires ``on_compile(cell_name)``
  once, so the scheduler reports ``compiles_total`` /
  ``compiles_post_warmup`` under the reference's names.

On the CPU (a ladder built with ``device="cpu"``) a cell runs the walk
eagerly at the bucket's shape: same staging, same padding, same logits
as the reference's cells.
"""
from __future__ import annotations

import bisect
import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.serving.trace import NULL_TRACER

__all__ = ["batch_buckets", "validate_buckets", "bucket_for",
           "cover_buckets", "PinnedPool", "GridCell", "GridColumn",
           "PlanGrid"]

KINDS = ("coefficients", "bytes")


# --------------------------------------------------------------------------
# Bucket math (aphrodite _BATCH_SIZES_TO_CAPTURE / _get_graph_batch_size)
# --------------------------------------------------------------------------


def batch_buckets(max_batch: int) -> tuple[int, ...]:
    """The aphrodite-style capture schedule up to ``max_batch``: ``1, 2,
    4`` then multiples of 8, with ``max_batch`` itself always last."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = [b for b in (1, 2, 4) if b <= max_batch]
    buckets += list(range(8, max_batch + 1, 8))
    if buckets[-1] != max_batch:
        buckets.append(max_batch)
    return tuple(buckets)


def validate_buckets(buckets) -> tuple[int, ...]:
    """An explicit bucket list as ints, strictly increasing, positive."""
    out = tuple(int(b) for b in buckets)
    if not out:
        raise ValueError("need at least one bucket")
    if any(b < 1 for b in out):
        raise ValueError(f"buckets must be positive: {out}")
    if any(a >= b for a, b in zip(out, out[1:])):
        raise ValueError(f"buckets must be strictly increasing: {out}")
    return out


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket covering ``n`` requests; a batch past the largest
    bucket raises (the scheduler never forms one)."""
    if n < 1:
        raise ValueError(f"batch must be >= 1, got {n}")
    i = bisect.bisect_left(buckets, n)
    if i == len(buckets):
        raise ValueError(
            f"batch {n} exceeds the largest capture bucket {buckets[-1]}")
    return buckets[i]


def cover_buckets(buckets, batch: int) -> tuple[int, ...]:
    """The buckets a scheduler with ``batch`` slots captures: the default
    schedule when ``buckets`` is None, else the list clipped to ``batch``,
    with ``batch`` itself always present."""
    if buckets is None:
        return batch_buckets(batch)
    out = tuple(b for b in validate_buckets(buckets) if b <= batch)
    if not out or out[-1] != batch:
        out = out + (batch,)
    return out


# --------------------------------------------------------------------------
# Pinned host staging + captured cells
# --------------------------------------------------------------------------


class PinnedPool:
    """Reusable host staging buffers, one per (shape, dtype), in pinned
    memory when ``pin`` (a CUDA grid), so the copy to the device runs
    asynchronously.  The grid has one dispatching thread (the scheduler
    worker), which waits for each batch's logits before staging the next,
    so sharing a buffer between cells is safe."""

    def __init__(self, pin: bool = False) -> None:
        self.pin = bool(pin)
        self._bufs: dict[tuple, torch.Tensor] = {}

    def get(self, shape, dtype=torch.float32) -> torch.Tensor:
        key = (tuple(int(s) for s in shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.zeros(key[0], dtype=dtype,
                                                pin_memory=self.pin)
        return buf

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in self._bufs.values())

    def __len__(self) -> int:
        return len(self._bufs)


class GridCell:
    """One (kind, bucket) executor of a grid column.

    ``__call__(rows)`` stages up to ``bucket`` rows (numpy) into the
    pooled buffer, zero-filling the pad tail, and runs the captured
    executor; it returns the logits of all ``bucket`` slots (callers take
    the first ``n``).  On a CUDA device that is the graph's static output
    buffer, which the next call of this cell overwrites: copy or consume
    it first (the scheduler's ``_execute`` copies it to the host).
    ``hits`` counts served dispatches, ``replays`` every run of the
    executor (warm-up and timing included); ``graph_launches`` is what one
    replay launches, by kernel.
    """

    __slots__ = ("name", "bucket", "item_shape", "hits", "replays", "_fn",
                 "_pool", "_shape", "_tracer")

    def __init__(self, name: str, bucket: int, item_shape, fn: Callable,
                 pool: PinnedPool, tracer=None):
        self.name = name
        self.bucket = int(bucket)
        self.item_shape = tuple(int(s) for s in item_shape)
        self._shape = (self.bucket, *self.item_shape)
        self._fn = fn
        self._pool = pool
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self.hits = 0
        self.replays = 0

    @property
    def graph_launches(self) -> dict[str, int]:
        return dict(getattr(self._fn, "graph_launches", {}))

    def _run(self, host: torch.Tensor) -> torch.Tensor:
        self.replays += 1
        return self._fn(host)

    def __call__(self, rows: np.ndarray, rids=None) -> torch.Tensor:
        rows = np.asarray(rows, np.float32)
        n = rows.shape[0]
        if n > self.bucket or tuple(rows.shape[1:]) != self.item_shape:
            raise ValueError(
                f"cell {self.name} serves shape {self._shape}, "
                f"got {tuple(rows.shape)}")
        tr = self._tracer
        ta = tr.now() if tr.enabled else 0.0
        host = self._pool.get(self._shape)
        view = host.numpy()
        view[:n] = rows
        if n < self.bucket:
            view[n:] = 0.0
        if tr.enabled:
            # nested under the scheduler's device-dispatch span: the
            # host-staging share of the dispatch
            tr.span("device", "pad/stage", ta, tr.now(),
                    args={"cell": self.name, "n": n,
                          "pad": self.bucket - n, "rids": rids})
        self.hits += 1
        return self._run(host)

    def warmup(self) -> None:
        """One run on a zero batch, waited for: a replay that faults
        shows here, before traffic."""
        host = self._pool.get(self._shape)
        host.zero_()
        out = self._run(host)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)

    def time_wall(self, *, iters: int = 3) -> float:
        """Median seconds of one run on a zero batch: CUDA events around
        the copy and the replay on a CUDA device, the host clock on the
        CPU.  Runs only the captured executor: no new capture."""
        host = self._pool.get(self._shape)
        host.zero_()
        out = self._run(host)
        cuda = out.device.type == "cuda"
        walls = []
        for _ in range(max(1, iters)):
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                self._run(host)
                b.record()
                b.synchronize()
                walls.append(a.elapsed_time(b) / 1e3)
            else:
                t0 = time.perf_counter()
                self._run(host)
                walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    def profile(self, *args, **kwargs) -> dict:
        """Per-block walls of the cell's schedule: the reference's
        ``StepProfile`` comes with the introspection modules."""
        raise NotImplementedError(
            "GridCell.profile needs core.plan.StepProfile and introspect/, "
            "which are not ported yet: ROADMAP Queue 1 item 6")


class GridColumn:
    """All bucket cells of one distinct compiled schedule (band tier).

    :meth:`coef_fn` / :meth:`packed_fn` take an unpadded row batch, route
    it to the smallest covering bucket's cell and return that bucket's
    logits.  Cells are captured on first use, and all of them under
    :meth:`PlanGrid.warmup`.
    """

    def __init__(self, compiled: planlib.CompiledPlan, *, buckets=None,
                 pool: PinnedPool | None = None, device=None,
                 graph_pool=None,
                 on_compile: Callable[[str], None] | None = None,
                 tier_name: str = "tier", tracer=None):
        self.compiled = compiled
        self.w_in = compiled.stem.w_in
        self.buckets = None if buckets is None else validate_buckets(buckets)
        self.tier_name = tier_name
        self.device = compiled.head_w.device if device is None \
            else torch.device(device)
        self.pool = pool if pool is not None else PinnedPool(
            self.device.type == "cuda")
        self.graph_pool = graph_pool
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._on_compile = on_compile
        self.cells: dict[tuple[str, int], GridCell] = {}

    def cell(self, kind: str, bucket: int, item_shape) -> GridCell:
        key = (kind, int(bucket))
        c = self.cells.get(key)
        if c is None:
            name = f"{self.tier_name}/{kind}/b{int(bucket)}"
            on_compile = self._on_compile
            fn = planlib.capture_compiled(
                self.compiled, (int(bucket), *item_shape),
                packed=(kind == "bytes"), device=self.device,
                pool=self.graph_pool,
                on_capture=(None if on_compile is None
                            else (lambda: on_compile(name))))
            c = self.cells[key] = GridCell(name, bucket, item_shape, fn,
                                           self.pool, tracer=self.tracer)
        return c

    def _route(self, kind: str, rows: np.ndarray,
               rids=None) -> torch.Tensor:
        rows = np.asarray(rows, np.float32)
        n = rows.shape[0]
        bucket = n if self.buckets is None else bucket_for(n, self.buckets)
        return self.cell(kind, bucket, rows.shape[1:])(rows, rids=rids)

    def coef_fn(self, rows: np.ndarray, rids=None) -> torch.Tensor:
        """Serve a ``(n, bh, bw, C, 64)`` coefficient batch; ``rids``
        labels the flight-recorder span, nothing more."""
        return self._route("coefficients", rows, rids=rids)

    def packed_fn(self, rows: np.ndarray, rids=None) -> torch.Tensor:
        """Serve a ``(n, bh, bw, C·w_in)`` tile-packed batch."""
        return self._route("bytes", rows, rids=rids)


class PlanGrid:
    """The (batch bucket × band tier) executor grid over a ladder.

    ``columns[i]`` serves ``ladder.tiers[i]``; tiers sharing a
    ``CompiledPlan`` share a column.  ``grid``/``channels`` fix the serving
    resolution so :meth:`warmup` can capture every cell before traffic.
    The device is the ladder's.
    """

    def __init__(self, ladder, *, batch: int, buckets=None,
                 grid: tuple[int, int] | None = None, channels: int = 3,
                 on_compile: Callable[[str], None] | None = None,
                 tracer=None):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.ladder = ladder
        self.batch = int(batch)
        if buckets is None:
            buckets = getattr(ladder, "buckets", None)
        self.buckets = cover_buckets(buckets, self.batch)
        self.grid = grid
        self.channels = channels
        self.device = ladder.base.device
        cuda = self.device.type == "cuda"
        self.pool = PinnedPool(pin=cuda)
        self.graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        by_id: dict[int, GridColumn] = {}
        self.columns: list[GridColumn] = []
        for tier in ladder.tiers:
            key = id(tier.compiled)
            if key not in by_id:
                by_id[key] = GridColumn(
                    tier.compiled, buckets=self.buckets, pool=self.pool,
                    device=self.device, graph_pool=self.graph_pool,
                    on_compile=on_compile, tier_name=tier.name,
                    tracer=tracer)
            self.columns.append(by_id[key])
        self.distinct = list(by_id.values())

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    def warmup(self, kinds=KINDS) -> None:
        """Capture and run every (kind, bucket) cell of every distinct
        column; after this any capture is a post-warmup compile."""
        if self.grid is None:
            raise ValueError("warmup needs grid= at construction")
        bh, bw = self.grid
        for col in self.distinct:
            for bucket in self.buckets:
                if "coefficients" in kinds:
                    col.cell("coefficients", bucket,
                             (bh, bw, self.channels, 64)).warmup()
                if "bytes" in kinds:
                    col.cell("bytes", bucket,
                             (bh, bw, self.channels * col.w_in)).warmup()

    def cells(self) -> list[GridCell]:
        return [c for col in self.distinct for c in col.cells.values()]

    def cell_hits(self) -> dict[str, int]:
        return {c.name: c.hits for c in self.cells()}

    def graph_launches(self) -> dict[str, int]:
        """Kernel launches the cells' replays made so far: each cell's
        per-replay launches times its replays (a replay launches what its
        capture recorded; the wrappers' counters see neither)."""
        out: dict[str, int] = {}
        for c in self.cells():
            for k, v in c.graph_launches.items():
                out[k] = out.get(k, 0) + v * c.replays
        return out

    def summary(self) -> dict[str, Any]:
        """Startup-log / report block: grid extent and staging cost."""
        return {
            "buckets": list(self.buckets),
            "tiers": [t.name for t in self.ladder.tiers],
            "distinct_columns": len(self.distinct),
            "cells": sum(len(col.cells) for col in self.distinct),
            "host_staging_bytes": self.pool.nbytes,
            "device": str(self.device),
            "cuda_graphs": self.device.type == "cuda",
        }
