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
* :meth:`GridCell.dispatch` returns before the card is done: it enqueues
  the copy, the replay and the copy of the logits back into a pinned
  buffer, and hands back a :class:`Dispatch` to wait on, so the scheduler
  can stage the next batch while this one runs (up to :data:`WINDOW`
  batches on the card's one stream);
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
           "cover_buckets", "PinnedPool", "Dispatch", "GridCell",
           "GridColumn", "PlanGrid", "WINDOW"]

KINDS = ("coefficients", "bytes")

#: batches one grid may have launched and not yet read back: the
#: scheduler's launch window, and the staging slots a cell cycles through
WINDOW = 2


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
    """Reusable host buffers, one per (window slot, shape, dtype), in
    pinned memory when ``pin`` (a CUDA grid), so copies between host and
    device run asynchronously.

    The grid has one dispatching thread (the scheduler worker).  Dispatch
    ``seq`` stages its rows into, and reads its logits back through, the
    buffers of slot ``seq % WINDOW``.  A slot is reused only after the
    batch that last used it has been read back (the worker completes batch
    k - 1 before it launches batch k + 1), so no copy still queued on the
    card reads or writes a buffer the host is filling.  Cells share a
    slot's buffers for the same reason."""

    def __init__(self, pin: bool = False) -> None:
        self.pin = bool(pin)
        self._bufs: dict[tuple, torch.Tensor] = {}

    def get(self, shape, dtype=torch.float32, slot: int = 0) -> torch.Tensor:
        key = (int(slot), tuple(int(s) for s in shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.zeros(key[1], dtype=dtype,
                                                pin_memory=self.pin)
        return buf

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in self._bufs.values())

    def __len__(self) -> int:
        return len(self._bufs)


class Dispatch:
    """One batch launched on a :class:`GridCell`: its first ``n`` logits on
    their way to the host.

    ``asynchronous``: the launch returned before the card finished (a CUDA
    cell); the logits land in the pinned buffer of the dispatch's window
    slot, after an event that :meth:`wait` synchronises on.  Otherwise (an
    eager CPU cell) they were computed before :meth:`GridCell.dispatch`
    returned.
    """

    __slots__ = ("n", "asynchronous", "_out", "_start", "_end")

    def __init__(self, n: int, out: torch.Tensor, start=None, end=None):
        self.n = n
        self._out = out
        self._start = start
        self._end = end
        self.asynchronous = end is not None

    def synchronize(self) -> None:
        """Block until the logits are on the host; the event's wait
        releases the interpreter lock."""
        if self._end is not None:
            self._end.synchronize()

    def wait(self) -> np.ndarray:
        """The ``(n, classes)`` logits as numpy, a copy of the slot's
        buffer, which a later dispatch of the same slot overwrites."""
        self.synchronize()
        out = self._out[:self.n].numpy()
        return out.copy() if self.asynchronous else out

    def device_s(self) -> float | None:
        """Seconds the card spent on this batch alone, from its copy in
        to its logits out (CUDA events on the stream, so a batch queued
        behind another is not charged for the wait); None on the CPU.
        Call after :meth:`wait`."""
        if self._end is None:
            return None
        return self._start.elapsed_time(self._end) / 1e3


class GridCell:
    """One (kind, bucket) executor of a grid column.

    :meth:`dispatch` ``(rows, seq)`` stages up to ``bucket`` rows (numpy)
    into the pooled buffer of window slot ``seq % WINDOW``, zero-filling
    the pad tail, launches the captured executor and returns a
    :class:`Dispatch` of the first ``n`` logits.  ``__call__(rows)``
    stages into slot 0, runs the executor and returns the logits of all
    ``bucket`` slots; on a CUDA device that is the graph's static output
    buffer, which the next run of this cell overwrites: copy or consume it
    first.  ``hits`` counts served batches, ``replays`` every run of the
    executor (warm-up and timing included); ``graph_launches`` is what one
    replay launches, by kernel.  ``compiled``/``packed``/``executor`` are
    the schedule the executor was captured from, which :meth:`profile`
    walks step by step.
    """

    __slots__ = ("name", "bucket", "item_shape", "hits", "replays", "_fn",
                 "_pool", "_shape", "_tracer", "_compiled", "_packed",
                 "_executor")

    def __init__(self, name: str, bucket: int, item_shape, fn: Callable,
                 pool: PinnedPool, tracer=None, *, compiled=None,
                 packed: bool = False, executor: str | None = None):
        self.name = name
        self.bucket = int(bucket)
        self.item_shape = tuple(int(s) for s in item_shape)
        self._shape = (self.bucket, *self.item_shape)
        self._fn = fn
        self._pool = pool
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._compiled = compiled
        self._packed = bool(packed)
        self._executor = executor
        self.hits = 0
        self.replays = 0

    @property
    def graph_launches(self) -> dict[str, int]:
        return dict(getattr(self._fn, "graph_launches", {}))

    @property
    def asynchronous(self) -> bool:
        """Whether a dispatch returns before its work is done: a captured
        CUDA graph (an eager CPU walk has no graph)."""
        return getattr(self._fn, "graph", None) is not None

    def _run(self, host: torch.Tensor) -> torch.Tensor:
        self.replays += 1
        return self._fn(host)

    def _stage(self, rows, slot: int = 0) -> torch.Tensor:
        """Slot ``slot``'s pooled host buffer holding ``rows`` (numpy),
        zero-padded to the bucket; all zeros when ``rows`` is None."""
        host = self._pool.get(self._shape, slot=slot)
        view = host.numpy()
        n = 0
        if rows is not None:
            rows = np.asarray(rows, np.float32)
            n = rows.shape[0]
            if n > self.bucket or tuple(rows.shape[1:]) != self.item_shape:
                raise ValueError(
                    f"cell {self.name} serves shape {self._shape}, "
                    f"got {tuple(rows.shape)}")
            view[:n] = rows
        if n < self.bucket:
            view[n:] = 0.0
        return host

    def __call__(self, rows: np.ndarray) -> torch.Tensor:
        host = self._stage(rows)
        self.hits += 1
        return self._run(host)

    def dispatch(self, rows: np.ndarray, seq: int = 0) -> Dispatch:
        """Launch ``rows`` as dispatch ``seq``; see the class docstring.

        On a CUDA cell everything goes on the current stream, in order:
        an event, the copy into the graph's static input, the replay, the
        copy of the first ``n`` logits into the slot's pinned buffer, an
        event.  The next dispatch's copy into a static input and its
        replay over a static output are stream-ordered after this one's
        replay and logits copy, so two batches in flight never race on a
        cell's buffers, nor on the graph memory pool the cells share."""
        tr = self._tracer
        ta = tr.now() if tr.enabled else 0.0
        n = np.asarray(rows).shape[0]
        slot = seq % WINDOW
        host = self._stage(rows, slot)
        self.hits += 1
        tb = tr.now() if tr.enabled else 0.0
        if self.asynchronous:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._run(host)
            buf = self._pool.get(out.shape, out.dtype, slot=slot)
            buf[:n].copy_(out[:n], non_blocking=True)
            end.record()
            d = Dispatch(n, buf, start, end)
        else:
            d = Dispatch(n, self._run(host))
        if tr.enabled:
            # nested under the scheduler's device-dispatch span: the
            # host-staging share of the dispatch, then the copies and the
            # replay being enqueued
            tr.span("device", "pad/stage", ta, tb,
                    args={"cell": self.name, "n": n,
                          "pad": self.bucket - n, "seq": seq})
            tr.span("device", "launch", tb, tr.now(), args={"seq": seq})
        return d

    def warmup(self) -> None:
        """One run on a zero batch, waited for: a replay that faults
        shows here, before traffic.  A CUDA cell also allocates every
        window slot's pinned staging and logits buffers now."""
        out = self._run(self._stage(None))
        if out.device.type == "cuda":
            for slot in range(WINDOW):
                self._pool.get(self._shape, slot=slot)
                self._pool.get(out.shape, out.dtype, slot=slot)
            torch.cuda.synchronize(out.device)

    def _wall(self, host: torch.Tensor, iters: int) -> float:
        """Median seconds of one run of the executor on ``host``: CUDA
        events around the copy and the replay on a CUDA device, the host
        clock on the CPU.  Runs only the captured executor."""
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

    def time_wall(self, *, iters: int = 3) -> float:
        """Median seconds of one run on a zero batch (no new capture)."""
        return self._wall(self._stage(None), iters)

    def profile(self, rows: np.ndarray | None = None, *, iters: int = 3,
                warmup: int = 1) -> dict:
        """Per-step walls of this cell's schedule, and the whole cell's.

        ``rows`` are staged as :meth:`__call__` stages them (zero-padded
        to the bucket; an all-zero batch when None); the cell's schedule
        runs eagerly step by step (``core.plan.StepProfile``), ``warmup``
        discarded calls then ``iters`` timed ones, and the cell's own
        captured executor is timed on the same staged input (no new
        capture).  Returns ``{"cell", "bucket", "steps": [{"name",
        "measured_us"}...], "profiled_total_us", "cell_wall_us",
        "logits"}`` (medians; ``logits`` the profiled walk's, as numpy,
        bit-identical to the executor's).
        """
        if self._compiled is None:
            raise RuntimeError(
                f"cell {self.name} was built without its compiled plan; "
                f"profiling walks the schedule")
        host = self._stage(rows)
        x = host.to(self._compiled.head_w.device)
        apply_fn = (planlib.apply_compiled_packed if self._packed
                    else planlib.apply_compiled)
        prof = planlib.StepProfile()
        with torch.inference_mode():
            for _ in range(max(1, warmup)):
                apply_fn(self._compiled, x, executor=self._executor,
                         profile=prof)
            prof.reset()
            for _ in range(max(1, iters)):
                logits = apply_fn(self._compiled, x, executor=self._executor,
                                  profile=prof)
        steps = prof.summary()
        return {
            "cell": self.name,
            "bucket": self.bucket,
            "steps": [{"name": k, "measured_us": v * 1e6}
                      for k, v in steps.items()],
            "profiled_total_us": sum(steps.values()) * 1e6,
            "cell_wall_us": self._wall(host, iters) * 1e6,
            "logits": logits.cpu().numpy(),
        }


class GridColumn:
    """All bucket cells of one distinct compiled schedule (band tier).

    :meth:`coef_fn` / :meth:`packed_fn` take an unpadded row batch, route
    it to the smallest covering bucket's cell and return that bucket's
    logits; :meth:`dispatch` launches it there and returns a
    :class:`Dispatch`.  Cells are captured on first use, and all of them under
    :meth:`PlanGrid.warmup`.
    """

    def __init__(self, compiled: planlib.CompiledPlan,
                 executor: str | None = None, *, buckets=None,
                 pool: PinnedPool | None = None, device=None,
                 graph_pool=None,
                 on_compile: Callable[[str], None] | None = None,
                 tier_name: str = "tier", tracer=None):
        self.compiled = compiled
        self.executor = executor
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
            packed = kind == "bytes"
            fn = planlib.capture_compiled(
                self.compiled, (int(bucket), *item_shape), packed=packed,
                executor=self.executor, device=self.device,
                pool=self.graph_pool,
                on_capture=(None if on_compile is None
                            else (lambda: on_compile(name))))
            c = self.cells[key] = GridCell(
                name, bucket, item_shape, fn, self.pool, tracer=self.tracer,
                compiled=self.compiled, packed=packed,
                executor=self.executor)
        return c

    def _route(self, kind: str, rows: np.ndarray):
        """``(cell, rows)``: the smallest covering bucket's cell, and
        ``rows`` as float32."""
        rows = np.asarray(rows, np.float32)
        n = rows.shape[0]
        bucket = n if self.buckets is None else bucket_for(n, self.buckets)
        return self.cell(kind, bucket, rows.shape[1:]), rows

    def coef_fn(self, rows: np.ndarray) -> torch.Tensor:
        """Serve a ``(n, bh, bw, C, 64)`` coefficient batch."""
        cell, rows = self._route("coefficients", rows)
        return cell(rows)

    def packed_fn(self, rows: np.ndarray) -> torch.Tensor:
        """Serve a ``(n, bh, bw, C·w_in)`` tile-packed batch."""
        cell, rows = self._route("bytes", rows)
        return cell(rows)

    def dispatch(self, kind: str, rows: np.ndarray, seq: int = 0) -> Dispatch:
        """Launch a ``kind`` batch (``"coefficients"`` or ``"bytes"``, as
        :meth:`coef_fn` / :meth:`packed_fn` take them) as dispatch ``seq``
        (:meth:`GridCell.dispatch`)."""
        cell, rows = self._route(kind, rows)
        return cell.dispatch(rows, seq)


class PlanGrid:
    """The (batch bucket × band tier) executor grid over a ladder.

    ``columns[i]`` serves ``ladder.tiers[i]``; tiers sharing a
    ``CompiledPlan`` share a column.  ``grid``/``channels`` fix the serving
    resolution so :meth:`warmup` can capture every cell before traffic.
    ``executor`` is ``core.plan.apply_compiled``'s, for every cell.  The
    device is the ladder's.
    """

    def __init__(self, ladder, *, batch: int, buckets=None,
                 grid: tuple[int, int] | None = None, channels: int = 3,
                 executor: str | None = None,
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
                    tier.compiled, executor, buckets=self.buckets,
                    pool=self.pool,
                    device=self.device, graph_pool=self.graph_pool,
                    on_compile=on_compile, tier_name=tier.name,
                    tracer=tracer)
            self.columns.append(by_id[key])
        self.distinct = list(by_id.values())
        # per-cell cost annotations (``serve --profile-grid`` fills them
        # from ``introspect.profile_plan_grid``): cell name -> {"flops",
        # "predicted_us", ...}; the scheduler puts them on its
        # device-dispatch spans
        self.cell_costs: dict[str, dict] = {}

    def annotate_costs(self, costs: dict[str, dict]) -> None:
        """Attach per-cell cost annotations (merged by cell name)."""
        self.cell_costs.update(costs)

    def cost_for(self, cell_name: str) -> dict | None:
        return self.cell_costs.get(cell_name)

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
