"""Async band-elastic request scheduler over a compiled-plan ladder.

Generalizes the slot loop ``launch/serve.py`` used to hard-code into a
runtime object:

* **admission control** — at most ``max_pending`` queued requests; over
  that, :meth:`BandElasticScheduler.submit` rejects (recorded in
  metrics) instead of letting the queue grow without bound;
* **two ingest queues, decode off the worker** — ``coefficients``
  requests carry pre-decoded ``(bh, bw, C, 64)`` tensors; ``bytes``
  requests carry real JPEG files.  A dedicated ingest thread drains the
  bytes queue through ``repro_torch.codec`` (the supervised spawn-pool
  entropy decode + per-image quantization normalization) into a bounded
  decoded-coefficients queue, so host Huffman work overlaps device
  compute and the worker never decodes inline; decoded-but-unserved
  requests still count against ``max_pending`` (decode backpressure
  reaches admission control).  Batches are kind-homogeneous; the queue
  whose head request is oldest goes first (FIFO across kinds);
* **per-request deadlines** — a request may carry a deadline; the QoS
  selector sees the head-of-queue slack; requests already expired at
  dequeue are shed (failed with :class:`DeadlineExceeded`, counted as
  ``deadline_shed``) instead of burning a batch slot, and completions
  past their deadline are recorded as misses;
* **band-elastic execution over the plan grid** — before each batch the
  :class:`repro_torch.serving.qos.TierSelector` picks the ladder tier from
  queue depth + deadline slack; the batch then runs in the smallest
  **capture bucket** covering its size (``repro_torch.serving.grid`` — the
  aphrodite schedule 1, 2, 4, multiples of 8), through that
  (tier × bucket) cell's executor: one CUDA graph replay on the card.
  :meth:`warmup` captures the whole grid so steady-state serving performs
  zero captures and pads only to the covering bucket, never to
  ``max_batch``; every capture is counted (``ServeMetrics.record_compile``,
  the reference's name for it) and any capture after warmup is reported
  as ``compiles_post_warmup``.

**A two-deep launch window.**  A cell whose dispatch returns before the
card is done (a CUDA graph, ``grid.Dispatch.asynchronous``) lets the
worker launch batch k, then read back and complete batch k - 1 while the
card runs k, then take and launch k + 1: the host's staging and
completion overlap the card's work, with at most ``grid.WINDOW`` batches
launched and not yet read back, completed in order.  With a batch on the
card the take waits until ``batch`` requests are pending or that batch
has left the card, whichever comes first, so closed-loop cohorts stay
whole; a watcher thread waits on the card (the event's wait releases the
interpreter lock) and wakes the worker.  An eager CPU cell has computed
its logits when its dispatch returns, and keeps a window of one: take,
run, read back, complete.

Lifecycle mirrors the ``data.pipeline.prefetch`` contract: the worker
thread is owned by the scheduler — :meth:`close` (or leaving the
``with`` block) joins it, draining queued requests by default.  The worker
thread runs on the ladder's device: it makes that device current (CUDA's
current device is per thread) and replays every graph on its stream.

**Fault isolation** (the robustness layer): failures are contained at
the smallest scope that owns them.  A malformed JPEG fails *that*
request with :class:`RequestFailed` (stage ``"codec"``, the
``codec.CodecError`` on ``__cause__``) — batch-mates decode and serve
normally via ``ingest_batch(..., on_error="isolate")``.  An executor
exception gets one bounded retry, then fails only its batch (stage
``"executor"``) — the scheduler keeps serving.  Ingest-infrastructure
failures fail only the batch being decoded (stage ``"ingest"``); the
codec's pool supervisor respawns dead workers underneath.  Service-level
failures feed a :class:`~repro_torch.serving.breaker.CircuitBreaker` that
fast-rejects new submissions with :class:`ServiceUnavailable` while the
service is evidently unhealthy (per-request codec errors never trip it —
corrupt *input* is not an unhealthy *service*).  ``_fail_all`` — the old
fail-deadly path — is reserved for genuinely unrecoverable states
(``BaseException`` escaping a loop); :meth:`close` re-raises it.
:meth:`health` snapshots breaker state, failure counters, pool restarts,
and queue depths at any time.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.serving.breaker import BreakerPolicy, CircuitBreaker
from repro_torch.serving.grid import WINDOW, PlanGrid
from repro_torch.serving.ladder import PlanLadder
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.qos import QosPolicy, TierSelector
from repro_torch.serving.trace import NULL_TRACER, NullTracer, Tracer

__all__ = ["DeadlineExceeded", "RequestFailed", "SchedulerClosed",
           "ServeRequest", "ServiceUnavailable", "BandElasticScheduler"]

KINDS = ("coefficients", "bytes")


def _to_host(logits) -> np.ndarray:
    """A batch's logits as numpy (a CUDA tensor is copied to the host,
    which waits for the graph that wrote it)."""
    if isinstance(logits, torch.Tensor):
        return logits.cpu().numpy()
    return np.asarray(logits)


class SchedulerClosed(RuntimeError):
    """The scheduler was closed (or died) before the request completed."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it was dispatched; it was
    shed at dequeue instead of wasting a batch slot."""


class RequestFailed(RuntimeError):
    """One request failed; the scheduler is still serving.

    ``stage`` names where it died — ``"codec"`` (this request's bytes
    are malformed; the underlying :class:`~repro_torch.codec.CodecError` is on
    ``__cause__``), ``"executor"`` (the batch's compiled executable
    raised after the retry budget), ``"ingest"`` (decode infrastructure
    failed under the batch).
    """

    def __init__(self, stage: str, rid: int, cause: BaseException):
        super().__init__(f"request {rid} failed at {stage}: {cause}")
        self.stage = stage
        self.rid = rid
        self.__cause__ = cause


class ServiceUnavailable(RuntimeError):
    """Fast-reject: the circuit breaker is open.  Retry after backoff —
    the breaker half-opens on its own timer."""


class ServeRequest:
    """One in-flight classification request (a single image).

    ``result()`` blocks until the scheduler completes the request and
    returns the logits row; it raises the scheduler's failure if the
    worker died (or :class:`SchedulerClosed` on a non-draining close).
    """

    __slots__ = ("rid", "kind", "payload", "deadline", "submitted",
                 "t_sub", "t_enq", "tier", "latency_s", "_event",
                 "_result", "_error")

    def __init__(self, rid: int, kind: str, payload: Any,
                 deadline: float | None):
        self.rid = rid
        self.kind = kind
        self.payload = payload
        self.deadline = deadline          # absolute monotonic seconds
        self.submitted = time.monotonic()
        self.t_sub = self.submitted       # tracer-clock submit time
        self.t_enq = self.submitted       # tracer-clock enqueue time
        self.tier: str | None = None      # tier name that served it
        self.latency_s: float | None = None
        self._event = threading.Event()
        self._result: np.ndarray | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def error(self) -> BaseException | None:
        """The failure outcome, if the request is done and failed —
        without raising (chaos harnesses inspect fleets of requests)."""
        return self._error if self._event.is_set() else None

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} still pending")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, logits: np.ndarray, tier: str) -> None:
        if self._event.is_set():
            return  # first outcome wins (containment paths may race)
        self.tier = tier
        self.latency_s = time.monotonic() - self.submitted
        self._result = logits
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        if self._event.is_set():
            return  # already resolved; keep the first outcome
        self._error = err
        self._event.set()


class _Batch:
    """A taken batch on its way through the launch window: its requests,
    tier and queue depth at the take, then its dispatch sequence number,
    whether it was launched behind an earlier batch not yet read back,
    its launch (``dispatch``) and the host seconds it took to stage."""

    __slots__ = ("reqs", "kind", "tier_ix", "depth", "decoded", "t_take",
                 "seq", "behind", "t0", "t0s", "staged_s", "dispatch",
                 "on_card", "failures")

    def __init__(self, reqs: list[ServeRequest], tier_ix: int, depth: int,
                 decoded, t_take: float):
        self.reqs = reqs
        self.kind = reqs[0].kind
        self.tier_ix = tier_ix
        self.depth = depth
        self.decoded = decoded      # (coef, ingest wall) of a bytes batch
        self.t_take = t_take
        self.seq = 0
        self.behind = False
        self.t0 = self.t0s = self.staged_s = 0.0
        self.dispatch = None
        self.on_card = True         # until the watcher sees it done
        self.failures = 0


class _Watcher:
    """Waits on its own thread for each launched batch to leave the card,
    in launch order, then marks it and wakes the worker (``work``, the
    scheduler's condition): the take's wait for a whole batch ends early
    when the card has run dry.  The wait is the dispatch's event, which
    releases the interpreter lock."""

    def __init__(self, work: threading.Condition, device: torch.device):
        self._work = work
        self._device = device
        self._cv = threading.Condition()
        self._queue: collections.deque[_Batch] = collections.deque()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="scheduler-watcher")
        self._thread.start()

    def watch(self, b: _Batch) -> None:
        with self._cv:
            self._queue.append(b)
            self._cv.notify()

    def close(self) -> None:
        """Stop after the batches already handed over; joins the thread."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join()

    def _run(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if not self._queue:
                    return
                b = self._queue.popleft()
            try:
                b.dispatch.synchronize()
            except Exception:  # noqa: BLE001 — the worker's wait() meets
                pass           # the same error, and owns it
            with self._work:
                b.on_card = False
                self._work.notify_all()


class BandElasticScheduler:
    """Continuous-batching scheduler with a band-elastic tier policy.

    ``grid``/``channels`` describe the serving resolution (block grid of
    the coefficient layout); they are required for ``bytes`` ingest and
    for :meth:`warmup`.  ``policy=None`` with ``len(ladder) > 1`` uses
    the default :class:`QosPolicy`; a single-tier ladder pins tier 0
    (the fixed-band configuration the benchmarks compare against).

    ``buckets`` pins the batch capture buckets of the plan grid (default:
    the ladder's own recorded buckets, else the aphrodite schedule up to
    ``batch`` — see ``serving.grid.cover_buckets``); ``buckets=(batch,)``
    reproduces the pre-grid pad-to-``max_batch`` behaviour.

    ``executor`` selects the compiled-plan lowering
    (``core.plan.apply_compiled``): ``None`` runs each tier's plan on the
    paths it was compiled with, ``"gemm"`` the packed-GEMM lowering, whose
    cost, unlike the spatial lowering's, follows the band budget.
    ``"auto"`` mirrors the reference's rule: ``None`` (the kernels) on a
    CUDA ladder, as the reference does on its TPU, and ``"gemm"`` on the
    CPU, as the reference does off-TPU.

    The device is the ladder's (``ladder.base.device``).
    """

    def __init__(self, ladder: PlanLadder, *, batch: int = 8,
                 policy: QosPolicy | None = None,
                 metrics: ServeMetrics | None = None,
                 max_pending: int = 64,
                 grid: tuple[int, int] | None = None,
                 channels: int = 3,
                 executor: str | None = "auto",
                 buckets=None,
                 breaker: CircuitBreaker | BreakerPolicy | None = None,
                 faults=None,
                 executor_retries: int = 1,
                 tracer: Tracer | NullTracer | None = None):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if executor_retries < 0:
            raise ValueError("executor_retries must be >= 0")
        self.device = ladder.base.device
        if executor == "auto":
            executor = None if self.device.type == "cuda" else "gemm"
        if executor not in (None, "gemm"):
            raise ValueError(f"unknown executor {executor!r}")
        self.executor = executor
        self.ladder = ladder
        self.batch = batch
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.max_pending = max_pending
        self.grid = grid
        self.channels = channels
        self.quality = ladder.base.spec.quality
        self._warmed = False
        # the flight recorder: NULL_TRACER keeps every call site
        # unconditional, and hot paths guard on `tracer.enabled`
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # service-level failure breaker (codec errors never feed it); a
        # prebuilt CircuitBreaker is taken as-is, a BreakerPolicy (or
        # None = defaults) builds one wired into the metrics timeline
        # and the trace instant stream
        if isinstance(breaker, CircuitBreaker):
            self.breaker = breaker
        else:
            self.breaker = CircuitBreaker(
                breaker, on_transition=self._on_breaker)
        self.faults = faults          # FaultInjector | None (tests only)
        self.executor_retries = executor_retries
        from repro_torch.codec import ingest as _ingestlib

        self._pool_seen = _ingestlib.pool_restarts()
        self._dispatch_seq = 0
        # batches launched while an earlier one was not yet read back
        self._overlapped = 0

        # the (batch bucket × band tier) executor grid: one column per
        # *distinct* compiled schedule (shared tiers reuse its cells), one
        # captured executor (a CUDA graph on the card) per (kind, bucket)
        self.grid_engine = PlanGrid(
            ladder, batch=batch, buckets=buckets, grid=grid,
            channels=channels, executor=executor,
            on_compile=self._note_compile, tracer=self.tracer)
        self.buckets = self.grid_engine.buckets
        self._execs = self.grid_engine.columns
        self.tier_names = [t.name for t in ladder.tiers]

        self.selector = TierSelector(
            len(ladder.tiers), policy, tier_names=self.tier_names,
            on_switch=self._on_switch)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._queues = {k: collections.deque() for k in KINDS}
        # bytes batches the ingest thread has already decoded, waiting for
        # the worker: (reqs, (N, bh, bw, C, 64) float32, decode wall).
        # Bounded: the ingest thread stalls past _decoded_cap batches so
        # decode cannot run unboundedly ahead of the device.
        self._decoded: collections.deque = collections.deque()
        self._decoded_cap = 2
        self._ingesting = 0          # bytes requests currently decoding
        self._ingest_alive = True
        self._rid = itertools.count()
        # requests taken and not yet completed or failed (every batch in
        # the launch window)
        self._in_flight = 0
        # the coefficient queue's length at which the waiting worker wants
        # waking (None: it is not waiting on the queue), so a burst of
        # submits wakes it once
        self._wake_at: int | None = None
        self._stop = False
        self._drain = True
        self._error: BaseException | None = None
        self._batches = 0
        self._images = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="scheduler-worker")
        self._ingest_thread = threading.Thread(
            target=self._ingest_run, daemon=True, name="scheduler-ingest")
        self._worker.start()
        self._ingest_thread.start()

    # ----------------------------------------------------------- submission
    def submit(self, payload: Any, *, kind: str = "coefficients",
               deadline_s: float | None = None) -> ServeRequest | None:
        """Enqueue one request; returns None when admission control
        rejects it (queue at ``max_pending``), raises
        :class:`ServiceUnavailable` while the circuit breaker is open,
        and re-raises the worker's failure when the scheduler has died."""
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r} "
                             f"(expected one of {KINDS})")
        if kind == "bytes" and self.grid is None:
            raise ValueError("bytes ingest needs grid= at construction")
        tr = self.tracer
        t_sub = tr.now() if tr.enabled else 0.0
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._stop:
                raise SchedulerClosed("scheduler is closed")
            if not self.breaker.allow():
                self.metrics.record_failure("rejected-open-breaker")
                if tr.enabled:
                    tr.instant("scheduler", "reject",
                               args={"reason": "breaker-open"})
                raise ServiceUnavailable(
                    "circuit breaker open — service unhealthy, retry later")
            if self._pending_locked() >= self.max_pending:
                self.metrics.record_rejected()
                if tr.enabled:
                    tr.instant("scheduler", "reject",
                               args={"reason": "queue-full"})
                return None
            req = ServeRequest(next(self._rid), kind, payload,
                               None if deadline_s is None
                               else time.monotonic() + deadline_s)
            if tr.enabled:
                # its admission and queue rows are written in bulk once
                # it is done with (_trace_dequeued)
                req.t_sub, req.t_enq = t_sub, tr.now()
            q = self._queues[kind]
            q.append(req)
            if kind == "bytes":
                self._work.notify_all()  # the ingest thread waits for it
            elif self._wake_at is not None and len(q) >= self._wake_at:
                self._wake_at = None
                self._work.notify_all()
            return req

    def _pending_locked(self) -> int:
        # everything submitted but not yet dispatched: raw queues, bytes
        # mid-decode, and decoded batches awaiting the worker — so
        # admission control sees decode backpressure too
        return (sum(len(q) for q in self._queues.values())
                + self._ingesting
                + sum(len(e[0]) for e in self._decoded))

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending_locked()

    @property
    def images_served(self) -> int:
        with self._lock:
            return self._images

    def health(self) -> dict:
        """Point-in-time service health: breaker state, failure counters
        per reason, ingest-pool restarts, queue depths, requests in
        flight, batches launched behind an earlier one not yet read back
        (``overlapped_batches``), thread liveness.  Exported through the
        serve report (``--report-out``)."""
        with self._lock:
            queues = {k: len(q) for k, q in self._queues.items()}
            queues["decoded_batches"] = len(self._decoded)
            queues["decoding"] = self._ingesting
            in_flight = self._in_flight
            dead = self._error is not None
        return {
            "breaker": self.breaker.snapshot(),
            "failures_total": self.metrics.failures_total(),
            "pool_restarts": self.metrics.pool_restarts(),
            "qos_estimates": self.selector.estimates(),
            "queues": queues,
            "in_flight": in_flight,
            "overlapped_batches": self._overlapped,
            "worker_alive": self._worker.is_alive(),
            "ingest_alive": self._ingest_thread.is_alive(),
            "dead": dead,
        }

    # ------------------------------------------------------------ lifecycle
    def _note_compile(self, cell: str) -> None:
        """Fires once per cell capture (``core.plan.capture_compiled``).
        After :meth:`warmup` the shape set is closed, so any further firing
        is a mid-traffic capture the report must show."""
        self.metrics.record_compile(cell, post_warmup=self._warmed)
        if self._warmed and self.tracer.enabled:
            # only post-warmup compiles are anomalies worth a timeline
            # mark; the warmup sweep would just flood the ring
            self.tracer.instant("device", "compile",
                                args={"cell": cell, "post_warmup": True})

    def _on_switch(self, batch_seq: int, from_tier: str, to_tier: str,
                   reason: str) -> None:
        """QoS tier switch: metrics timeline + trace instant."""
        self.metrics.record_switch(batch_seq, from_tier, to_tier, reason)
        if self.tracer.enabled:
            self.tracer.instant(
                "scheduler", "tier-switch",
                args={"from": from_tier, "to": to_tier, "reason": reason})

    def _on_breaker(self, frm: str, to: str, reason: str) -> None:
        """Circuit-breaker transition: metrics timeline + trace instant."""
        self.metrics.record_breaker(frm, to, reason)
        if self.tracer.enabled:
            self.tracer.instant("scheduler", "breaker",
                                args={"from": frm, "to": to,
                                      "reason": reason})

    def warmup(self, kinds=KINDS) -> None:
        """Sweep the whole plan grid: capture every (kind × bucket × tier)
        cell so steady-state serving — including tier switches and every
        partial-batch bucket — never captures inline.  ``kinds`` limits
        the sweep to the ingest kinds the caller will submit.  After the
        sweep, any capture is counted as ``compiles_post_warmup``."""
        if self.grid is None:
            raise ValueError("warmup needs grid= at construction")
        self.grid_engine.warmup(kinds)
        self._warmed = True

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted request has completed (or the
        scheduler died — the error re-raises here).  Returns False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._pending_locked() or self._in_flight:
                if self._error is not None:
                    raise self._error
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._idle.wait(timeout=0.05 if left is None
                                else min(left, 0.05))
            if self._error is not None:
                raise self._error
        return True

    def close(self, drain: bool = True) -> None:
        """Stop the worker and join it.

        ``drain=True`` (default) serves everything already queued first;
        ``drain=False`` fails queued requests with
        :class:`SchedulerClosed`.  A worker failure re-raises here (once)
        so errors cannot vanish with the thread.
        """
        with self._lock:
            self._stop = True
            self._drain = drain
            self._work.notify_all()
        self._ingest_thread.join()
        self._worker.join()
        if self._error is not None and not isinstance(self._error,
                                                      SchedulerClosed):
            err, self._error = self._error, SchedulerClosed(
                "scheduler died; error already re-raised")
            raise err

    def __enter__(self) -> "BandElasticScheduler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # consumer exception → don't sit around serving a dead consumer
        self.close(drain=exc_type is None)

    # -------------------------------------------------------- ingest thread
    def _ingest_run(self) -> None:
        """Drain the bytes queue into the decoded-coefficients queue.

        Decodes full-width (64-lane) batches so tier selection stays with
        the worker — packing to the chosen tier's stem width is a cheap
        slice at execute time.  Runs the codec's parallel path; decode
        wall is measured here and reported separately from device wall.

        Failure containment: decode runs with ``on_error="isolate"`` —
        each malformed image fails its own request (stage ``"codec"``)
        and the survivors serve normally.  An infrastructure exception
        under the batch (the pool supervisor already retried underneath)
        fails only that batch (stage ``"ingest"``), feeds the breaker,
        and the thread keeps draining.  Only ``BaseException`` poisons
        the scheduler.
        """
        from repro_torch.codec import ingest as ingestlib

        reqs: list[ServeRequest] = []
        try:
            while True:
                with self._lock:
                    while True:
                        if self._error is not None or (
                                self._stop
                                and (not self._drain
                                     or not self._queues["bytes"])):
                            return
                        if (self._queues["bytes"] and
                                len(self._decoded) < self._decoded_cap):
                            break  # work available, decoded queue has room
                        self._work.wait(timeout=0.05)
                    now = time.monotonic()
                    reqs, shed = [], []
                    q = self._queues["bytes"]
                    while q and len(reqs) < self.batch:
                        r = q.popleft()
                        if r.deadline is not None and now > r.deadline:
                            shed.append(r)  # shed before paying the decode
                        else:
                            reqs.append(r)
                    self._ingesting = len(reqs)
                self._shed(shed)
                if not reqs:
                    with self._idle:
                        self._idle.notify_all()
                    continue
                tr = self.tracer
                on_shard = None
                if tr.enabled:
                    rids = [r.rid for r in reqs]

                    def on_shard(indices, ta, tb, _rids=rids):
                        # one spawn-pool shard of this batch (tid = the
                        # shard's first batch index, which is its shard
                        # number under the i::workers striping)
                        tr.span("ingest", "decode-shard", ta, tb,
                                tid=1 + (indices[0] if indices else 0),
                                args={"rids": [_rids[j] for j in indices]})

                t0 = time.monotonic()
                t0s = tr.now() if tr.enabled else 0.0
                try:
                    if self.faults is not None:
                        self.faults.on_ingest(reqs)
                    coef, stats, errors = ingestlib.ingest_batch(
                        [r.payload for r in reqs], quality=self.quality,
                        grid=self.grid, channels=self.channels,
                        on_error="isolate", on_shard=on_shard)
                except Exception as e:
                    # decode infrastructure died under the whole batch —
                    # fail these requests, keep the thread serving
                    self._note_pool_restarts(ingestlib)
                    if tr.enabled:
                        t = tr.now()
                        self._trace_dequeued(reqs, t)
                        for r in reqs:
                            tr.instant("request", "fail", t=t, tid=r.rid,
                                       args={"stage": "ingest"})
                    for r in reqs:
                        r._fail(RequestFailed("ingest", r.rid, e))
                    self.metrics.record_failure("ingest", len(reqs))
                    self.breaker.record_failure("ingest")
                    with self._lock:
                        self._ingesting = 0
                        reqs = []
                    with self._idle:
                        self._idle.notify_all()
                    continue
                wall = time.monotonic() - t0
                if tr.enabled:
                    tr.span("ingest", "ingest-decode", t0s, tr.now(),
                            args={"n": len(reqs),
                                  "rids": [r.rid for r in reqs]})
                self._note_pool_restarts(ingestlib)
                self.metrics.record_ingest(stats)
                if errors:
                    if tr.enabled:
                        t = tr.now()
                        self._trace_dequeued([reqs[i] for i in errors], t)
                        for i in errors:
                            tr.instant("request", "fail", t=t,
                                       tid=reqs[i].rid,
                                       args={"stage": "codec"})
                    for i, err in errors.items():
                        r = reqs[i]
                        r._fail(RequestFailed("codec", r.rid, err))
                    self.metrics.record_failure("codec", len(errors))
                    reqs = [r for i, r in enumerate(reqs)
                            if i not in errors]
                with self._lock:
                    if self._stop and not self._drain:
                        self._trace_admitted(reqs)
                        for r in reqs:
                            r._fail(SchedulerClosed(
                                "scheduler closed before completion"))
                        self._ingesting = 0
                        return
                    if self._error is not None:
                        # the worker died while we were decoding: these
                        # requests are invisible to _fail_all — fail them
                        # here so close() never strands a waiter
                        self._trace_admitted(reqs)
                        for r in reqs:
                            r._fail(self._error)
                        self._ingesting = 0
                        return
                    if reqs:
                        self._decoded.append(
                            (reqs, np.asarray(coef, np.float32), wall))
                    self._ingesting = 0
                    reqs = []
                    self._work.notify_all()
                with self._idle:
                    self._idle.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised at waiters
            self._trace_admitted(reqs)
            for r in reqs:
                r._fail(e)
            with self._lock:
                self._ingesting = 0
            self._fail_all(e)
        finally:
            leftover: list[ServeRequest] = []
            with self._lock:
                self._ingest_alive = False
                if self._error is not None:
                    # decoded batches appended after (or never seen by)
                    # _fail_all would strand their waiters — drain them
                    leftover = [r for e in self._decoded for r in e[0]]
                    self._decoded.clear()
                err = self._error
                self._work.notify_all()
            for r in leftover:
                r._fail(err)

    def _note_pool_restarts(self, ingestlib) -> None:
        """Fold the codec pool supervisor's respawn count into metrics
        (delta since construction / last observation)."""
        now = ingestlib.pool_restarts()
        delta = now - self._pool_seen
        if delta > 0:
            self._pool_seen = now
            self.metrics.record_pool_restarts(delta)
            if self.tracer.enabled:
                self.tracer.instant("ingest", "pool-restart",
                                    args={"restarts": delta})

    def _shed(self, shed: list[ServeRequest]) -> None:
        if not shed:
            return
        self.metrics.record_deadline_shed(len(shed))
        self.metrics.record_failure("deadline", len(shed))
        tr = self.tracer
        if tr.enabled:
            # close the chains: the queue rows, then the terminals
            t = tr.now()
            self._trace_dequeued(shed, t)
            tr.instant_many("request", "shed", t, tids=[r.rid for r in shed])
        for r in shed:
            r._fail(DeadlineExceeded(
                f"request {r.rid} expired before dispatch"))

    # --------------------------------------------------------------- worker
    def _ready_locked(self) -> bool:
        return bool(self._decoded) or bool(self._queues["coefficients"])

    def _full_locked(self) -> bool:
        """A whole batch is waiting: a decoded bytes batch, or ``batch``
        coefficient requests."""
        return (bool(self._decoded)
                or len(self._queues["coefficients"]) >= self.batch)

    def _take_batch_locked(self, now: float):
        """Pop the next kind-homogeneous batch, shedding expired requests.

        Returns ``(reqs, decoded, shed)``: ``decoded`` is the ingest
        thread's ``(coef, ingest_wall)`` for a bytes batch, None for a
        coefficients batch; ``shed`` are expired requests to fail.
        """
        heads = []
        if self._decoded:
            heads.append((self._decoded[0][0][0].rid, "bytes"))
        if self._queues["coefficients"]:
            heads.append((self._queues["coefficients"][0].rid,
                          "coefficients"))
        if not heads:
            return [], None, []
        _, kind = min(heads)  # oldest head request wins (FIFO across kinds)
        if kind == "bytes":
            reqs, coef, wall = self._decoded.popleft()
            live = [i for i, r in enumerate(reqs)
                    if r.deadline is None or now <= r.deadline]
            shed = [r for i, r in enumerate(reqs) if i not in set(live)]
            if len(live) != len(reqs):
                reqs = [reqs[i] for i in live]
                coef = coef[live]
            return reqs, (coef, wall), shed
        q = self._queues["coefficients"]
        reqs, shed = [], []
        while q and len(reqs) < self.batch:
            r = q.popleft()
            if r.deadline is not None and now > r.deadline:
                shed.append(r)
            else:
                reqs.append(r)
        return reqs, None, shed

    def _head_slack_locked(self, now: float) -> float | None:
        slacks = [q[0].deadline - now for q in self._queues.values()
                  if q and q[0].deadline is not None]
        slacks += [r.deadline - now for e in self._decoded
                   for r in e[0][:1] if r.deadline is not None]
        return min(slacks) if slacks else None

    def _wait_locked(self, window) -> bool:
        """Wait until the worker may take a batch; True when it is to stop
        taking (a close, with nothing left to drain).

        The take rule: with nothing in the window, take as soon as
        anything is ready; with a batch on the card, wait until a whole
        batch is waiting or that batch has left the card, whichever comes
        first; with the window's batch done on the card, take at once."""
        while True:
            if self._error is not None:
                raise self._error
            if self._stop and (not self._drain
                               or (not self._pending_locked()
                                   and not self._ingesting)):
                return True
            if not window:
                if self._ready_locked():
                    return False
                self._wake_at = 1
            elif not window[-1].on_card or self._full_locked():
                return False
            else:
                self._wake_at = self.batch
            self._work.wait(timeout=0.05)
            self._wake_at = None

    def _take_locked(self) -> tuple["_Batch | None", list]:
        """The next batch (None when every request taken was shed) and
        the shed requests.  Tier selection happens *after* the take so the
        capture bucket is known and the QoS estimates key to the right
        grid cell (a bucket-1 trickle must not be judged by bucket-8
        latency)."""
        now = time.monotonic()
        # the requests leave the queue here: their queue rows end, and
        # the batch's batch-form span starts
        t_take = self.tracer.now() if self.tracer.enabled else 0.0
        slack = self._head_slack_locked(now)
        depth = self._pending_locked()
        reqs, decoded, shed = self._take_batch_locked(now)
        if not reqs:
            return None, shed
        tier_ix = self.selector.select(
            pending=depth, batch=self.batch, head_slack_s=slack,
            bucket=self.grid_engine.bucket_for(len(reqs)))
        self._in_flight += len(reqs)
        return _Batch(reqs, tier_ix, depth, decoded, t_take), shed

    def _run(self) -> None:
        window: collections.deque[_Batch] = collections.deque()
        watcher: _Watcher | None = None
        b = None
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                b, shed = None, []
                with self._lock:
                    if self._wait_locked(window):
                        if not window:
                            break
                    else:
                        b, shed = self._take_locked()
                self._shed(shed)
                launched = False
                if b is not None:
                    b.seq = self._dispatch_seq
                    self._dispatch_seq += 1
                    b.behind = bool(window)
                    if self._launch_retrying(b):
                        if b.dispatch.asynchronous:
                            if b.behind:
                                self._overlapped += 1
                            window.append(b)
                            launched = True
                            if watcher is None:
                                watcher = _Watcher(self._work, self.device)
                            watcher.watch(b)
                        else:
                            self._finish(b)
                    b = None
                elif not window:
                    with self._idle:
                        self._idle.notify_all()
                # batch k - 1 is read back and completed while the card
                # runs batch k; with nothing new launched, the last one
                if window and (len(window) >= WINDOW or not launched):
                    self._finish(window[0])
                    window.popleft()
        except BaseException as e:  # noqa: BLE001 — re-raised at waiters
            # the batches taken and not completed left the queue:
            # _fail_all can't see them
            for x in ([b] if b is not None else []) + list(window):
                if self.tracer.enabled:
                    self._trace_dequeued(x.reqs, x.t_take)
                for r in x.reqs:
                    r._fail(e)
            self._fail_all(e)
            return
        finally:
            if watcher is not None:
                watcher.close()
        self._fail_all(SchedulerClosed("scheduler closed before completion"),
                       record=False)

    def _launch(self, b: "_Batch") -> None:
        """Gather ``b``'s rows and dispatch them on its tier's grid
        column; ``b.dispatch`` is the launched batch."""
        if self.faults is not None:
            self.faults.on_execute(b.seq, b.reqs)
        ex = self._execs[b.tier_ix]
        tr = self.tracer
        b.t0 = time.monotonic()
        b.t0s = tr.now() if tr.enabled else 0.0
        if b.kind == "bytes":
            from repro_torch.codec import ingest as ingestlib

            # decode already happened on the ingest thread; only the
            # pack-to-tier-width slice and the device walk run here.
            # Rows go in *unpadded*: the grid cell stages them into its
            # pinned bucket-shaped buffer and zero-fills the pad tail.
            rows = ingestlib.pack_tiles(b.decoded[0], ex.w_in)
        else:
            rows = np.stack([np.asarray(r.payload, np.float32)
                             for r in b.reqs])
        if tr.enabled:
            tr.span("device", "gather", b.t0s, tr.now(),
                    args={"seq": b.seq})
        b.dispatch = ex.dispatch(b.kind, rows, b.seq)
        b.staged_s = time.monotonic() - b.t0

    def _launch_retrying(self, b: "_Batch") -> bool:
        """Launch ``b`` within its retry budget; False when the budget ran
        out and the batch failed (alone: the scheduler keeps serving)."""
        while True:
            try:
                self._launch(b)
                return True
            except Exception as e:  # transient? bounded retry
                if not self._note_failure(b, e):
                    return False

    def _note_failure(self, b: "_Batch", err: Exception) -> bool:
        """Count a failed attempt at ``b``; True while its retry budget
        lasts, else fail the batch and return False."""
        b.failures += 1
        if b.failures <= self.executor_retries:
            return True
        # retry budget exhausted: fail only this batch — the scheduler
        # survives, the breaker accumulates
        tr = self.tracer
        if tr.enabled:
            t = tr.now()
            self._trace_dequeued(b.reqs, b.t_take)
            for r in b.reqs:
                tr.instant("request", "fail", t=t, tid=r.rid,
                           args={"stage": "executor"})
        for r in b.reqs:
            r._fail(RequestFailed("executor", r.rid, err))
        self.metrics.record_failure("executor", len(b.reqs))
        self.breaker.record_failure("executor")
        self.selector.note_failure()
        with self._idle:
            self._in_flight -= len(b.reqs)
            self._idle.notify_all()
        return False

    def _finish(self, b: "_Batch") -> None:
        """Read ``b``'s logits back and complete its requests.  A failed
        readback relaunches the batch alone, within its retry budget."""
        tr = self.tracer
        while True:
            t_rb = tr.now() if tr.enabled else 0.0
            try:
                logits = _to_host(b.dispatch.wait())
                break
            except Exception as e:
                if not (self._note_failure(b, e)
                        and self._launch_retrying(b)):
                    return
        device_s = b.dispatch.device_s()
        # what the batch cost at its tier and bucket: its host staging and
        # its own time on the card, not its wait behind an earlier batch
        wall = (time.monotonic() - b.t0 if device_s is None
                else b.staged_s + device_s)
        self.breaker.record_success()
        ex = self._execs[b.tier_ix]
        name = self.tier_names[b.tier_ix]
        reqs, n, kind = b.reqs, len(b.reqs), b.kind
        bucket = self.grid_engine.bucket_for(n)
        if tr.enabled:
            t1s = tr.now()
            tr.span("device", "readback", t_rb, t1s, args={"seq": b.seq})
            # batch-form covers take -> dispatch start; device-dispatch
            # runs from the gather to the logits on the host
            tr.span("scheduler", "batch-form", b.t_take, b.t0s,
                    args={"tier": name, "n": n, "bucket": bucket,
                          "kind": kind})
            rids = [r.rid for r in reqs]
            dargs = {"tier": name, "n": n, "bucket": bucket,
                     "kind": kind, "rids": rids, "seq": b.seq,
                     "behind": int(b.behind)}
            # --profile-grid annotations: the cell's counted FLOPs and
            # roofline-predicted wall ride on the span, so predicted and
            # measured sit on one track (a tier that shares another's
            # schedule replays, and is annotated by, that column's cell)
            cost = self.grid_engine.cost_for(
                f"{ex.tier_name}/{kind}/b{bucket}")
            if cost:
                dargs.update({k: cost[k] for k in ("flops", "predicted_us")
                              if k in cost})
            tr.span("device", "device-dispatch", b.t0s, t1s, args=dargs)
        t_done = tr.now() if tr.enabled else 0.0
        # only device wall reaches the QoS EMA: host decode cost is
        # band-independent, so folding it in would poison tier selection
        self.selector.observe(b.tier_ix, wall, bucket=bucket)
        self.metrics.record_batch(
            name, n, wall, queue_depth=b.depth,
            ingest_s=None if b.decoded is None else b.decoded[1],
            slots=bucket, cell=f"{name}/{kind}/b{bucket}")
        now = time.monotonic()
        t_now = tr.now() if tr.enabled else 0.0
        for i, r in enumerate(reqs):
            r._complete(logits[i], name)
            self.metrics.record_request(
                r.latency_s, tier=name,
                deadline_missed=(r.deadline is not None
                                 and now > r.deadline))
        if tr.enabled:
            tr.span("scheduler", "complete", t_done, tr.now(),
                    args={"n": n})
            # the requests' own rows last, outside the batch's spans, so
            # those time the worker and not the recorder: each one's
            # admission and queue rows, the flow arrow from its queue row
            # to its batch slice, and its terminal
            ids = np.asarray(rids, np.int64)
            self._trace_dequeued(reqs, b.t_take, ids)
            tr.flow_many(ids, ("request", ids, b.t_take),
                         ("device", 0, b.t0s))
            tr.instant_many("request", "complete", t_now, tids=ids)
        with self._idle:
            self._in_flight -= n
            self._batches += 1
            self._images += n
            self._idle.notify_all()

    def _trace_dequeued(self, reqs: list[ServeRequest], t: float,
                        ids: np.ndarray | None = None) -> None:
        """The admission and queue rows of ``reqs``, which left the queue
        at ``t`` (tracer clock), in bulk: a request's rows are written
        once it is done with, rather than at submit, off the client's
        thread.  ``ids``: their request ids as an array, where the caller
        has one."""
        if ids is None:
            ids = np.asarray([r.rid for r in reqs], np.int64)
        t_enq = np.asarray([r.t_enq for r in reqs], np.float64)
        self.tracer.span_many("request", "admission",
                              [r.t_sub for r in reqs], t_enq, tids=ids)
        self.tracer.span_many("request", "queue", t_enq, t, tids=ids)

    def _trace_admitted(self, reqs: list[ServeRequest]) -> None:
        """Admission rows alone for ``reqs``, which a close or a failure
        takes before they left the scheduler's hands: admitted and never
        served, their chains stay open."""
        if self.tracer.enabled and reqs:
            self.tracer.span_many(
                "request", "admission", [r.t_sub for r in reqs],
                [r.t_enq for r in reqs], tids=[r.rid for r in reqs])

    def _fail_all(self, err: BaseException, record: bool = True) -> None:
        with self._idle:
            if record and self._error is None:
                self._error = err
            pending = [r for q in self._queues.values() for r in q]
            pending += [r for e in self._decoded for r in e[0]]
            for q in self._queues.values():
                q.clear()
            self._decoded.clear()
            self._in_flight = 0
            self._work.notify_all()
            self._idle.notify_all()
        self._trace_admitted(pending)
        for r in pending:
            r._fail(err)
