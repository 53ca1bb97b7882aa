"""Serving metrics: request latencies, per-tier throughput, QoS events.

``ServeMetrics`` is the one sink every serving component writes into —
the scheduler records per-request latency and per-batch tier/throughput,
the QoS selector records tier-switch events, the ingest path records the
codec's per-band occupancy stats — and :meth:`ServeMetrics.report` folds
everything into the JSON-serializable block the serve report embeds.

Latency storage is O(1) in request count: samples land in fixed-bucket
log₂ histograms (:class:`Log2Histogram`) rather than unbounded Python
lists, so the recorder can run under sustained traffic without growing.
Histograms keep exact ``n``/``sum``/``min``/``max``; percentiles are
interpolated within a bucket, so the error is bounded by one bucket
width (sub-buckets per octave keep that under ~12.5% relative by
default).  :meth:`ServeMetrics.metrics_text` renders the same state as
Prometheus text exposition, and :class:`MetricsWriter` snapshots it to a
file on a timer for live scraping (the reference's ``serve.py
--metrics-out``; the port's flag comes with ROADMAP Queue 1 item 3(b)).

Event timelines (``tier_switches``, ``breaker_timeline``) are stamped
with ``t_s`` — seconds since recorder construction on an injectable
monotonic clock — so they correlate with flight-recorder spans
(``serving/trace.py``) and, later, across shards.

:func:`percentiles` is also used standalone by the non-QoS slot loop in
``launch/serve.py`` so plain serving reports p50/p95/p99 per-request
latency too, not just aggregate wall clock.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np

__all__ = ["percentiles", "Log2Histogram", "ServeMetrics", "MetricsWriter"]


def percentiles(latencies_s: Sequence[float],
                pcts: Iterable[int] = (50, 95, 99)) -> dict[str, float]:
    """Latency summary in milliseconds: ``{"p50_ms": ..., "p95_ms": ...,
    "p99_ms": ..., "mean_ms": ..., "max_ms": ..., "n": ...}``.

    Empty input yields ``{"n": 0}`` (serving nothing is not an error).
    """
    xs = np.asarray(list(latencies_s), np.float64)
    if xs.size == 0:
        return {"n": 0}
    out: dict[str, float] = {
        f"p{p}_ms": round(float(np.percentile(xs, p)) * 1e3, 3)
        for p in pcts
    }
    out["mean_ms"] = round(float(xs.mean()) * 1e3, 3)
    out["max_ms"] = round(float(xs.max()) * 1e3, 3)
    out["n"] = int(xs.size)
    return out


class Log2Histogram:
    """Fixed-size log₂ latency histogram (HdrHistogram-style).

    The value axis is split into ``octaves`` powers of two starting at
    ``base`` seconds, each octave into ``sub`` linear sub-buckets —
    ``octaves * sub`` counters total, O(1) memory however many samples
    land.  Defaults cover 10 µs … ~670 s with 12.5% relative bucket
    width.  ``n``/``sum``/``min``/``max`` are tracked exactly; only
    percentiles are approximate (linear interpolation inside the bucket
    holding the target rank, so the error is at most one bucket width).

    Not thread-safe on its own — :class:`ServeMetrics` records under its
    lock.
    """

    __slots__ = ("base", "octaves", "sub", "counts", "n", "total",
                 "vmin", "vmax")

    def __init__(self, base: float = 1e-5, octaves: int = 26,
                 sub: int = 8) -> None:
        if base <= 0 or octaves < 1 or sub < 1:
            raise ValueError(f"bad histogram shape: base={base} "
                             f"octaves={octaves} sub={sub}")
        self.base = float(base)
        self.octaves = int(octaves)
        self.sub = int(sub)
        self.counts = [0] * (self.octaves * self.sub)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, v: float) -> int:
        # bucket 0 absorbs everything below base (including <= 0); the
        # last bucket absorbs overflow — min/max stay exact regardless
        if v < self.base:
            return 0
        m, e = math.frexp(v / self.base)  # v/base = m * 2**e, m in [0.5, 1)
        k = e - 1
        if k >= self.octaves:
            return len(self.counts) - 1
        minor = int((2.0 * m - 1.0) * self.sub)
        if minor >= self.sub:  # float edge at the octave boundary
            minor = self.sub - 1
        return k * self.sub + minor

    def bucket_bounds(self, idx: int) -> tuple[float, float]:
        """``[lo, hi)`` value bounds of bucket ``idx`` in seconds."""
        k, minor = divmod(idx, self.sub)
        scale = self.base * (2.0 ** k)
        lo = scale * (1.0 + minor / self.sub)
        hi = scale * (1.0 + (minor + 1) / self.sub)
        if idx == 0:
            lo = 0.0
        return lo, hi

    def record(self, v: float) -> None:
        v = float(v)
        self.counts[self._index(v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float | None:
        """Approximate q-th percentile in seconds (``None`` when empty)."""
        if self.n == 0:
            return None
        target = q / 100.0 * self.n
        cum = 0
        for idx, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lo, hi = self.bucket_bounds(idx)
                hi = min(hi, self.vmax)
                lo = max(lo, min(self.vmin, hi))
                frac = max(target - cum, 0.0) / c
                return max(self.vmin, min(lo + frac * (hi - lo), self.vmax))
            cum += c
        return self.vmax

    def summary(self) -> dict[str, float]:
        """Same shape as :func:`percentiles` (histogram-derived)."""
        if self.n == 0:
            return {"n": 0}
        out = {f"p{p}_ms": round(self.percentile(p) * 1e3, 3)
               for p in (50, 95, 99)}
        out["mean_ms"] = round(self.total / self.n * 1e3, 3)
        out["max_ms"] = round(self.vmax * 1e3, 3)
        out["n"] = self.n
        return out

    def cumulative_octaves(self) -> list[tuple[float, int]]:
        """Cumulative counts at octave upper bounds (Prometheus ``le``
        edges — one per octave keeps the exposition small and the edge
        set identical across scrapes)."""
        out = []
        cum = 0
        for k in range(self.octaves):
            cum += sum(self.counts[k * self.sub:(k + 1) * self.sub])
            out.append((self.base * (2.0 ** (k + 1)), cum))
        return out


class ServeMetrics:
    """Thread-safe recorder for one serving run.

    Every ``record_*`` hook may be called from the scheduler worker and
    from submitting threads concurrently; :meth:`report` may be called at
    any time (it snapshots under the lock).  ``clock`` is the injectable
    monotonic source for event ``t_s`` stamps (seconds relative to
    recorder construction).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self._t0 = clock()
        self._lat = Log2Histogram()
        self._per_tier_lat: dict[str, Log2Histogram] = {}
        self._tiers: dict[str, dict[str, float]] = {}
        self._switches: list[dict[str, Any]] = []
        self._rejected = 0
        self._deadline_misses = 0
        self._deadline_shed = 0
        self._requests = 0
        self._ingest: list[Any] = []
        self._ingest_wall_s = 0.0
        self._device_wall_s = 0.0
        self._images = 0
        self._slots = 0
        self._cell_hits: dict[str, int] = {}
        self._compiles_total = 0
        self._compiles_post_warmup = 0
        self._compiled_cells: list[dict[str, Any]] = []
        self._failures: dict[str, int] = {}
        self._pool_restarts = 0
        self._breaker_events: list[dict[str, Any]] = []
        self._predicted_capacity: dict[str, float] = {}

    def _t_s(self) -> float:
        return round(self._clock() - self._t0, 6)

    # ------------------------------------------------------------- requests
    def record_request(self, latency_s: float, *, tier: str | None = None,
                       deadline_missed: bool = False) -> None:
        with self._lock:
            self._requests += 1
            self._lat.record(latency_s)
            if tier is not None:
                h = self._per_tier_lat.get(tier)
                if h is None:
                    h = self._per_tier_lat[tier] = Log2Histogram()
                h.record(latency_s)
            if deadline_missed:
                self._deadline_misses += 1

    def record_rejected(self, n: int = 1) -> None:
        """Admission control turned a request away (queue full)."""
        with self._lock:
            self._rejected += n

    def record_deadline_shed(self, n: int = 1) -> None:
        """Requests already expired at dequeue, failed without dispatch."""
        with self._lock:
            self._deadline_shed += n

    # -------------------------------------------------------------- batches
    def record_batch(self, tier: str, images: int, wall_s: float,
                     queue_depth: int | None = None,
                     ingest_s: float | None = None,
                     slots: int | None = None,
                     cell: str | None = None) -> None:
        """One executed batch.  ``wall_s`` is *device* wall (what the QoS
        selector is fed); ``ingest_s``, when given, is the host entropy
        decode wall the ingest thread spent on this batch — kept separate
        so bytes-heavy traffic cannot poison per-tier latency.

        ``slots`` is the padded batch width the executor actually ran
        (the capture bucket) — ``slots - images`` slots were padding, and
        the report's ``padding_fraction`` aggregates that waste.
        ``cell`` names the grid cell that served the batch (per-cell hit
        counts land in ``grid_cell_hits``)."""
        with self._lock:
            t = self._tiers.setdefault(
                tier, {"batches": 0, "images": 0, "wall_s": 0.0,
                       "max_queue_depth": 0, "slots": 0})
            t["batches"] += 1
            t["images"] += int(images)
            t["wall_s"] += float(wall_s)
            self._device_wall_s += float(wall_s)
            self._images += int(images)
            if slots is not None:
                t["slots"] += int(slots)
                self._slots += int(slots)
            if cell is not None:
                self._cell_hits[cell] = self._cell_hits.get(cell, 0) + 1
            if ingest_s is not None:
                self._ingest_wall_s += float(ingest_s)
            if queue_depth is not None:
                t["max_queue_depth"] = max(t["max_queue_depth"],
                                           int(queue_depth))

    def record_compile(self, cell: str, *, post_warmup: bool = False
                       ) -> None:
        """One executable trace/compile (fired from inside the traced
        body, so exactly once per compile).  ``post_warmup`` marks a
        compile after :meth:`BandElasticScheduler.warmup` declared the
        shape set closed — steady-state serving must report zero."""
        with self._lock:
            self._compiles_total += 1
            if post_warmup:
                self._compiles_post_warmup += 1
            self._compiled_cells.append({"cell": cell,
                                         "post_warmup": bool(post_warmup)})

    def record_switch(self, batch_seq: int, from_tier: str, to_tier: str,
                      reason: str) -> None:
        with self._lock:
            self._switches.append({"batch": int(batch_seq),
                                   "t_s": self._t_s(),
                                   "from": from_tier, "to": to_tier,
                                   "reason": reason})

    # ------------------------------------------------------------- failures
    def record_failure(self, reason: str, n: int = 1) -> None:
        """One failed request, keyed by reason — ``codec`` (bad input
        bytes), ``deadline``, ``executor``, ``ingest`` (decode
        infrastructure), ``rejected-open-breaker`` (fast-reject)."""
        with self._lock:
            self._failures[reason] = self._failures.get(reason, 0) + n

    def record_pool_restarts(self, n: int = 1) -> None:
        """The ingest-pool supervisor respawned a broken worker pool."""
        with self._lock:
            self._pool_restarts += n

    def record_predicted_capacity(self, cell: str, req_s: float) -> None:
        """Roofline-predicted capacity of one grid cell, in requests per
        second (``--profile-grid`` sweep) — exposed as the
        ``serve_predicted_capacity`` gauge family for capacity planning
        against the measured ``serve_images_total`` rates."""
        with self._lock:
            self._predicted_capacity[cell] = float(req_s)

    def record_breaker(self, frm: str, to: str, reason: str) -> None:
        """One circuit-breaker state transition (the state timeline)."""
        with self._lock:
            self._breaker_events.append(
                {"seq": len(self._breaker_events), "t_s": self._t_s(),
                 "from": frm, "to": to, "reason": reason})

    def failures_total(self) -> dict[str, int]:
        with self._lock:
            return dict(self._failures)

    def pool_restarts(self) -> int:
        with self._lock:
            return self._pool_restarts

    def breaker_timeline(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._breaker_events)

    def record_ingest(self, stats: Any) -> None:
        """Accumulate a ``codec.ingest.IngestStats`` from one byte batch."""
        if stats is not None:
            with self._lock:
                self._ingest.append(stats)

    # --------------------------------------------------------------- report
    @property
    def tier_switches(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._switches)

    def latency_report(self) -> dict[str, float]:
        with self._lock:
            return self._lat.summary()

    def report(self) -> dict[str, Any]:
        with self._lock:
            per_tier = {}
            for name, t in self._tiers.items():
                wall = max(t["wall_s"], 1e-9)
                h = self._per_tier_lat.get(name)
                per_tier[name] = {
                    **{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in t.items()},
                    "images_per_s": round(t["images"] / wall, 2),
                    "latency_ms": h.summary() if h is not None else {"n": 0},
                }
                if t["slots"]:
                    per_tier[name]["padding_fraction"] = round(
                        1.0 - t["images"] / t["slots"], 4)
            # shed requests never reach record_request, so the miss rate
            # counts them explicitly on both sides of the fraction: a shed
            # request is a missed deadline the scheduler saw coming
            missed = self._deadline_misses + self._deadline_shed
            served = self._requests + self._deadline_shed
            out: dict[str, Any] = {
                "requests": self._requests,
                "rejected": self._rejected,
                "padding_fraction": (
                    round(1.0 - self._images / self._slots, 4)
                    if self._slots else None),
                "compiles_total": self._compiles_total,
                "compiles_post_warmup": self._compiles_post_warmup,
                "grid_cell_hits": dict(self._cell_hits),
                "deadline_misses": self._deadline_misses,
                "deadline_miss_rate": round(missed / max(served, 1), 4),
                "deadline_shed": self._deadline_shed,
                "device_wall_s": round(self._device_wall_s, 6),
                "ingest_wall_s": round(self._ingest_wall_s, 6),
                "latency_ms": self._lat.summary(),
                "per_tier": per_tier,
                "tier_switches": list(self._switches),
                "failures_total": dict(self._failures),
                "pool_restarts": self._pool_restarts,
                "breaker_timeline": list(self._breaker_events),
            }
            if self._predicted_capacity:
                out["predicted_capacity_req_s"] = {
                    c: round(v, 2)
                    for c, v in sorted(self._predicted_capacity.items())}
            if self._compiles_post_warmup:
                # name the offending cells so a CI zero-compile assertion
                # failure points straight at the missing warmup shape
                out["post_warmup_compiles"] = [
                    c["cell"] for c in self._compiled_cells
                    if c["post_warmup"]]
            if self._ingest:
                from repro_torch.codec import merge_stats

                stats = merge_stats(self._ingest)
                occ = np.asarray(stats.occupancy, np.float64)
                total = float(occ.sum())
                out["ingest"] = {
                    "images": stats.images,
                    "bytes_in": stats.bytes_in,
                    "wall_s": round(self._ingest_wall_s, 6),
                    "mean_nonzero_per_block": round(stats.mean_nonzero, 2),
                    # occupancy mass beyond common band cutoffs: what each
                    # ladder rung throws away, measured on the traffic
                    "occupancy_dropped": {
                        str(b): round(float(occ[b:].sum())
                                      / max(total, 1e-12), 4)
                        for b in (24, 32, 48)
                    },
                }
            return out

    # ----------------------------------------------------------- exposition
    def metrics_text(self) -> str:
        """Prometheus text exposition of the live counters/histograms.

        Counter families use ``serve_`` prefixes; latency histograms
        expose cumulative octave-boundary ``le`` edges (stable across
        scrapes) with exact ``_sum``/``_count``.
        """
        with self._lock:
            lines: list[str] = []

            def counter(name: str, help_: str,
                        samples: list[tuple[str, float]]) -> None:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} counter")
                for labels, v in samples:
                    g = float(v)
                    lines.append(f"{name}{labels} "
                                 f"{int(g) if g == int(g) else g}")

            counter("serve_requests_total", "Completed requests.",
                    [("", self._requests)])
            counter("serve_rejected_total",
                    "Requests refused by admission control.",
                    [("", self._rejected)])
            counter("serve_deadline_missed_total",
                    "Completed requests that missed their deadline.",
                    [("", self._deadline_misses)])
            counter("serve_deadline_shed_total",
                    "Requests shed at dequeue (expired unserved).",
                    [("", self._deadline_shed)])
            counter("serve_failures_total", "Failed requests by reason.",
                    [(f'{{reason="{r}"}}', n)
                     for r, n in sorted(self._failures.items())] or
                    [("", 0)])
            counter("serve_compiles_total", "Executable compiles.",
                    [('{phase="warmup"}',
                      self._compiles_total - self._compiles_post_warmup),
                     ('{phase="post_warmup"}', self._compiles_post_warmup)])
            counter("serve_pool_restarts_total",
                    "Ingest worker-pool respawns.",
                    [("", self._pool_restarts)])
            counter("serve_tier_switches_total", "QoS tier switches.",
                    [("", len(self._switches))])
            counter("serve_breaker_transitions_total",
                    "Circuit-breaker state transitions.",
                    [("", len(self._breaker_events))])
            counter("serve_images_total", "Images served in batches.",
                    [(f'{{tier="{n}"}}', t["images"])
                     for n, t in sorted(self._tiers.items())] or [("", 0)])
            counter("serve_batches_total", "Batches executed.",
                    [(f'{{tier="{n}"}}', t["batches"])
                     for n, t in sorted(self._tiers.items())] or [("", 0)])
            counter("serve_device_wall_seconds_total",
                    "Device dispatch wall.", [("", self._device_wall_s)])
            counter("serve_ingest_wall_seconds_total",
                    "Host entropy-decode wall.", [("", self._ingest_wall_s)])

            if self._predicted_capacity:
                name = "serve_predicted_capacity"
                lines.append(f"# HELP {name} Roofline-predicted grid-cell "
                             "capacity (requests/second).")
                lines.append(f"# TYPE {name} gauge")
                for cell, v in sorted(self._predicted_capacity.items()):
                    lines.append(f'{name}{{cell="{cell}"}} {v:.6g}')

            def hist(name: str, labels: str, h: Log2Histogram) -> None:
                sep = "," if labels else ""
                base = labels[:-1] + sep if labels else "{"
                for le, cum in h.cumulative_octaves():
                    lines.append(f'{name}_bucket{base}le="{le:.6g}"}} {cum}')
                lines.append(f'{name}_bucket{base}le="+Inf"}} {h.n}')
                lines.append(f"{name}_sum{labels} {h.total:.9g}")
                lines.append(f"{name}_count{labels} {h.n}")

            name = "serve_request_latency_seconds"
            lines.append(f"# HELP {name} End-to-end request latency.")
            lines.append(f"# TYPE {name} histogram")
            hist(name, "", self._lat)
            for tier, h in sorted(self._per_tier_lat.items()):
                hist(name, f'{{tier="{tier}"}}', h)
            return "\n".join(lines) + "\n"


class MetricsWriter:
    """Periodic snapshot writer: ``metrics_text()`` to a file on a timer.

    Writes are atomic (tmp file + ``os.replace``) so a scraper never
    reads a torn exposition; one final snapshot lands on :meth:`close`.
    Snapshots fall every ``interval_s`` from construction, on a fixed
    schedule; ``writes`` counts them.
    """

    def __init__(self, metrics: ServeMetrics, path: str,
                 interval_s: float = 1.0) -> None:
        self.metrics = metrics
        self.path = path
        self.interval_s = max(float(interval_s), 0.05)
        self.writes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="metrics-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        # on a fixed schedule (the reference's waits a whole interval after
        # each write, so its snapshots drift late under load)
        due = time.monotonic() + self.interval_s
        while not self._stop.wait(max(0.0, due - time.monotonic())):
            self._write()
            due += self.interval_s

    def _write(self) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(self.metrics.metrics_text())
        os.replace(tmp, self.path)
        self.writes += 1

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
