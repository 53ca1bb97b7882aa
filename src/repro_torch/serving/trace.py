"""Flight-recorder tracing for the serving runtime.

The serve report aggregates (``device_wall_s``, ``ingest_wall_s``,
latency histograms) — this module records *where the time went*: a
bounded, thread-safe ring of typed spans and instant events, one chain
per request, exportable as Chrome trace-event JSON that loads directly
in Perfetto (https://ui.perfetto.dev).

Span taxonomy (one chain per request id, see TESTING.md):

=============== ========== =====================================================
track (pid)     name        interval
=============== ========== =====================================================
``scheduler``   admission*  ``submit()`` entry → accepted into a queue
``scheduler``   batch-form  batch taken from the queue → executor dispatch
                            (tier selection + tile packing)
``ingest``      ingest-decode  one bytes batch through ``codec.ingest_batch``
``ingest``      decode-shard   one spawn-pool shard of that batch (tid = shard)
``device``      device-dispatch  staged batch through the grid cell executable
                            (the interval ``device_wall_s`` accumulates)
``device``      pad/stage   host staging copy into the pinned bucket buffer
``request``     admission / queue   per-request rows (tid = request id)
``request``     complete / fail / shed   terminal instants closing the chain
=============== ========== =====================================================

Instant events mark tier switches, breaker transitions, ingest-pool
restarts, and post-warmup compiles.  Batches link to their member
requests through flow events (``id`` = request id), so clicking a
``device-dispatch`` slice in Perfetto highlights every request it
served.

The recorder is a true flight recorder: a ring of the newest
``capacity`` events, O(1) per record, with a ``dropped`` counter for
evicted history — it can stay on under sustained load without growing.
The clock is injectable (tests drive it deterministically); timestamps
are exported relative to tracer construction in microseconds.

:data:`NULL_TRACER` is the disabled no-op twin — the scheduler threads
it unconditionally so tracing costs one attribute check when off.
:func:`validate_trace` is the schema/chain checker CI and the tests
share.  (The reference's ``jax_profile`` bracket becomes a
``torch.profiler`` window in a later slice of the port: ROADMAP Queue 1
item 3(b).)
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import Any, Callable

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "TRACKS",
    "validate_trace",
]

#: canonical component tracks, in display order (one Perfetto "process"
#: per component; unknown tracks are appended after these)
TRACKS = ("scheduler", "ingest", "device", "request")


class NullTracer:
    """Disabled tracer: every hook is a no-op.

    The scheduler and grid call the tracer unconditionally; this twin
    keeps the disabled-path cost to an attribute check (``enabled``)
    plus an empty method call on the few sites that don't guard.
    """

    enabled = False
    dropped = 0
    capacity = 0

    def now(self) -> float:
        return 0.0

    def span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def flow(self, *a, **kw) -> None:
        pass

    def events(self) -> list:
        return []

    def summary(self) -> dict:
        return {"enabled": False, "events": 0, "dropped": 0}


NULL_TRACER = NullTracer()


class Tracer:
    """Thread-safe bounded ring of trace events.

    ``capacity`` bounds memory: the ring keeps the newest ``capacity``
    events and counts evictions in :attr:`dropped` (a flight recorder
    keeps the end of the story, not the beginning).  ``clock`` is any
    monotonic ``() -> float`` (seconds); every recorded timestamp is
    a reading of this clock, stored relative to construction time.

    Recording is a tuple append under a lock — cheap enough to leave on
    in production serving (the fig5 serving mode measures the overhead).
    """

    enabled = True

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        # record: (ph, track, tid, name, t_rel_s, dur_s_or_flow_id, args)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._dropped = 0

    # ------------------------------------------------------------- recording
    def now(self) -> float:
        """Current clock reading (absolute; pass to :meth:`span`)."""
        return self._clock()

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def _push(self, rec: tuple) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(rec)

    def span(self, track: str, name: str, t0: float, t1: float, *,
             tid: int = 0, args: dict | None = None) -> None:
        """One completed interval ``[t0, t1]`` (absolute clock readings)."""
        self._push(("X", track, tid, name, t0 - self._t0,
                    max(t1 - t0, 0.0), args))

    def instant(self, track: str, name: str, *, t: float | None = None,
                tid: int = 0, args: dict | None = None) -> None:
        """One point event (``t`` defaults to the clock's now)."""
        t = self._clock() if t is None else t
        self._push(("i", track, tid, name, t - self._t0, 0.0, args))

    def flow(self, fid: int, src: tuple[str, int, float],
             dst: tuple[str, int, float]) -> None:
        """Link two slices with a flow arrow (``fid`` = request id).

        ``src``/``dst`` are ``(track, tid, t)`` — the timestamps must
        fall inside the slices the arrow should bind to.
        """
        track, tid, t = src
        self._push(("s", track, tid, "req", t - self._t0, int(fid), None))
        track, tid, t = dst
        self._push(("f", track, tid, "req", t - self._t0, int(fid), None))

    # --------------------------------------------------------------- export
    def events(self) -> list[tuple]:
        """Snapshot of the ring (oldest surviving event first)."""
        with self._lock:
            return list(self._ring)

    def summary(self) -> dict:
        """Cheap run summary for reports/narration (no event payloads)."""
        with self._lock:
            evs = list(self._ring)
            dropped = self._dropped
        by_name: dict[str, int] = {}
        for ph, track, _tid, name, *_ in evs:
            if ph in ("X", "i"):
                by_name[f"{track}/{name}"] = by_name.get(
                    f"{track}/{name}", 0) + 1
        return {"enabled": True, "events": len(evs), "dropped": dropped,
                "capacity": self.capacity, "by_name": by_name}

    def export(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        One pid per component track (process metadata named), ``X``
        complete events for spans, ``i`` instants, ``s``/``f`` flow
        pairs.  Timestamps/durations are microseconds relative to
        tracer construction.
        """
        evs = self.events()
        with self._lock:
            dropped = self._dropped
        pids: dict[str, int] = {}
        out: list[dict] = []
        order = list(TRACKS) + sorted(
            {e[1] for e in evs} - set(TRACKS))
        present = {e[1] for e in evs}
        for track in order:
            if track not in present:
                continue
            pid = pids[track] = len(pids) + 1
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": track}})
            out.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"sort_index": pid}})
        for ph, track, tid, name, ts, dur, args in evs:
            ev: dict[str, Any] = {"name": name, "ph": ph, "cat": track,
                                  "ts": round(ts * 1e6, 3),
                                  "pid": pids[track], "tid": tid}
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            elif ph in ("s", "f"):
                ev["cat"] = "flow"
                ev["id"] = int(dur)
                if ph == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
            if args:
                ev["args"] = args
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"dropped": dropped, "capacity": self.capacity,
                          "events": len(evs)},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


# ---------------------------------------------------------------------------
# validation (shared by CI and the tests)
# ---------------------------------------------------------------------------

_PHASES = ("X", "i", "s", "f", "M")


def validate_trace(obj: dict, *, require_closed: bool = True) -> dict:
    """Validate an exported trace: event schema + span-chain closure.

    Schema: every event carries ``name``/``ph``/``ts``/``pid``/``tid``
    with sane types; ``X`` events need a non-negative ``dur``; the
    top-level object needs ``traceEvents`` and an ``otherData.dropped``
    counter.

    Chains: on the ``request`` track (tid = request id), every id that
    appears must have an ``admission`` span, and every id whose chain
    ended in ``complete`` must also have a ``queue`` span and belong to
    exactly one ``device-dispatch`` span's ``args.rids``.  With
    ``require_closed`` (the default), any id without a terminal instant
    (``complete``/``fail``/``shed``) is an orphan and fails validation.

    Returns a summary dict: event counts, per-terminal request counts,
    ``device_span_s``/``ingest_span_s`` (span sums that must reconcile
    with the report's ``device_wall_s``/``ingest_wall_s``), and
    ``open_chains``.  Raises :class:`ValueError` on any violation.
    """
    problems: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace-event object (no traceEvents)")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents is not a list")
    other = obj.get("otherData")
    if not isinstance(other, dict) or not isinstance(
            other.get("dropped"), int):
        problems.append("otherData.dropped missing or not an int")

    pid_names: dict[int, str] = {}
    for ev in evs:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev["args"]["name"]

    spans_by_name: dict[str, int] = {}
    span_sum_s: dict[str, float] = {}
    admission: set[int] = set()
    queued: set[int] = set()
    terminal: dict[int, str] = {}
    dispatch_members: dict[int, int] = {}  # rid -> device-dispatch count
    n_spans = n_instants = n_flows = 0
    for k, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {k}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {k}: bad ph {ph!r}")
            continue
        if ph == "M":  # process metadata: no timestamp
            if not isinstance(ev.get("name"), str) \
                    or not isinstance(ev.get("pid"), int):
                problems.append(f"event {k}: bad metadata event")
            continue
        for key, typ in (("name", str), ("ts", (int, float)),
                         ("pid", int), ("tid", int)):
            if not isinstance(ev.get(key), typ):
                problems.append(f"event {k}: bad {key} {ev.get(key)!r}")
        track = pid_names.get(ev.get("pid"))
        name = ev.get("name")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0 \
                    or not math.isfinite(dur):
                problems.append(f"event {k}: X without sane dur ({dur!r})")
                continue
            n_spans += 1
            key = f"{track}/{name}"
            spans_by_name[key] = spans_by_name.get(key, 0) + 1
            span_sum_s[key] = span_sum_s.get(key, 0.0) + dur / 1e6
            if track == "request":
                rid = ev["tid"]
                if name == "admission":
                    admission.add(rid)
                elif name == "queue":
                    queued.add(rid)
            elif track == "device" and name == "device-dispatch":
                for rid in (ev.get("args") or {}).get("rids", ()):
                    dispatch_members[rid] = dispatch_members.get(rid, 0) + 1
        elif ph == "i":
            n_instants += 1
            if track == "request" and name in ("complete", "fail", "shed"):
                terminal[ev["tid"]] = name
        elif ph in ("s", "f"):
            n_flows += 1
            if not isinstance(ev.get("id"), int):
                problems.append(f"event {k}: flow without id")

    seen = admission | queued | set(terminal)
    for rid in sorted(seen - admission):
        problems.append(f"request {rid}: span chain without admission")
    complete = {r for r, t in terminal.items() if t == "complete"}
    for rid in sorted(complete):
        if rid not in queued:
            problems.append(f"request {rid}: completed without a queue span")
        if dispatch_members.get(rid, 0) != 1:
            problems.append(
                f"request {rid}: completed in "
                f"{dispatch_members.get(rid, 0)} device-dispatch spans "
                f"(want exactly 1)")
    open_chains = sorted(seen - set(terminal))
    if require_closed:
        for rid in open_chains:
            problems.append(f"request {rid}: orphan span chain "
                            f"(no terminal complete/fail/shed)")
    if problems:
        raise ValueError("invalid trace:\n  " + "\n  ".join(problems[:20]))
    return {
        "events": sum(1 for e in evs if e.get("ph") != "M"),
        "spans": n_spans,
        "instants": n_instants,
        "flows": n_flows,
        "dropped": other.get("dropped") if isinstance(other, dict) else None,
        "requests": len(seen),
        "complete": len(complete),
        "failed": sum(1 for t in terminal.values() if t == "fail"),
        "shed": sum(1 for t in terminal.values() if t == "shed"),
        "open_chains": open_chains,
        "spans_by_name": spans_by_name,
        "device_span_s": span_sum_s.get("device/device-dispatch", 0.0),
        "ingest_span_s": span_sum_s.get("ingest/ingest-decode", 0.0),
    }
