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
``scheduler``   batch-form  batch taken from the queue (the take and the tier
                            selection) → executor dispatch
``scheduler``   complete    after the dispatch: the QoS estimate, the batch's
                            metrics and each request's completion (args ``n``)
``ingest``      ingest-decode  one bytes batch through ``codec.ingest_batch``
``ingest``      decode-shard   one spawn-pool shard of that batch (tid = shard)
``device``      device-dispatch  batch array to logits on the host (args
                            ``seq``, the dispatch number, and ``behind``, 1
                            when launched while an earlier batch was not yet
                            read back); its children, in order (args
                            ``seq``):
``device``      gather      the batch array from the payloads (``np.stack``;
                            on the bytes path ``pack_tiles``)
``device``      pad/stage   host staging copy into the pinned bucket buffer
``device``      launch      the copies and the graph replay enqueued
``device``      readback    waiting for the batch, and the logits to the host
``request``     admission / queue   per-request rows (tid = request id),
                            written in bulk once the batch is done with
``request``     complete / fail / shed   terminal instants closing the chain
=============== ========== =====================================================

The worker's own time a batch is ``batch-form`` + ``gather`` +
``pad/stage`` + ``launch`` + ``complete``: the serial chain but the wait
in ``readback`` and the recorder's own writes of the batch's request
rows, which follow ``complete``.  Through the scheduler's launch window
(a CUDA grid) a batch's ``device-dispatch`` also holds the completion of
the batch before it and the launch of the batch after it; pair stages
with their batch by ``seq``.  Outside the window (an eager CPU grid)
``device-dispatch`` is the interval the report's ``device_wall_s``
accumulates; in it, each batch adds its host staging and its own time on
the card.

Instant events mark tier switches, breaker transitions, ingest-pool
restarts, and post-warmup compiles.  Batches link to their member
requests through flow events (``id`` = request id), so clicking a
``device-dispatch`` slice in Perfetto highlights every request it
served.

The recorder is a true flight recorder: a ring of the newest
``capacity`` events, O(1) per record, with a ``dropped`` counter for
evicted history — it can stay on under sustained load without growing.
Events are packed records in preallocated chunks, not Python objects, so
a traced run does not feed the garbage collector one object an event.
The clock is injectable (tests drive it deterministically); timestamps
are exported relative to tracer construction in microseconds, with the
construction's ``(time.monotonic(), time.time_ns())`` anchor under
``otherData.clock_anchor``, so the file lays over a ``torch.profiler``
trace of the same window.

:data:`NULL_TRACER` is the disabled no-op twin — the scheduler threads
it unconditionally so tracing costs one attribute check when off.
:func:`validate_trace` is the schema/chain checker CI and the tests
share.  :func:`device_profile` (also exported under the reference's name
``jax_profile``) brackets the same window with ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import struct
import threading
import time
from typing import Any, Callable

import numpy as np

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "TRACKS",
    "validate_trace",
    "device_profile",
    "jax_profile",
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

    def span_many(self, *a, **kw) -> None:
        pass

    def instant_many(self, *a, **kw) -> None:
        pass

    def flow_many(self, *a, **kw) -> None:
        pass

    def events(self) -> list:
        return []

    def summary(self) -> dict:
        return {"enabled": False, "events": 0, "dropped": 0}


NULL_TRACER = NullTracer()


#: one event of the store: phase code, track and name codes (interned),
#: tid, start relative to construction (s), and the duration (s) or, for a
#: flow record, the flow id
_REC = struct.Struct("<bHHqdd")
_PACK = _REC.pack_into
_DTYPE = np.dtype([("ph", "i1"), ("track", "<u2"), ("name", "<u2"),
                   ("tid", "<i8"), ("ts", "<f8"), ("val", "<f8")])
_PHASE_CODES = ("X", "i", "s", "f")
#: events one chunk of the store holds
CHUNK_EVENTS = 1 << 16


class Tracer:
    """Thread-safe bounded ring of trace events.

    ``capacity`` bounds memory: the ring keeps the newest ``capacity``
    events and counts evictions in :attr:`dropped` (a flight recorder
    keeps the end of the story, not the beginning).  ``clock`` is any
    monotonic ``() -> float`` (seconds); every recorded timestamp is
    a reading of this clock, stored relative to construction time.

    Each event is one packed 29-byte record (:data:`_REC`) in chunks of
    :data:`CHUNK_EVENTS` allocated on first use, so a large capacity
    costs only what is recorded; track and name are codes into an
    interned string table, and ``args`` dicts sit in a side table keyed
    by the event's slot.  An event without ``args`` therefore creates no
    object the garbage collector tracks, and recording is one
    ``pack_into`` under a lock; a batch's per-request events go in with
    one hold of the lock (:meth:`span_many`, :meth:`instant_many`,
    :meth:`flow_many`).  :meth:`events` builds the tuples only when
    called.

    :attr:`anchor` is one ``(time.monotonic(), time.time_ns())`` pair read
    at construction, right after the clock's zero ``t0_s``: with the
    default clock, an event at ``ts`` seconds lies at wall-clock
    nanosecond ``anchor[1] + (t0_s + ts - anchor[0]) * 1e9``, the clock
    of ``torch.profiler`` traces (:func:`device_profile`).  It is exported
    under ``otherData.clock_anchor``.
    """

    enabled = True

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._t0 = clock()
        self.anchor = (time.monotonic(), time.time_ns())
        self._lock = threading.Lock()
        self._chunks: list[bytearray | None] = [None] * (
            -(-self.capacity // CHUNK_EVENTS))
        self._n = 0                       # events ever recorded
        # interned track and name codes; code 0 is never handed out, so a
        # lookup's miss and a code can share one truth test
        self._codes: dict[str, int] = {}
        self._strings: list[str] = [""]
        self._args: dict[int, dict] = {}  # slot -> args

    # ------------------------------------------------------------- recording
    def now(self) -> float:
        """Current clock reading (absolute; pass to :meth:`span`)."""
        return self._clock()

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(self._n - self.capacity, 0)

    def _code(self, s: str) -> int:
        c = self._codes.get(s)
        if c is None:
            c = self._codes[s] = len(self._strings)
            self._strings.append(s)
        return c

    def _new_chunk(self, c: int) -> bytearray:
        chunk = self._chunks[c] = bytearray(_REC.size * min(
            CHUNK_EVENTS, self.capacity - c * CHUNK_EVENTS))
        return chunk

    def _push(self, ph: int, track: str, tid: int, name: str, t: float,
              val: float, args: dict | None) -> None:
        codes = self._codes
        with self._lock:
            n = self._n
            self._n = n + 1
            slot = n % self.capacity
            c, off = divmod(slot, CHUNK_EVENTS)
            chunk = self._chunks[c] or self._new_chunk(c)
            if n >= self.capacity:
                self._args.pop(slot, None)
            if args is not None:
                self._args[slot] = args
            _PACK(chunk, off * _REC.size, ph,
                  codes.get(track) or self._code(track),
                  codes.get(name) or self._code(name), tid,
                  t - self._t0, val)

    def span(self, track: str, name: str, t0: float, t1: float, *,
             tid: int = 0, args: dict | None = None) -> None:
        """One completed interval ``[t0, t1]`` (absolute clock readings)."""
        self._push(0, track, tid, name, t0, max(t1 - t0, 0.0), args)

    def instant(self, track: str, name: str, *, t: float | None = None,
                tid: int = 0, args: dict | None = None) -> None:
        """One point event (``t`` defaults to the clock's now)."""
        t = self._clock() if t is None else t
        self._push(1, track, tid, name, t, 0.0, args)

    def flow(self, fid: int, src: tuple[str, int, float],
             dst: tuple[str, int, float]) -> None:
        """Link two slices with a flow arrow (``fid`` = request id).

        ``src``/``dst`` are ``(track, tid, t)`` — the timestamps must
        fall inside the slices the arrow should bind to.
        """
        track, tid, t = src
        self._push(2, track, tid, "req", t, int(fid), None)
        track, tid, t = dst
        self._push(3, track, tid, "req", t, int(fid), None)

    def _push_many(self, n: int, ph: int, track: str, tid, name: str,
                   t, val) -> None:
        """``n`` events without args, in order, in one hold of the lock;
        ``tid``, ``t`` and ``val`` are scalars or sequences of ``n``."""
        rec = np.empty(n, _DTYPE)
        rec["ph"], rec["tid"], rec["ts"], rec["val"] = ph, tid, t, val
        rec["ts"] -= self._t0
        size = _REC.size
        with self._lock:
            rec["track"], rec["name"] = self._code(track), self._code(name)
            raw = memoryview(rec.tobytes())
            start, cap = self._n, self.capacity
            self._n += n
            if self._args:
                for p in range(max(start, cap), start + n):
                    self._args.pop(p % cap, None)
            done = 0
            while done < n:
                c, off = divmod((start + done) % cap, CHUNK_EVENTS)
                chunk = self._chunks[c] or self._new_chunk(c)
                k = min(n - done, len(chunk) // size - off)
                chunk[off * size:(off + k) * size] = \
                    raw[done * size:(done + k) * size]
                done += k

    def span_many(self, track: str, name: str, t0s, t1, *, tids) -> None:
        """A :meth:`span` from each of ``t0s`` to ``t1`` (one reading, or
        one each) with tid ``tids[k]``, in one hold of the lock: a batch
        closing its requests' rows."""
        t0s = np.asarray(t0s, np.float64)
        self._push_many(len(t0s), 0, track, tids, name, t0s, np.maximum(
            np.asarray(t1, np.float64) - t0s, 0.0))

    def instant_many(self, track: str, name: str, t: float, *,
                     tids) -> None:
        """An :meth:`instant` at ``t`` for each tid of ``tids``, in one
        hold of the lock."""
        self._push_many(len(tids), 1, track, tids, name, t, 0.0)

    def flow_many(self, fids, src: tuple, dst: tuple) -> None:
        """A :meth:`flow` for each id of ``fids``: all the sources, then
        all the destinations; the tids and times of ``src``/``dst`` are
        scalars or sequences like ``fids``."""
        track, tid, t = src
        self._push_many(len(fids), 2, track, tid, "req", t, fids)
        track, tid, t = dst
        self._push_many(len(fids), 3, track, tid, "req", t, fids)

    # --------------------------------------------------------------- export
    def _snapshot(self):
        """``(records, slots, strings, args, dropped)``: the surviving
        events oldest first as a numpy record array, their ring slots, and
        copies of the tables, taken under the lock."""
        with self._lock:
            n, cap = self._n, self.capacity
            runs = [(0, n)] if n <= cap else [(n % cap, cap), (0, n % cap)]
            parts = []
            for a, b in runs:
                while a < b:
                    c, off = divmod(a, CHUNK_EVENTS)
                    k = min(b - a, CHUNK_EVENTS - off)
                    parts.append(bytes(self._chunks[c][
                        off * _REC.size:(off + k) * _REC.size]))
                    a += k
            strings = list(self._strings)
            args = dict(self._args)
        recs = np.frombuffer(b"".join(parts), _DTYPE)
        slots = np.concatenate([np.arange(a, b) for a, b in runs])
        return recs, slots, strings, args, max(n - cap, 0)

    def _events(self) -> tuple[list[tuple], int]:
        recs, slots, S, A, dropped = self._snapshot()
        P = _PHASE_CODES
        return [(P[p], S[tk], tid, S[nm], ts,
                 int(v) if p >= 2 else v, A.get(sl))
                for p, tk, nm, tid, ts, v, sl in zip(
                    recs["ph"].tolist(), recs["track"].tolist(),
                    recs["name"].tolist(), recs["tid"].tolist(),
                    recs["ts"].tolist(), recs["val"].tolist(),
                    slots.tolist())], dropped

    def events(self) -> list[tuple]:
        """Snapshot of the ring (oldest surviving event first), as
        ``(ph, track, tid, name, t_rel_s, dur_s_or_flow_id, args)``."""
        return self._events()[0]

    def summary(self) -> dict:
        """Cheap run summary for reports/narration (no event payloads)."""
        recs, _, S, _, dropped = self._snapshot()
        keep = recs["ph"] <= 1  # spans and instants
        keys = (recs["track"][keep].astype(np.int64) << 16) \
            | recs["name"][keep]
        uniq, first, counts = np.unique(keys, return_index=True,
                                        return_counts=True)
        by_name = {f"{S[k >> 16]}/{S[k & 0xFFFF]}": c for _, k, c in sorted(
            zip(first.tolist(), uniq.tolist(), counts.tolist()))}
        return {"enabled": True, "events": len(recs), "dropped": dropped,
                "capacity": self.capacity, "by_name": by_name}

    def export(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        One pid per component track (process metadata named), ``X``
        complete events for spans, ``i`` instants, ``s``/``f`` flow
        pairs.  Timestamps/durations are microseconds relative to
        tracer construction; ``otherData.clock_anchor`` maps them onto
        the wall clock (:attr:`anchor`).
        """
        evs, dropped = self._events()
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
                          "events": len(evs),
                          "clock_anchor": {"t0_s": self._t0,
                                           "monotonic_s": self.anchor[0],
                                           "wall_ns": self.anchor[1]}},
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
    ``device_span_s``/``ingest_span_s`` (span sums that reconcile with
    the report's ``device_wall_s``/``ingest_wall_s`` where batches run
    one at a time), and
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


# ---------------------------------------------------------------------------
# device-profiler window
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def device_profile(trace_dir: str | None, device=None):
    """Bracket a window with ``torch.profiler`` when ``trace_dir`` is set.

    CPU activity, plus CUDA activity when ``device`` (default: CUDA) is a
    CUDA device; on exit, after a device synchronise, the profile is
    written as Chrome trace-event JSON to
    ``trace_dir/torch_profile_<pid>.json`` (the path the ``with`` yields),
    a crashed window included, so the host's spans in the flight recorder
    and the kernels' device times can be read side by side.  ``None``
    yields None and profiles nothing.  Unlike the reference's
    ``jax_profile``, which degrades to a no-op when its backend is
    unavailable, a profiler that fails to start or to write raises.
    """
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"torch_profile_{os.getpid()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(path)


#: the reference package's name for the window (``repro.serving``)
jax_profile = device_profile
