"""The port's flight recorder (``repro_torch.serving.trace.Tracer``): its
packed event store against the reference package's ring of tuples
(``repro.serving.trace.Tracer``), on the CPU.

Contracts:

* **ring** — the newest ``capacity`` events survive, oldest first, across
  chunk boundaries and wrap-around; ``dropped`` counts the evictions; no
  record is lost to concurrent writers;
* **no garbage** — events without ``args`` create no object the garbage
  collector tracks;
* **the reference's output** — the same calls give the same
  ``events()`` tuples, the same ``summary()`` and the same export, but
  for the port's ``otherData.clock_anchor``;
* **the shared clock** — a span mapped through the tracer's anchor
  contains the ``torch.profiler`` interval of the work it wraps.
"""
import gc
import json
import os
import sys
import threading

import pytest
import torch

from repro.serving.trace import Tracer as RefTracer
from repro.serving.trace import validate_trace as ref_validate
from repro_torch.serving import trace as trace_mod
from repro_torch.serving.trace import Tracer, validate_trace


class FakeClock:
    """Deterministic monotonic clock: advances only on ``tick``."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


def _record(tr, clk, n):
    """``n`` rounds of what a served request and its batch record."""
    for i in range(n):
        t0 = clk.tick(0.001)
        tr.span("request", "admission", t0, clk.tick(0.0005), tid=i)
        tr.span("request", "queue", t0, clk.tick(0.25), tid=i)
        tr.flow(i, ("request", i, t0), ("device", 0, clk.tick(0.01)))
        tr.span("device", "device-dispatch", clk(), clk.tick(0.125),
                args={"n": 1, "rids": [i]})
        tr.instant("request", "complete", t=clk(), tid=i)
        if i % 5 == 0:
            tr.instant("scheduler", "tier-switch", t=clk(),
                       args={"from": "top", "to": "b32"})


@pytest.mark.parametrize("capacity,chunk", [(10, 4), (12, 4), (7, 64)])
def test_ring_keeps_newest_across_chunks(monkeypatch, capacity, chunk):
    monkeypatch.setattr(trace_mod, "CHUNK_EVENTS", chunk)
    clk = FakeClock()
    tr = Tracer(capacity=capacity, clock=clk)
    for i in range(capacity - 3):
        tr.instant("scheduler", f"ev{i}", t=clk.tick(), args={"i": i})
    assert tr.dropped == 0
    assert [e[3] for e in tr.events()] == [
        f"ev{i}" for i in range(capacity - 3)]
    for i in range(capacity - 3, 3 * capacity + 1):
        tr.instant("scheduler", f"ev{i}", t=clk.tick(),
                   args={"i": i} if i % 2 else None)
    evs = tr.events()
    first = 2 * capacity + 1
    assert [e[3] for e in evs] == [f"ev{i}" for i in
                                   range(first, 3 * capacity + 1)]
    assert [e[6] for e in evs] == [{"i": i} if i % 2 else None
                                   for i in range(first, 3 * capacity + 1)]
    assert tr.dropped == first
    # evicted events' args are released with them
    assert len(tr._args) == sum(i % 2 for i in
                                range(first, 3 * capacity + 1))
    assert tr.export()["otherData"]["dropped"] == first


@pytest.mark.parametrize("capacity,chunk", [(10, 4), (1000, 64)])
def test_bulk_records_equal_single_calls(monkeypatch, capacity, chunk):
    """``span_many``, ``flow_many`` and ``instant_many`` record what the
    single calls record in the same order, across chunks and wrap-around,
    releasing the args of the events they evict."""
    monkeypatch.setattr(trace_mod, "CHUNK_EVENTS", chunk)
    clocks = FakeClock(), FakeClock()
    bulk, single = (Tracer(capacity, clock=c) for c in clocks)
    for tr, clk in ((bulk, clocks[0]), (single, clocks[1])):
        tr.instant("scheduler", "tier-switch", t=clk.tick(), args={"k": 1})
    for step in range(3):
        rids = list(range(7 * step, 7 * step + 7))
        starts = [100.0 + 0.1 * r for r in rids]
        t1, t2 = 103.0 + step, 104.0 + step
        bulk.span_many("request", "queue", starts, t1, tids=rids)
        bulk.flow_many(rids, ("request", rids, t1), ("device", 0, t2))
        bulk.instant_many("request", "complete", t2, tids=rids)
        for r, t0 in zip(rids, starts):
            single.span("request", "queue", t0, t1, tid=r)
        for r in rids:
            single._push(2, "request", r, "req", t1, r, None)
        for r in rids:
            single._push(3, "device", 0, "req", t2, r, None)
        for r in rids:
            single.instant("request", "complete", t=t2, tid=r)
        assert bulk.events() == single.events()
        assert bulk.dropped == single.dropped
        assert len(bulk._args) == len(single._args)


def test_concurrent_writers_lose_nothing(monkeypatch):
    """More writers than cores, switching often: every record survives
    whole or is counted as dropped."""
    monkeypatch.setattr(trace_mod, "CHUNK_EVENTS", 64)
    tr = Tracer(capacity=1000)
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 1000

    def hammer(k):
        for i in range(per_thread):
            tr.span("request", "queue", 0.0, 1.0, tid=k * per_thread + i)

    ts = [threading.Thread(target=hammer, args=(k,))
          for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    evs = tr.events()
    assert len(evs) == 1000
    assert tr.dropped == n_threads * per_thread - 1000
    # every surviving record is whole: one writer's tid, its own fields
    assert len({e[2] for e in evs}) == 1000
    ts0 = evs[0][4]
    assert all(e[:2] == ("X", "request") and e[3:] == ("queue", ts0, 1.0,
                                                       None) for e in evs)


def test_request_spans_create_no_tracked_objects():
    tr = Tracer(capacity=1 << 18)
    clk = FakeClock()
    tr.span("request", "queue", clk(), clk.tick())  # interns the names
    gc.collect()
    before = len(gc.get_objects())
    for i in range(200_000):
        t = clk.tick(1e-4)
        tr.span("request", "queue", t, t + 5e-5, tid=i)
    gc.collect()
    assert len(gc.get_objects()) - before < 1000
    assert tr.summary()["events"] == 200_001


@pytest.mark.parametrize("capacity", [65536, 37])
def test_same_events_and_export_as_the_reference(capacity):
    clocks = FakeClock(), FakeClock()
    trs = Tracer(capacity, clock=clocks[0]), RefTracer(capacity,
                                                       clock=clocks[1])
    for tr, clk in zip(trs, clocks):
        _record(tr, clk, 20)
        tr.span("device", "x", clk() + 5.0, clk())  # clamped to 0
        tr.instant("scheduler", "reject", args={"reason": "queue-full"})
    assert trs[0].events() == trs[1].events()
    assert trs[0].summary() == trs[1].summary()
    assert trs[0].dropped == trs[1].dropped
    got, want = trs[0].export(), trs[1].export()
    anchor = got["otherData"].pop("clock_anchor")
    assert anchor["t0_s"] == 100.0 and anchor["wall_ns"] > 0
    assert json.dumps(got) == json.dumps(want)


def test_export_validates_in_both_packages():
    clk = FakeClock()
    tr = Tracer(clock=clk)
    _record(tr, clk, 6)
    obj = json.loads(json.dumps(tr.export()))
    summ = validate_trace(obj)
    assert summ == ref_validate(obj)
    assert summ["complete"] == summ["requests"] == 6


def test_anchor_lays_spans_over_the_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = Tracer()

    def wall_ns(t):
        return tr.anchor[1] + round((t - tr.anchor[0]) * 1e9)

    def block(x):
        with record_function("traced-block"):
            for _ in range(10):
                x = torch.tanh(x @ x)
        return x

    x = torch.randn(128, 128)
    # the first profiled session pays the libraries' start-up, and the
    # profiler's clock is calibrated during it: measure the second
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = tr.now()
            x = block(x)
            t1 = tr.now()
    (op,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "traced-block"]
    a, b = op.start_ns(), op.start_ns() + op.duration_ns()
    assert wall_ns(t0) <= a + 1_000_000
    assert wall_ns(t1) >= b - 1_000_000
