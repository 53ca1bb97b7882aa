"""Open-loop Poisson arrivals at a fixed rate: independent users who send
whatever the server's state.  Parameters: ``rate_per_s``.

Every seed gets the same gaps between arrivals, the quantiles of the
exponential distribution at the rate, in an order drawn from the seed and
stretched so that ``rate x seconds`` arrivals fill the window: the seed
changes the order of the work, not its amount.  A request's latency runs
from when it was due, so a stall of the sender counts against every
request it delays; the sender's lateness is recorded apart.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from perfbench.traffic.closed_loop import GRACE_S, await_answer, record


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Offsets (s) of the window's arrivals, in send order."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng(np.random.SeedSequence([int(seed), 1])) \
        .shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])]) \
        * (seconds / gaps.sum())


def run(send, params: dict, seed: int, seconds: float) -> dict:
    """Drive ``send(i) -> request | None`` on the schedule; returns the
    window's record, as :func:`closed_loop.run` does."""
    offsets = arrivals(float(params["rate_per_s"]), seconds, seed)
    clock = time.monotonic
    pending: queue.Queue = queue.Queue()
    t0 = clock()
    end = t0 + seconds
    rec = record(t0, end, len(offsets))
    rec["due"] = (t0 + offsets).tolist()

    def collect() -> None:
        while True:
            item = pending.get()
            if item is None:
                return
            await_answer(rec, *item, end + GRACE_S)

    waiter = threading.Thread(target=collect, name="client-collect")
    waiter.start()
    try:
        for i, due in enumerate(rec["due"]):
            lag = due - clock()
            if lag > 0:
                time.sleep(lag)
            rec["sent"][i] = clock()
            req = send(i)
            if req is not None:
                pending.put((i, req))
            del req
    finally:
        pending.put(None)
        waiter.join()
    return rec
