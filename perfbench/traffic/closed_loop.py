"""Closed-loop clients: each keeps one request outstanding and sends its
next one the moment the last is answered, so a slower server is offered
less load.  Parameters: ``clients``.

Requests are sent and awaited from one thread, oldest first (the server
answers in order).  A request's latency runs from its send to the moment
its answer is in this thread's hands.

A run's record is kept in columns of plain numbers, and each answer (an
array) is kept without its request, so that the traffic's own bookkeeping
leaves the process no more objects for the garbage collector to walk than
the requests in flight.
"""
from __future__ import annotations

import collections
import time

#: how long after the window an answer is still awaited
GRACE_S = 60.0


def record(t0: float, t1: float, n: int = 0) -> dict:
    """An empty record of the window ``[t0, t1]``: for request ``i`` (sent
    as ``send(i)``), when it was ``due`` and ``sent``, when its answer was
    ``done`` and the ``answer`` itself (both None if no answer came)."""
    return {"t0": t0, "t1": t1, "due": [None] * n, "sent": [None] * n,
            "done": [None] * n, "answer": [None] * n}


def await_answer(rec: dict, i: int, req, deadline: float) -> float | None:
    """Wait for request ``i``'s answer until ``deadline``; record it and
    when it came.  Returns when the client heard back (an answer or a
    failure), None if it never did."""
    try:
        out = req.result(timeout=max(deadline - time.monotonic(), 1e-3))
    except TimeoutError:
        return None
    except Exception:     # noqa: BLE001 -- a failed answer: no answer
        return time.monotonic()
    t = time.monotonic()
    rec["done"][i], rec["answer"][i] = t, out
    return t


def run(send, params: dict, seed: int, seconds: float) -> dict:
    """Drive ``send(i) -> request | None`` (None: refused) for ``seconds``;
    returns the window's :func:`record`."""
    clients = int(params["clients"])
    clock = time.monotonic
    t0 = clock()
    end = t0 + seconds
    rec = record(t0, end)
    waiting: collections.deque = collections.deque()

    def send_next() -> None:
        i, t = len(rec["due"]), clock()
        for col, v in (("due", t), ("sent", t), ("done", None),
                       ("answer", None)):
            rec[col].append(v)
        req = send(i)
        if req is not None:
            waiting.append((i, req))

    for _ in range(clients):
        send_next()
    while waiting:
        i, req = waiting.popleft()
        t = await_answer(rec, i, req, end + GRACE_S)
        del req
        if t is not None and t < end:
            send_next()
    return rec
