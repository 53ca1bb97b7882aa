"""Deterministic fault injection for the serving runtime (the chaos drill
and its tests; production runs never construct it).

Every decision draws from ``np.random.default_rng((seed, index))``, so
the same seed corrupts the same requests the same way on every run,
whatever the arrival order, thread timing or batch composition — and
byte for byte as the reference package's injector does.

Three injection points, through ``BandElasticScheduler``'s ``faults=``
hook:

- ``corrupt(i, data)`` — client-side byte mutation before ``submit()``.
  The default modes always fail to decode: truncation (the EOI marker is
  gone) and an unescaped marker written into the entropy-coded segment.
  ``bitflip`` is available too, but JPEG carries no checksum, so a flip
  may decode silently.
- ``on_ingest(reqs)`` — on the scheduler's ingest thread before a batch
  decodes: an optional delay, and a one-shot SIGKILL of a live decode-pool
  worker (the pool's supervisor respawns it).
- ``on_execute(seq, reqs)`` — in the worker loop before dispatch ``seq``:
  raises :class:`InjectedFault` inside a window of dispatches (executor
  containment, retry, the breaker).
"""
from __future__ import annotations

import multiprocessing.connection
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.codec import ingest as ingest_mod

__all__ = ["FaultSpec", "FaultInjector", "InjectedFault",
           "kill_one_ingest_worker"]


class InjectedFault(RuntimeError):
    """Raised by the executor-fault hook; distinguishable from real bugs."""


#: how long :func:`kill_one_ingest_worker` waits for the pool to notice
KILL_WAIT_S = 10.0


def kill_one_ingest_worker() -> int | None:
    """SIGKILL one live worker of the shared decode pool; returns its pid,
    or None when there is no pool or no live worker.

    Unlike the reference's, it returns only once the worker is dead and
    the pool has marked itself broken (or ``KILL_WAIT_S`` ran out): a
    batch sent sooner could finish on the surviving workers before the
    pool noticed.  So the next batch meets ``BrokenProcessPool`` and the
    supervisor respawns the pool (``codec.ingest.pool_restarts``)."""
    pool = ingest_mod._POOL
    if pool is None:
        return None
    for p in list(getattr(pool, "_processes", {}).values()):
        if p.is_alive():
            os.kill(p.pid, signal.SIGKILL)
            deadline = time.monotonic() + KILL_WAIT_S
            multiprocessing.connection.wait([p.sentinel], timeout=KILL_WAIT_S)
            while not pool._broken and time.monotonic() < deadline:
                time.sleep(0.005)
            return p.pid
    return None


def _truncate(data: bytes, rng: np.random.Generator) -> bytes:
    """Cut the file at 10–80 % of its length: EOI is gone, parsing fails."""
    cut = max(2, int(len(data) * rng.uniform(0.1, 0.8)))
    return data[:cut]


def _inject_marker(data: bytes, rng: np.random.Generator) -> bytes:
    """Write ``0xFF 0xC7`` into the entropy-coded data, just after the SOS
    header (an overwrite inside a DQT/DHT payload may decode silently):
    not a stuffed zero, not a restart marker, so decoding raises a
    ``CodecError``."""
    arr = bytearray(data)
    sos = data.find(b"\xff\xda")
    if sos < 0 or sos + 4 > len(data):
        return _truncate(data, rng)
    lo = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    hi = len(arr) - 4
    if hi <= lo:
        return _truncate(data, rng)
    at = int(rng.integers(lo, hi))
    arr[at:at + 2] = b"\xff\xc7"
    return bytes(arr)


def _bitflip(data: bytes, rng: np.random.Generator) -> bytes:
    """Flip one random bit; may decode silently."""
    arr = bytearray(data)
    at = int(rng.integers(2, len(arr) - 2))
    arr[at] ^= 1 << int(rng.integers(0, 8))
    return bytes(arr)


_MUTATORS = {"truncate": _truncate, "marker": _inject_marker,
             "bitflip": _bitflip}


@dataclass(frozen=True)
class FaultSpec:
    """What to break and when, deterministic in ``seed``.

    ``corrupt_rate``: the share of request indices whose bytes
    :meth:`FaultInjector.corrupt` mutates, the mode drawn uniformly from
    ``corrupt_modes``.  ``decode_delay_s`` stalls the ingest thread before
    every batch decode.  ``kill_worker_before_batch``: SIGKILL one decode
    worker when that many ingest batches have been seen (once).
    ``executor_fail_batches``: the half-open window ``[lo, hi)`` of
    dispatch sequence numbers at which ``on_execute`` raises.
    """

    seed: int = 0
    corrupt_rate: float = 0.0
    corrupt_modes: Sequence[str] = ("truncate", "marker")
    decode_delay_s: float = 0.0
    kill_worker_before_batch: int | None = None
    executor_fail_batches: tuple[int, int] | None = None


@dataclass
class FaultInjector:
    """The stateful driver of one :class:`FaultSpec` (one per run)."""

    spec: FaultSpec
    killed_pid: int | None = None
    corrupted: dict[int, str] = field(default_factory=dict)
    _ingest_batches: int = 0

    def corrupt(self, index: int, data: bytes) -> bytes:
        """Maybe mutate request ``index``'s bytes (pure in (seed, index));
        the mode lands in ``corrupted[index]``, so the caller knows which
        requests must fail."""
        spec = self.spec
        if spec.corrupt_rate <= 0.0:
            return data
        rng = np.random.default_rng((spec.seed, index))
        if rng.random() >= spec.corrupt_rate:
            return data
        mode = str(rng.choice(list(spec.corrupt_modes)))
        self.corrupted[index] = mode
        return _MUTATORS[mode](data, rng)

    def on_ingest(self, reqs) -> None:
        """The scheduler's ingest-thread hook, before each batch decode."""
        spec = self.spec
        self._ingest_batches += 1
        if (spec.kill_worker_before_batch is not None
                and self.killed_pid is None
                and self._ingest_batches >= spec.kill_worker_before_batch):
            self.killed_pid = kill_one_ingest_worker()
        if spec.decode_delay_s > 0.0:
            time.sleep(spec.decode_delay_s)

    def on_execute(self, seq: int, reqs) -> None:
        """The worker-loop hook, before dispatch ``seq``: raises inside the
        window, on every retry too (an injected fault is not transient, so
        it exhausts the retry budget and surfaces)."""
        win = self.spec.executor_fail_batches
        if win is not None and win[0] <= seq < win[1]:
            raise InjectedFault(f"injected executor fault at dispatch {seq}")
