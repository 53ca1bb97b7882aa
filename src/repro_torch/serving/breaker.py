"""Circuit breaker for the serving runtime.

The breaker watches *service-level* failures (executor crashes, ingest
infrastructure faults) and trips to fast-reject when the service is
evidently unhealthy, so a dying backend sheds load in O(1) per request
instead of queueing doomed work against deadlines.  Per-request input
errors (``codec.CodecError`` — *that request's* bytes are bad) never
feed it: corrupt traffic is contained request-by-request and must not
starve healthy requests (``serving.scheduler``).

States follow the classic pattern:

- **closed** — normal service.  Failures land in a rolling window; the
  breaker opens when the window failure rate or the consecutive-failure
  streak crosses :class:`BreakerPolicy` thresholds.
- **open** — every ``allow()`` is refused (the scheduler maps this to
  ``ServiceUnavailable``) until ``open_s`` has elapsed.
- **half_open** — probe mode: requests flow again, but one failure
  re-opens immediately and ``half_open_successes`` consecutive successes
  close.

The clock is injectable so tests drive the open→half_open timer
deterministically; ``on_transition`` lets the scheduler export the state
timeline through ``ServeMetrics``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

__all__ = ["BreakerPolicy", "CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass(frozen=True)
class BreakerPolicy:
    """Thresholds for :class:`CircuitBreaker`.

    ``window`` outcomes back the rolling failure rate; the rate only
    trips after ``min_samples`` outcomes so a cold start can't open on
    one failure.  ``max_consecutive`` is the fast path for hard-down
    backends (opens regardless of the window).  ``open_s`` is the
    open→half_open timer; ``half_open_successes`` consecutive probe
    successes close the breaker again.
    """

    window: int = 32
    failure_rate: float = 0.5
    min_samples: int = 8
    max_consecutive: int = 4
    open_s: float = 1.0
    half_open_successes: int = 2


class CircuitBreaker:
    """Thread-safe three-state breaker (see module docstring)."""

    def __init__(self, policy: BreakerPolicy | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[str, str, str], None]
                 | None = None):
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: deque[bool] = deque(maxlen=self.policy.window)
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_successes = 0
        self._last_failure_reason: str | None = None
        self._since = self._clock()   # clock reading at last transition
        self._transitions = 0

    # -- internal ----------------------------------------------------------

    def _transition(self, to: str, reason: str) -> None:
        """Move to ``to`` (lock held) and notify outside state mutation."""
        frm, self._state = self._state, to
        if to == OPEN:
            self._opened_at = self._clock()
        if to == HALF_OPEN:
            self._probe_successes = 0
        if to == CLOSED:
            self._outcomes.clear()
            self._consecutive = 0
        if frm != to:
            self._since = self._clock()
            self._transitions += 1
            if self._on_transition is not None:
                self._on_transition(frm, to, reason)

    def _should_open(self) -> bool:
        p = self.policy
        if self._consecutive >= p.max_consecutive:
            return True
        if len(self._outcomes) >= p.min_samples:
            rate = sum(self._outcomes) / len(self._outcomes)
            if rate >= p.failure_rate:
                return True
        return False

    # -- public ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request be admitted right now?

        In ``open``, flips to ``half_open`` once the timer expires and
        admits the probe; otherwise refuses.
        """
        with self._lock:
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.policy.open_s:
                    self._transition(HALF_OPEN, "open timer expired")
                    return True
                return False
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.policy.half_open_successes:
                    self._transition(CLOSED, "probe successes")
            elif self._state == CLOSED:
                self._outcomes.append(False)

    def record_failure(self, reason: str = "failure") -> None:
        with self._lock:
            self._last_failure_reason = reason
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._transition(OPEN, f"probe failed: {reason}")
                return
            if self._state == CLOSED:
                self._outcomes.append(True)
                if self._should_open():
                    self._transition(OPEN, reason)

    def snapshot(self) -> dict:
        """Point-in-time view for ``health()`` / report export."""
        with self._lock:
            n = len(self._outcomes)
            return {
                "state": self._state,
                "state_age_s": round(self._clock() - self._since, 6),
                "transitions": self._transitions,
                "window_failure_rate": (sum(self._outcomes) / n) if n else 0.0,
                "window_samples": n,
                "consecutive_failures": self._consecutive,
                "last_failure_reason": self._last_failure_reason,
            }
