"""Band-elastic QoS policy: pick the ladder tier per batch, with hysteresis.

The signals are deliberately cheap and local — things the scheduler
already knows at batch-formation time:

* **queue depth** — pending requests relative to the batch size.  Above
  ``QosPolicy.high_depth`` batches of backlog the system is considered
  overloaded; below ``low_depth`` it is draining.
* **deadline slack** — the head-of-queue request's remaining time vs the
  current tier's observed batch latency (an EMA per tier).  A head that
  cannot make its deadline at the current tier is an overload signal even
  when the queue is short.

Degradation walks one rung down per decision, recovery one rung up — and
both require ``hysteresis`` *consecutive* batches of agreeing signal, so
a single bursty arrival or one fast batch does not thrash the ladder.
Recovery additionally requires the better tier's expected latency to fit
the current drain budget (``recover_margin``) so the system does not
climb straight back into the overload that demoted it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["QosPolicy", "TierSelector"]


@dataclasses.dataclass(frozen=True)
class QosPolicy:
    """Knobs of the band-elastic tier policy.

    ``high_depth``/``low_depth`` are queue depths in units of *batches*
    (pending / batch_size).  ``hysteresis`` is the number of consecutive
    agreeing decisions required before a switch.  ``latency_ema`` is the
    smoothing factor for per-tier batch-latency estimates.
    ``recover_margin`` scales the better tier's latency estimate when
    deciding whether recovery is safe (>1 = conservative).
    """

    high_depth: float = 2.0
    low_depth: float = 0.5
    hysteresis: int = 2
    latency_ema: float = 0.5
    recover_margin: float = 1.5

    def __post_init__(self):
        if self.high_depth <= self.low_depth:
            raise ValueError("high_depth must exceed low_depth "
                             f"({self.high_depth} <= {self.low_depth})")
        if self.hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")


class TierSelector:
    """Stateful tier chooser over an ``n_tiers``-rung ladder.

    Tier 0 is best quality; higher indices are narrower bands.  The
    scheduler calls :meth:`select` before forming each batch and
    :meth:`observe` after it completes; ``on_switch`` (e.g.
    ``ServeMetrics.record_switch``) fires on every tier change.
    """

    def __init__(self, n_tiers: int, policy: QosPolicy | None = None, *,
                 on_switch: Callable[[int, str, str, str], None] | None = None,
                 tier_names: list[str] | None = None):
        if n_tiers < 1:
            raise ValueError("need at least one tier")
        self.n_tiers = n_tiers
        self.policy = policy or QosPolicy()
        self.tier = 0
        self._names = tier_names or [str(i) for i in range(n_tiers)]
        self._on_switch = on_switch
        self._over = 0
        self._under = 0
        self._seq = 0
        # keyed (tier, bucket): the plan grid runs one executable per
        # batch bucket, and a bucket-1 batch says nothing about bucket-8
        # latency — bucket=None is the pre-grid wildcard (fixed-shape
        # schedulers and the unit tests), matching any bucket on read
        self._latency: dict[tuple[int, int | None], float] = {}

    # ------------------------------------------------------------ estimates
    def observe(self, tier: int, batch_wall_s: float, *,
                bucket: int | None = None) -> None:
        """Fold one completed batch's wall clock into the (tier, bucket)
        cell's EMA (``bucket=None`` = the tier-wide wildcard cell)."""
        a = self.policy.latency_ema
        key = (tier, bucket)
        prev = self._latency.get(key)
        self._latency[key] = (batch_wall_s if prev is None
                              else a * batch_wall_s + (1 - a) * prev)

    def _tier_latency(self, tier: int, bucket: int | None) -> float | None:
        """Best estimate within one tier: the exact (tier, bucket) cell,
        else the tier's nearest observed bucket (wildcard entries match
        at distance 0; with no target bucket the *largest* observed
        bucket wins — the conservative, worst-case-latency choice)."""
        exact = self._latency.get((tier, bucket))
        if exact is not None:
            return exact
        best, best_d = None, None
        for (t, b), v in self._latency.items():
            if t != tier:
                continue
            if bucket is None:
                d = -(b if b is not None else 1 << 30)
            else:
                d = 0 if b is None else abs(b - bucket)
            if best_d is None or d < best_d:
                best, best_d = v, d
        return best

    def est_latency(self, tier: int, bucket: int | None = None
                    ) -> float | None:
        """Best latency estimate for ``tier`` (at ``bucket``, when the
        grid knows it): the tier's own cells, else the nearest observed
        tier's (better a stale neighbour than nothing)."""
        own = self._tier_latency(tier, bucket)
        if own is not None:
            return own
        for d in range(1, self.n_tiers):
            for t in (tier - d, tier + d):
                est = self._tier_latency(t, bucket)
                if est is not None:
                    return est
        return None

    # ------------------------------------------------------------ selection
    def select(self, *, pending: int, batch: int,
               head_slack_s: float | None = None,
               bucket: int | None = None) -> int:
        """Tier for the next batch.

        ``pending`` — total queued requests; ``batch`` — slot count;
        ``head_slack_s`` — remaining time until the oldest queued
        request's deadline (None = no deadline traffic); ``bucket`` —
        the capture bucket the batch will run in, keying the latency
        estimates to the right grid cell.
        """
        self._seq += 1
        p = self.policy
        depth = pending / max(batch, 1)
        est = self.est_latency(self.tier, bucket)

        overload = depth >= p.high_depth
        reason = f"queue depth {pending} >= {p.high_depth:g}x batch {batch}"
        if not overload and head_slack_s is not None and est is not None \
                and est > head_slack_s:
            overload = True
            reason = (f"head deadline slack {head_slack_s * 1e3:.0f}ms < "
                      f"tier latency {est * 1e3:.0f}ms")

        drained = depth <= p.low_depth
        if drained and self.tier > 0:
            better = self.est_latency(self.tier - 1, bucket)
            if head_slack_s is not None and better is not None \
                    and better * p.recover_margin > head_slack_s:
                drained = False  # recovery would blow the head deadline

        if overload:
            self._over += 1
            self._under = 0
            if self._over >= p.hysteresis and self.tier < self.n_tiers - 1:
                self._switch(self.tier + 1, reason)
                self._over = 0
        elif drained:
            self._under += 1
            self._over = 0
            if self._under >= p.hysteresis and self.tier > 0:
                self._switch(self.tier - 1,
                             f"queue drained to {pending} "
                             f"<= {p.low_depth:g}x batch {batch}")
                self._under = 0
        else:
            self._over = 0
            self._under = 0
        return self.tier

    def estimates(self) -> dict[str, float]:
        """Point-in-time (tier, bucket) EMA snapshot, keyed
        ``"{tier}/b{bucket}"`` (``b*`` = the wildcard cell) — the live
        view ``health()`` exports so an operator can see what the
        selector currently believes about each grid cell."""
        return {
            f"{self._names[t]}/b{'*' if b is None else b}": round(v, 6)
            for (t, b), v in sorted(self._latency.items(),
                                    key=lambda kv: (kv[0][0],
                                                    kv[0][1] or 0))
        }

    def note_failure(self) -> None:
        """A batch at the current tier failed (executor fault, not load).

        Resets both hysteresis streaks: a failed batch produced neither a
        latency observation nor evidence about queue pressure, so letting
        its ``select`` vote stand would let a fault burst walk the ladder
        on garbage signal.
        """
        self._over = 0
        self._under = 0

    def _switch(self, to: int, reason: str) -> None:
        frm = self.tier
        self.tier = to
        if self._on_switch is not None:
            self._on_switch(self._seq, self._names[frm], self._names[to],
                            reason)
