"""What the per-layer metric readers share: the program's spans in the
window, and the device trace's shares."""
from __future__ import annotations

import numpy as np


def spans(record: dict, track: str, name: str,
          window: str = "window") -> list[tuple]:
    """The program's ``track/name`` spans that started in ``window`` (the
    traffic's, or ``"traced"``: the profiled one, which also holds the
    answers awaited after the traffic stopped), as ``(start, end, args)``
    (monotonic seconds)."""
    t0, t1 = record.get(window, (-np.inf, np.inf))
    return [(a, b, args) for tk, nm, a, b, args in record.get("spans", ())
            if tk == track and nm == name and t0 <= a <= t1]


def percentile_ms(values, q: float):
    return float(np.percentile(values, q)) * 1e3 if len(values) else None


def idle_share(record: dict):
    """Percent of the traced window in which nothing ran on the device;
    None without a trace or without a device operation in it."""
    tr = record.get("trace")
    if tr is None or not tr.enabled or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
