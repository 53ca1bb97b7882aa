"""Per-layer metric readers on synthetic records, against hand sums."""
from __future__ import annotations

import pytest


def _batch(t, n, stages=True, form=0.4e-3, gather=1e-3, stage=0.5e-3,
           launch=0.25e-3, readback=7e-3, complete=2e-3):
    """The worker's spans for one batch of ``n`` from ``t`` (seconds), as
    the serving driver puts them in its record; returns ``(spans, end)``."""
    out = [("request", "queue", t - 5e-3, t, None),
           ("scheduler", "batch-form", t, t + form, {"n": n})]
    a = t + form
    b = a + gather + stage + launch + readback
    out.append(("device", "device-dispatch", a, b, {"n": n, "bucket": n}))
    if stages:
        for name, d in (("gather", gather), ("pad/stage", stage),
                        ("launch", launch), ("readback", readback)):
            out.append(("device", name, a, a + d, None if name != "pad/stage"
                        else {"n": n}))
            a += d
        out.append(("scheduler", "complete", b + 1e-5, b + 1e-5 + complete,
                    {"n": n}))
    return out, b + 1e-5 + complete


def _record(batches, stages=True):
    spans, t = [], 10.0
    for n, kw in batches:
        got, t = _batch(t + 1e-4, n, stages, **kw)
        spans += got
    return {"batch": 256, "spans": spans, "window": (10.0, t + 1.0)}


def test_host_ms_full_batch_sums_the_workers_stages():
    from perfbench.lib import spec

    read = spec.load_module("metrics", "host_ms_full_batch").read
    rec = _record([(256, {}), (256, {"gather": 2e-3}), (17, {}),
                   (256, {"complete": 4e-3, "launch": 1e-3})])
    # full batches only: 4.15, 5.15 and 6.9 ms; readback is left out
    assert read(rec) == pytest.approx(5.15)
    one = _record([(256, {"form": 1e-3, "stage": 2e-3})])
    assert read(one) == pytest.approx(1.0 + 1.0 + 2.0 + 0.25 + 2.0)


def test_host_ms_full_batch_is_silent_without_the_stages():
    """The parent's program records batch-form, device-dispatch and
    pad/stage alone: no reading, and no error."""
    from perfbench.lib import spec

    read = spec.load_module("metrics", "host_ms_full_batch").read
    rec = _record([(256, {}), (256, {})], stages=False)
    rec["spans"].append(("device", "pad/stage", 10.0, 10.001, {"n": 256}))
    assert read(rec) is None
    assert read({"batch": 256, "spans": []}) is None
    partial = _record([(256, {}), (17, {})])
    partial["spans"] = [s for s in partial["spans"]
                        if s[1] != "launch" or s[2] > 10.01]
    assert read(partial) is None
