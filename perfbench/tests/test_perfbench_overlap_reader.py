"""The ``batch_overlap_share`` reader on synthetic span records."""
from __future__ import annotations

import pytest


def _record(dispatches, batch=256):
    """A record of ``device-dispatch`` spans, one a ``(n, behind)`` pair
    (``behind`` None: the span has no such arg, as the parent's)."""
    spans, t = [], 10.0
    for n, behind in dispatches:
        args = {"n": n, "bucket": n, "seq": len(spans)}
        if behind is not None:
            args["behind"] = behind
        spans.append(("device", "device-dispatch", t, t + 8e-3, args))
        spans.append(("device", "gather", t, t + 1e-3, {"seq": 0}))
        t += 5e-3
    return {"batch": batch, "spans": spans, "window": (10.0, t + 1.0)}


def _read(rec):
    from perfbench.lib import spec

    return spec.load_module("metrics", "batch_overlap_share").read(rec)


@pytest.mark.parametrize("behind, want", [(1, 100.0), (0, 0.0)])
def test_every_full_batch_or_none_overlapped(behind, want):
    assert _read(_record([(256, behind)] * 5)) == pytest.approx(want)


def test_only_full_batches_count():
    rec = _record([(256, 1), (256, 0), (17, 1), (256, 1), (3, 0),
                   (256, 1)])
    assert _read(rec) == pytest.approx(75.0)
    # a dispatch outside the window is left out
    rec["spans"].append(("device", "device-dispatch", 1.0, 1.01,
                         {"n": 256, "behind": 0}))
    assert _read(rec) == pytest.approx(75.0)


def test_silent_without_behind():
    """The parent's program records no ``behind``: no reading, no error."""
    assert _read(_record([(256, None), (256, None), (17, None)])) is None
    assert _read(_record([(17, 1)])) is None
    assert _read({"batch": 256, "spans": []}) is None
