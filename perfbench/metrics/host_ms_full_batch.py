"""Scheduler layer: the worker thread's own time for one full batch (the
cell's ``batch`` images), median over the window's full batches.  A
batch's time is the sum of its ``scheduler/batch-form``, ``device/gather``,
``device/pad/stage``, ``device/launch`` and ``scheduler/complete`` spans:
the worker's serial chain from the take to the last completion, but the
wait in ``device/readback`` (the recorder's writes of the request rows
follow complete, outside it).  The three
``device`` stages are the children of the batch's ``device-dispatch``;
batch-form is the worker's last span before it and complete its first
after it.  None where the program records no such stages."""
from bisect import bisect_left, bisect_right

from perfbench.lib.readers import percentile_ms, spans

#: the children of ``device/device-dispatch`` counted as the worker's own
STAGES = ("gather", "pad/stage", "launch")
#: seconds of rounding allowed where two spans share a clock reading
EPS = 1e-9


def _sorted(record: dict, key: str) -> tuple[list, list]:
    out = sorted(((a, b, args) for tk, nm, a, b, args in
                  record.get("spans", ()) if f"{tk}/{nm}" == key),
                 key=lambda s: s[0])
    return out, [s[0] for s in out]


def read(record: dict):
    n = record["batch"]
    stages = [_sorted(record, f"device/{k}") for k in STAGES]
    forms, form_t = _sorted(record, "scheduler/batch-form")
    done, done_t = _sorted(record, "scheduler/complete")
    if not done or not all(s for s, _ in stages):
        return None
    walls = []
    for a, b, args in spans(record, "device", "device-dispatch"):
        if args.get("n") != n:
            continue
        inside = [[s for s in got[bisect_left(t, a - EPS):
                                  bisect_right(t, b + EPS)]
                   if s[1] <= b + EPS] for got, t in stages]
        i = bisect_right(form_t, a + EPS) - 1
        j = bisect_left(done_t, b - EPS)
        if any(len(s) != 1 for s in inside) or i < 0 or j == len(done):
            continue
        form, comp = forms[i], done[j]
        if (form[2] or {}).get("n") != n or (comp[2] or {}).get("n") != n:
            continue
        walls.append(sum(s[0][1] - s[0][0] for s in inside)
                     + form[1] - form[0] + comp[1] - comp[0])
    return percentile_ms(walls, 50)
