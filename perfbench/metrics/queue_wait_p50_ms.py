"""Scheduler layer: the median of the program's ``request/queue`` spans
(admitted until taken into a batch) in the window."""
from perfbench.lib.readers import percentile_ms, spans


def read(record: dict):
    return percentile_ms([b - a for a, b, _ in
                          spans(record, "request", "queue")], 50)
