"""Plan walk and grid layer: the median ``device/device-dispatch`` span of
the window's full batches (the cell's ``batch`` images), the wall of one
forward from the staged batch to its logits on the host."""
from perfbench.lib.readers import percentile_ms, spans


def read(record: dict):
    return percentile_ms([b - a for a, b, args in
                          spans(record, "device", "device-dispatch")
                          if args.get("n") == record["batch"]], 50)
