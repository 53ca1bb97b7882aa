"""Scheduler layer: the percentage of the window's full batches (the
cell's ``batch`` images) launched while an earlier batch had not yet been
read back, from the ``behind`` arg of each ``device/device-dispatch``
span.  None where the program's dispatch spans carry no ``behind``."""
from perfbench.lib.readers import spans


def read(record: dict):
    full = [args for _, _, args in spans(record, "device", "device-dispatch")
            if args and args.get("n") == record["batch"] and "behind" in args]
    if not full:
        return None
    return 100.0 * sum(1 for a in full if a["behind"]) / len(full)
