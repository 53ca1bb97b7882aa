"""Kernels layer: the banded-conv kernel's share of its roofline.

Each launch's least time is the larger of its operations over the float32
peak and its bytes over HBM bandwidth (``lib/work.py``, from the launch's
shapes); their sum over the window's forwards, counted from the program's
``device-dispatch`` spans by batch size, over the device time the trace
gives ``banded_conv_kernel``.  None when the trace shows none of its
launches, or not as many as those forwards make."""
from perfbench.lib import work
from perfbench.lib.readers import spans


def read(record: dict):
    tr = record.get("trace")
    if tr is None or not tr.enabled:
        return None
    times = [(b - a) / 1e9 for name, a, b in tr.device_ops
             if "banded_conv_kernel" in name]
    per_image = record["banded_launches"]
    forwards = [args["bucket"] for _, _, args in
                spans(record, "device", "device-dispatch", "traced")]
    if not times or len(times) != len(forwards) * len(per_image):
        return None
    bound = 0.0
    for n in forwards:
        for rows, out_rows, noff, cin, w_in, cout, w_out in per_image:
            bound += work.bound_s(*work.banded_conv_work(
                n * rows, n * out_rows, noff, cin, w_in, cout, w_out))
    return 100.0 * bound / sum(times)
