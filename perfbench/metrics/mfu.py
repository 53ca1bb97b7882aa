"""Model step (``mfu.<cells>``): the spatial network's operations for the
images done in the window (answered; or trained, forward and backward at 3
x the forward), per second, as a percentage of the card's float32 peak
(``lib/work.py``)."""
from perfbench.lib.work import PEAKS


def read(record: dict):
    rate = record["images_done"] / record["window_s"]
    return 100.0 * rate * record["flops_per_image"] / PEAKS["fp32_flops"]
