"""The yardstick's arithmetic: the card's peaks, the spatial network's
operations, and one banded-conv launch's operations and bytes.

Frozen here, so that a change to the program cannot move what its speed is
measured against.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at 700 W: float32 outside the tensor
#: cores (the JPEG path's configurations are float32 with TF32 off), bf16,
#: and HBM3 bandwidth
PEAKS = {"fp32_flops": 67e12, "bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def _conv_flops(cin: int, cout: int, r: int, out_pixels: int) -> float:
    return 2.0 * cin * cout * r * r * out_pixels


def spatial_flops(cfg: dict) -> float:
    """Forward operations of one image through the spatial network of
    ``cfg`` (a configuration file): 2 x the multiply-adds of every conv
    and of the classifier.  The same whatever implements the network, so
    a share of the peak built on it cannot exceed 100 %."""
    size, widths = cfg["image_size"], cfg["widths"]
    hw = size * size
    total = _conv_flops(cfg["in_channels"], widths[0], 3, hw)   # the stem
    cin = widths[0]
    for si, w in enumerate(widths):
        for bi in range(cfg["blocks_per_stage"]):
            s = 2 if si and not bi else 1
            if s == 2:
                hw //= 4
            total += _conv_flops(cin, w, 3, hw) + _conv_flops(w, w, 3, hw)
            if s != 1 or cin != w:
                total += _conv_flops(cin, w, 1, hw)            # projection
            cin = w
    return total + 2.0 * cin * cfg["num_classes"]


def banded_conv_work(rows: int, out_rows: int, noff: int, cin: int,
                     w_in: int, cout: int, w_out: int) -> tuple[float, float]:
    """(operations, bytes) one banded-conv launch needs: the GEMM of
    ``out_rows`` output blocks over ``noff`` neighbour offsets, each of
    ``cin`` channels at ``w_in`` lanes into ``cout`` channels at ``w_out``
    lanes; the input, the operator and the output once, in float32.  An
    ASM epilogue's operations and a residual read are not counted."""
    flops = 2.0 * out_rows * noff * cin * w_in * cout * w_out
    nbytes = 4.0 * (rows * cin * w_in + noff * cin * w_in * cout * w_out
                    + out_rows * cout * w_out)
    return flops, nbytes


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAKS["fp32_flops"]) -> float:
    """The least seconds the card could take: the larger of operations
    over the peak and bytes over HBM bandwidth."""
    return max(flops / peak_flops, nbytes / PEAKS["hbm_bytes"])
