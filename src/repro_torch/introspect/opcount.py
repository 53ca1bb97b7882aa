"""Operation and byte counts of eager PyTorch work: the port's counterpart
of the reference's ``launch/hlo_analysis.analyze_hlo`` for attribution.

The reference lowers a plan step to optimized HLO and reads its cost.
PyTorch runs eagerly, so here a step is *run* once under :func:`count`, a
``TorchDispatchMode`` that sees every aten op:

* FLOPs come from ``torch.utils.flop_counter``'s registry (matrix
  products and convolutions; elementwise ops count none there, as in
  that registry);
* bytes are every op's tensor inputs plus its outputs, the eager analogue
  of HLO's bytes accessed (views and allocations move nothing and count
  nothing);
* transcendentals are the output elements of exp/log/tanh/... ops;
* collective bytes are 0: one device.

The hand-written kernels launch through ``ctypes`` (``kernels/_build.py``)
where no dispatch mode sees them, so each kernel wrapper adds its own
analytic work (:func:`add_kernel_work`, from :func:`conv_work`,
:func:`asm_work`, :func:`fused_work`, :func:`block_matmul_work`,
:func:`attention_work`, :func:`attention_bwd_work`), the same formulas
``chip_smoke.py`` bounds its kernel table with (:func:`bound`).  A counter is never active inside a timed wall.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["PEAK_FP32_FLOPS", "PEAK_BF16_FLOPS", "PEAK_BYTES", "OpCost",
           "count", "counting", "add_kernel_work", "conv_work", "asm_flops",
           "asm_work", "fused_work", "block_matmul_work", "attention_pairs",
           "attention_work", "attention_bwd_work", "bound"]

#: published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
#: tensor cores (the JPEG path runs no TF32), bf16 dense tensor cores, and
#: HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

_TRANSCENDENTAL = frozenset(
    f"aten.{n}" for n in ("exp", "exp2", "expm1", "log", "log2", "log1p",
                          "tanh", "sigmoid", "sin", "cos", "sqrt", "rsqrt",
                          "erf", "pow", "_softmax", "_log_softmax"))


@dataclass
class OpCost:
    """What one counted run did: the reference's ``HloCost`` fields."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    transcendentals: float = 0.0
    warnings: list = field(default_factory=list)


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) \
        if isinstance(t, torch.Tensor) else 0.0


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        fn = flop_registry.get(packet)
        if fn is None and func is not torch.ops.prim.device.default:
            # a composite op (under inference_mode matmul and conv2d arrive
            # whole): count what it decomposes into, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = str(packet)
        if func.is_view or name.startswith(("aten.empty", "aten.new_empty")):
            return out
        c = self.cost
        if fn is not None:
            c.flops += float(fn(*args, **kwargs, out_val=out))
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        c.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if name in _TRANSCENDENTAL:
            c.transcendentals += sum(float(t.numel()) for t in outs
                                     if isinstance(t, torch.Tensor))
        return out


# the counts active on this thread, as the dispatch mode is per thread: a
# kernel another thread launches meanwhile is not this count's work
_LOCAL = threading.local()


def _active() -> list[OpCost]:
    if not hasattr(_LOCAL, "counts"):
        _LOCAL.counts = []
    return _LOCAL.counts


def counting() -> bool:
    """Whether a :func:`count` is active on this thread (the wrappers'
    cheap test)."""
    return bool(getattr(_LOCAL, "counts", None))


def add_kernel_work(flops: float, nbytes: float) -> None:
    """Add a hand-written kernel's analytic work to this thread's active
    counts."""
    for c in _active():
        c.flops += flops
        c.bytes += nbytes


@contextlib.contextmanager
def count():
    """Count the work done inside the ``with`` block; yields an
    :class:`OpCost` filled in as the block runs."""
    cost = OpCost()
    _active().append(cost)
    try:
        with _Counter(cost):
            yield cost
    finally:
        _active().remove(cost)


# --------------------------------------------------------------------------
# The kernels' analytic work
# --------------------------------------------------------------------------


def conv_work(x_rows: int, cin: int, w_read: int, noff: int, w_in: int,
              cout: int, w_b: int, w_o: int, out_rows: int):
    """(flops, bytes) of one banded conv: the GEMM and each operand once."""
    flops = 2.0 * out_rows * noff * cin * w_in * cout * w_b
    nbytes = 4.0 * (x_rows * cin * w_read + noff * cin * w_in * cout * w_b
                    + out_rows * cout * w_o)
    return flops, nbytes


def asm_flops(pairs: int, w: int) -> float:
    """FLOPs of ASM over ``pairs`` rows of ``w`` lanes: ``t @ [R_φ | R]``
    then ``masked @ recon_t``."""
    return 2.0 * pairs * (w * 128 + 64 * w)


def asm_work(rows: int, bands: int, nf: int = 64):
    """(flops, bytes) of one ``asm_relu`` launch: ``bands`` lanes of each
    row read, ``nf`` written."""
    return asm_flops(rows, bands), 4.0 * rows * (bands + nf)


def fused_work(x_elems: int, out_elems: int, out_rows: int,
               xi_elems: list[int], cout: int, w_mid: int, w_out: int):
    """(flops, bytes) of one fused block: each conv's GEMM over the
    block's output rows, both ASMs, and the input, the output and every
    packed Ξ once."""
    flops = sum(2.0 * out_rows * e for e in xi_elems)
    flops += asm_flops(out_rows * cout, w_mid)
    flops += asm_flops(out_rows * cout, w_out)
    return flops, 4.0 * (x_elems + out_elems + sum(xi_elems))


def block_matmul_work(rows: int, nf: int = 64):
    """(flops, bytes) of one block transform: rows × a (64, 64) operator."""
    return 2.0 * rows * nf * nf, 4.0 * (2 * rows * nf + nf * nf)


def attention_pairs(s: int, t: int, causal: bool, window: int | None,
                    q_offset: int = 0) -> int:
    """Unmasked (query, key) pairs of one batch row and head: query ``i``
    at position ``i + q_offset`` sees keys ``<= position`` (causal) and
    ``> position − window``."""
    qpos = torch.arange(s, dtype=torch.int64) + q_offset
    hi = torch.clamp(qpos, max=t - 1) if causal \
        else torch.full((s,), t - 1, dtype=torch.int64)
    lo = torch.clamp(qpos - window + 1, min=0) if window \
        else torch.zeros(s, dtype=torch.int64)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def attention_work(b: int, h: int, hd: int, pairs: int, elem: int,
                   q_elems: int, kv_elems: int, lse_elems: int = 0):
    """(flops, bytes) of one attention forward: the score and P·V products,
    4·hd operations per unmasked pair (``pairs`` per batch row and head);
    q, k, v and the output once, in ``elem`` bytes each, and the fp32
    log-sum-exp when it is written."""
    return (4.0 * hd * b * h * pairs,
            elem * 2.0 * (q_elems + kv_elems) + 4.0 * lse_elems)


def attention_bwd_work(b: int, h: int, hd: int, pairs: int, elem: int,
                       q_elems: int, kv_elems: int, lse_elems: int):
    """(flops, bytes) of one attention backward: five products (S, dP, dV,
    dQ, dK), 10·hd operations per unmasked pair; q, k, v, the output,
    dO, dq, dk and dv once in ``elem`` bytes each, and the fp32
    log-sum-exp."""
    return (10.0 * hd * b * h * pairs,
            elem * 4.0 * (q_elems + kv_elems) + 4.0 * lse_elems)


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of
    operations over ``peak`` and bytes over HBM bandwidth, and which."""
    t_ops, t_mem = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem \
        else "bytes"
