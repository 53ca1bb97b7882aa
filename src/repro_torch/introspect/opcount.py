"""Operation, byte and collective counts of eager PyTorch work: the port's
counterpart of the reference's ``launch/hlo_analysis.py``.

The reference lowers a step to optimized HLO and reads its cost from the
text.  PyTorch runs eagerly, so here a step is *run* once under
:func:`count`, a ``TorchDispatchMode`` that sees every aten op (the
dry-run runs it on fake tensors, ``launch/dryrun.py``):

* FLOPs come from ``torch.utils.flop_counter``'s registry (matrix
  products and convolutions; elementwise ops count none there, as in
  that registry);
* bytes are every op's tensor inputs plus its outputs, the eager analogue
  of HLO's bytes accessed (views and allocations move nothing and count
  nothing; a broadcast operand counts the elements it holds, so an op
  reads the same bytes whichever way a composite decomposes);
* transcendentals are the output elements of exp/log/tanh/... ops;
* collectives: ``parallel/collectives.py`` reports each call it makes
  (:func:`add_collective`) with its kind, the size of its group and its
  payload by the reference's rule (``hlo_analysis.py:256-270``): an
  all-gather its gathered output, an all-reduce twice its input (the
  ring's reduce-scatter and all-gather phases), a reduce-scatter, a
  broadcast and a point-to-point send their input.

The hand-written kernels launch through ``ctypes`` (``kernels/_build.py``)
where no dispatch mode sees them, so each kernel wrapper adds its own
analytic work (:func:`add_kernel_work`, from :func:`conv_work`,
:func:`asm_work`, :func:`fused_work`, :func:`block_matmul_work`,
:func:`attention_work`, :func:`attention_bwd_work`), the same formulas
``chip_smoke.py`` bounds its kernel table with (:func:`bound`); on fake
tensors a wrapper adds the same work and launches nothing.  A counter is
never active inside a timed wall.

The active counts are the :func:`count` modes on the dispatch-mode stack,
which the autograd engine carries to its device threads (on CUDA the
backward runs there): so a backward's kernel work and collectives are
counted, while a kernel another Python thread launches meanwhile is not
this count's work.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.introspect.memory import tensors

__all__ = ["PEAK_FP32_FLOPS", "PEAK_BF16_FLOPS", "PEAK_BYTES", "OpCost",
           "Collective", "count", "counting", "add_kernel_work", "add_work",
           "add_collective", "conv_work", "asm_flops",
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
class Collective:
    """One kind of collective over one group size: its calls and their
    payload bytes (the reference's ``hlo_analysis.Collective``)."""

    kind: str
    bytes: float
    group_size: int
    count: float


@dataclass
class OpCost:
    """What one counted run did: the reference's ``HloCost`` fields."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collectives: list = field(default_factory=list)
    warnings: list = field(default_factory=list)

    @property
    def collective_bytes(self) -> float:
        return sum(c.bytes for c in self.collectives)

    def collective_bytes_by_group_size(self) -> dict[int, float]:
        out: dict[int, float] = {}
        for c in self.collectives:
            out[c.group_size] = out.get(c.group_size, 0.0) + c.bytes
        return out

    def to_json(self) -> dict:
        """``HloCost.to_json``'s schema.  An eager run counts every
        repetition of a loop as it runs, so ``flops_single`` and
        ``bytes_single`` (the reference's counts with each ``while`` body
        once) equal ``flops`` and ``bytes``; ``collective_ops`` holds one
        entry per (kind, group size), its ``count`` the calls."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "flops_single": self.flops,
            "bytes_single": self.bytes,
            "transcendentals": self.transcendentals,
            "collective_bytes": self.collective_bytes,
            "collectives_by_group": {
                str(k): v for k, v in
                self.collective_bytes_by_group_size().items()},
            "collective_ops": [
                {"kind": c.kind, "bytes": c.bytes,
                 "group_size": c.group_size, "count": c.count}
                for c in self.collectives],
            "warnings": list(self.warnings),
        }


def _nbytes(t) -> float:
    """Bytes of the elements a tensor addresses: a broadcast (stride 0)
    dim reads its elements once."""
    if not isinstance(t, torch.Tensor):
        return 0.0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return float(n * t.element_size()) if t.numel() else 0.0


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":  # metadata (a fake tensor's device)
            return func(*args, **kwargs)
        packet = func._overloadpacket
        fn = flop_registry.get(packet)
        if fn is None:
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
        ins, outs = tensors((args, kwargs)), tensors(out)
        c.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if name in _TRANSCENDENTAL:
            c.transcendentals += sum(float(t.numel()) for t in outs)
        return out


def _active() -> list[OpCost]:
    """The counts of the :func:`count` modes on this thread's dispatch-mode
    stack (the autograd engine's device threads carry the stack of the
    thread that called backward)."""
    return [m.cost for m in _get_current_dispatch_mode_stack()
            if isinstance(m, _Counter)]


def counting() -> bool:
    """Whether a :func:`count` is active here (the wrappers' cheap
    test)."""
    return bool(_active())


def add_kernel_work(flops: float, nbytes: float) -> None:
    """Add a hand-written kernel's analytic work to the active counts."""
    for c in _active():
        c.flops += flops
        c.bytes += nbytes


def add_work(cost: OpCost, times: float = 1.0) -> None:
    """Add ``times`` × a counted run's FLOPs, bytes and transcendentals to
    the active counts: work that repeats that run's ops on the same
    shapes (``models/mamba.py``'s scan on fake tensors)."""
    for c in _active():
        c.flops += times * cost.flops
        c.bytes += times * cost.bytes
        c.transcendentals += times * cost.transcendentals


def add_collective(kind: str, nbytes: float, group_size: int) -> None:
    """Add one collective call to the active counts: ``kind`` (the
    reference's op names: ``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-broadcast``,
    ``collective-permute``),
    its payload bytes by the reference's rule and its group's size."""
    for c in _active():
        for entry in c.collectives:
            if entry.kind == kind and entry.group_size == group_size:
                entry.bytes += nbytes
                entry.count += 1
                break
        else:
            c.collectives.append(Collective(kind, float(nbytes),
                                            int(group_size), 1.0))


@contextlib.contextmanager
def count():
    """Count the work done inside the ``with`` block; yields an
    :class:`OpCost` filled in as the block runs."""
    cost = OpCost()
    with _Counter(cost):
        yield cost


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
    ``> position − window``.  Counted in numpy, so no dispatch mode sees
    the count (and a fake-tensor mode leaves it a number)."""
    qpos = np.arange(s, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, t - 1) if causal \
        else np.full((s,), t - 1, dtype=np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window \
        else np.zeros(s, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


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
