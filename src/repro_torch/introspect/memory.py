"""Per-rank memory of one step: what the reference's
``compiled.memory_analysis()`` reports, from a run of the step.

:func:`track` is a ``TorchDispatchMode`` that keeps the bytes of every
storage an op allocates while it is active (an op's output whose storage
is none of its inputs'), drops them when the storage is freed (a weak
reference to it), and records the peak of their sum.  It sees what the
dispatcher sees, the kernel wrappers' outputs among them, and, since the
autograd engine carries the dispatch-mode stack to its device threads, a
backward's allocations on CUDA too.  On fake tensors (``launch/dryrun.py``)
nothing is allocated and the bytes are the tensors' sizes.

:func:`memory_record` turns one tracked step into the reference's five
numbers:

* ``argument_bytes``: the step's inputs (this rank's parameter slices,
  optimizer state, batch rows and cache slices);
* ``output_bytes``: its outputs;
* ``alias_bytes``: the outputs that are inputs written in place (the
  decode cache: the reference's donated buffers);
* ``temp_bytes``: the peak of the bytes allocated during the step, less
  the outputs it allocated, so that arguments + outputs − aliases +
  temporaries is the step's peak, as XLA's buffers add up;
* ``generated_code_bytes``: 0.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Tracker", "track", "tensors", "tree_bytes", "memory_record"]


def tensors(tree: Any, out: list | None = None) -> list[torch.Tensor]:
    """The tensors of a nest of tuples, lists and dicts (an op's
    arguments or results; faster than a pytree flatten, which the
    tracker would pay on every op)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors(x, out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Tracker(TorchDispatchMode):
    """Live and peak bytes of the storages allocated while active."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self._lock = threading.Lock()
        self._refs: dict[int, weakref.ref] = {}

    def _free(self, key: int) -> None:
        with self._lock:
            self.current -= self.live.pop(key, 0)
            self._refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {_key(t) for t in tensors((args, kwargs))}
        for t in tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs:
                continue
            with self._lock:
                if key in self.live:
                    continue
                n = st.nbytes()
                self.live[key] = n
                self.current += n
                self.peak = max(self.peak, self.current)
                self._refs[key] = weakref.ref(
                    st, lambda _, k=key: self._free(k))
        return out


@contextlib.contextmanager
def track():
    """Track the allocations made inside the ``with`` block; yields the
    :class:`Tracker` (``peak``: the largest sum of live bytes)."""
    tracker = Tracker()
    with tracker:
        yield tracker


def tree_bytes(tree: Any) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    seen: dict[int, int] = {}
    for t in tensors(tree):
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def memory_record(args: Any, outputs: Any, tracker: Tracker) -> dict:
    """The reference's ``memory`` entry of a dry-run record for a step
    called on ``args`` that returned ``outputs`` under ``tracker``
    (module docstring)."""
    arg_keys = {_key(t) for t in tensors(args)}
    out = {}
    for t in tensors(outputs):
        out[_key(t)] = t.untyped_storage().nbytes()
    alias = sum(n for k, n in out.items() if k in arg_keys)
    output = sum(out.values())
    return {
        "argument_bytes": tree_bytes(args),
        "output_bytes": output,
        "temp_bytes": max(tracker.peak - (output - alias), 0),
        "alias_bytes": alias,
        "generated_code_bytes": 0,
    }
