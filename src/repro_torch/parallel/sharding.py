"""Logical-axis sharding rules (DP / TP / EP / SP + pod axis), rank-local.

A port of ``repro/parallel/sharding.py``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are the
reference's axes (``pod``, ``data``, ``model``); the launcher installs an
:class:`AxisRules` holding it with ``with sharding_rules(...)``, and
outside such a block every model path runs unsharded, as before.

A spec is a :class:`PartitionSpec`: per dim of a leaf, ``None``, one mesh
axis name, or a tuple of them.  Parameter specs are inferred from tree
paths and shapes (:func:`param_pspec`) with the reference's one rule table
for every arch:

* vocab-sized dims -> ``model`` (TP vocab/embedding sharding);
* d_ff / q_dim / d_inner dims -> ``model`` (Megatron TP);
* the matching contraction dim of output projections -> ``model``;
* MoE experts: d_ff over ``model`` and d_model over ``data`` (ZeRO-3);
* small or uneven dims replicate;
* optimizer state (:func:`zero1_pspec`) additionally shards the largest
  remaining divisible dim over ``data`` (ZeRO-1).

Execution is rank-local SPMD: every rank holds the slices of the full
leaves that its mesh coordinate picks (:func:`local_slice`), runs the same
step on them, and the collectives are explicit.  So the reference's
``shard(x, *logical)`` has nothing to do here: an activation is already
the rank's own piece (its batch rows; the model axis's layers say what
they hold), and the module does not port it.  :func:`gather_full` is the
inverse of :func:`local_slice`, the one thing the reference gets from
``NamedSharding``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import torch

from repro_torch.configs import ModelConfig

__all__ = [
    "PartitionSpec", "P", "AxisRules", "sharding_rules", "current_rules",
    "active_rules", "logical_pspec", "param_pspec", "zero1_pspec",
    "batch_pspec", "cache_pspec", "cache_leaf_pspec", "UnevenSlotsError",
    "spec_axes", "mesh_sizes", "chunk_of", "local_slice", "gather_full",
    "path_str",
    "gather_tree", "bind_rules",
]


class PartitionSpec:
    """Per dim of a leaf: ``None``, a mesh axis name, or a tuple of
    names (major first).  Iterates, indexes and compares like the tuple of
    its entries, as the reference's ``jax.sharding.PartitionSpec`` does;
    not a tuple itself, so the tree utilities take it as one leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        # as in the reference's spec: no axes is None, one axis its name
        self._entries = tuple(
            None if e == () else e[0] if isinstance(e, tuple)
            and len(e) == 1 else e for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PartitionSpec(*self._entries[i])
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other._entries
        return isinstance(other, tuple) and self._entries == other

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}"


P = PartitionSpec


@dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> tuple of mesh axis names.

    ``mesh`` is the ``DeviceMesh`` the rank-local code communicates over.
    ``specs`` (port only) maps each parameter leaf's path to its spec
    while a mesh step runs (``launch/steps.py`` sets it), so the model's
    layers know how each local leaf is cut."""

    rules: dict[str, tuple[str, ...]] = field(default_factory=dict)
    mesh_shape: dict[str, int] = field(default_factory=dict)
    mesh: object = None
    specs: Optional[Mapping[str, PartitionSpec]] = None

    def with_mesh(self, mesh) -> "AxisRules":
        return dataclasses.replace(self, mesh=mesh)

    @staticmethod
    def default(multi_pod: bool, *, pods: int = 2, data: int = 16,
                model: int = 16) -> "AxisRules":
        batch_axes = ("pod", "data") if multi_pod else ("data",)
        shape = {"data": data, "model": model}
        if multi_pod:
            shape["pod"] = pods
        return AxisRules(
            rules={
                "batch": batch_axes,
                "model": ("model",),
                "data": ("data",),
                "replicated": (),
            },
            mesh_shape=shape,
        )

    def axes(self, logical: str) -> tuple[str, ...]:
        return self.rules.get(logical, ())

    def size(self, logical: str) -> int:
        n = 1
        for ax in self.axes(logical):
            n *= self.mesh_shape.get(ax, 1)
        return n


_local = threading.local()


@contextlib.contextmanager
def sharding_rules(rules: Optional[AxisRules]):
    prev = getattr(_local, "rules", None)
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def current_rules() -> Optional[AxisRules]:
    return getattr(_local, "rules", None)


def bind_rules(fn):
    """``fn`` run under the rules installed now, wherever it is called
    later: for a function ``torch.utils.checkpoint`` recomputes in the
    backward, which on CUDA runs on the autograd engine's own thread,
    where this thread's rules are not installed.  ``fn`` itself without
    rules."""
    rules = current_rules()
    if rules is None:
        return fn

    def run(*args, **kwargs):
        with sharding_rules(rules):
            return fn(*args, **kwargs)

    return run


def active_rules() -> Optional[AxisRules]:
    """The installed rules when they hold a mesh, else None: the switch
    between the rank-local mesh paths and the unsharded ones."""
    rules = current_rules()
    return rules if rules is not None and rules.mesh is not None else None


def logical_pspec(*logical: Optional[str]) -> PartitionSpec:
    """Resolve logical axis names to a spec under the current rules."""
    rules = current_rules()
    if rules is None:
        return P()
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        else:
            axes = rules.axes(name)
            out.append(axes if len(axes) != 1 else axes[0])
    return P(*out)


# --------------------------------------------------------------------------
# Parameter sharding inference
# --------------------------------------------------------------------------

# Leaf-name hints: substrings of the flattened tree path.
_SHARD_LAST = ("w_in", "w_gate", "wi", "in_proj", "q_proj", "k_proj",
               "v_proj", "dt_proj", "receptance", "key", "value",
               "gate", "head")
_SHARD_FIRST = ("w_out", "wo", "out_proj", "o_proj", "x_proj", "a_log",
                "output")


def param_pspec(path: str, shape: tuple[int, ...],
                cfg: ModelConfig) -> PartitionSpec:
    """Infer the TP spec of one parameter from its path and full shape.

    Exactly one dim is sharded over ``model``:

    * embedding tables: the vocab-sized dim;
    * name-hinted input-side projections (q/k/v, w_in, ...): the last dim;
    * name-hinted output-side projections (o_proj, w_out, ...): dim -2
      (the contraction dim, matching the activations they consume);
    * otherwise: the right-most dim whose size is "wide" (d_ff / vocab /
      q_dim / kv_dim / d_inner) and isn't d_model;
    * 1-D params (norms, biases) and small dims replicate.
    """
    rules = current_rules()
    model_axes = rules.axes("model") if rules else ("model",)
    model_size = rules.size("model") if rules else 1
    spec = [None] * len(shape)
    if len(shape) <= 1:
        return P(*spec)
    lowered = path.lower()

    def mark(dim: int) -> PartitionSpec:
        # an even split or none: small or uneven dims replicate, and an
        # empty model mapping (pure-DP rules) replicates everything
        if (not model_axes or shape[dim] < 2 * model_size
                or shape[dim] % model_size):
            return P(*([None] * len(shape)))
        spec[dim] = model_axes if len(model_axes) != 1 else model_axes[0]
        return P(*spec)

    wide_dims = {cfg.d_ff, cfg.vocab_size, cfg.q_dim, cfg.kv_dim,
                 cfg.d_model * cfg.expand, 2 * cfg.d_model * cfg.expand}
    wide_dims.discard(0)
    if "/moe/" in lowered and len(shape) >= 3:
        # ZeRO-3 expert storage: d_ff over `model` (TP) and d_model over
        # `data` (FSDP); the layer gathers its experts over `data` just
        # in time and the backward reduce-scatters the weight gradients
        data_axes = rules.axes("data") if rules else ("data",)
        data_size = rules.size("data") if rules else 1
        dspec = data_axes if len(data_axes) != 1 else data_axes[0]
        p = [None] * len(shape)
        f_dim = len(shape) - 1 if shape[-1] == cfg.d_ff else len(shape) - 2
        d_dim = len(shape) - 1 if shape[-1] == cfg.d_model else len(shape) - 2
        if shape[f_dim] == cfg.d_ff and shape[f_dim] % model_size == 0:
            p[f_dim] = model_axes if len(model_axes) != 1 else model_axes[0]
        if (d_dim != f_dim and shape[d_dim] == cfg.d_model
                and shape[d_dim] % max(data_size, 1) == 0 and data_size > 1):
            p[d_dim] = dspec
        return P(*p)
    if "embed" in lowered:
        pv = -(-cfg.vocab_size // 256) * 256  # padded vocab (transformer.py)
        for i, d in enumerate(shape):
            if d in (cfg.vocab_size, pv):
                return mark(i)
        return P(*spec)
    if any(h in lowered for h in _SHARD_FIRST):
        return mark(len(shape) - 2)
    if any(h in lowered for h in _SHARD_LAST):
        return mark(len(shape) - 1)
    for i in range(len(shape) - 1, -1, -1):
        if shape[i] in wide_dims and shape[i] != cfg.d_model:
            return mark(i)
    return P(*spec)


def zero1_pspec(pspec: PartitionSpec, shape: tuple[int, ...],
                rules: AxisRules) -> PartitionSpec:
    """ZeRO-1: additionally shard the largest un-sharded dim over
    ``data``.  Applied to optimizer state (fp32 master and moments) and
    the gradient accumulator; the TP spec when no dim divides."""
    data_axes = rules.axes("data")
    if not data_axes:
        return pspec
    data_size = rules.size("data")
    if data_size <= 1:
        return pspec
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    used = set()
    for e in entries:
        for ax in (e if isinstance(e, tuple) else (e,)):
            used.add(ax)
    if any(ax in used for ax in data_axes):
        return pspec  # already data-sharded (ZeRO-3 expert storage)
    best, best_dim = None, 0
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % data_size == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        return pspec
    entries[best] = data_axes if len(data_axes) != 1 else data_axes[0]
    return P(*entries)


def batch_pspec(rules: AxisRules, global_batch: int) -> tuple[str, ...]:
    """Mesh axes used for the batch dim: as many of (pod, data) as
    divide."""
    n = 1
    used = []
    for ax in rules.axes("batch"):
        sz = rules.mesh_shape.get(ax, 1)
        if global_batch % (n * sz) == 0:
            used.append(ax)
            n *= sz
    return tuple(used) if used else ()


def cache_pspec(rules: AxisRules, global_batch: int) -> tuple:
    """(batch_axes, seq_axes) for KV caches: SP over the leftover axes.

    Decode with a large batch: batch over (pod, data), cache sequence over
    model.  A tiny batch (long context): sequence over every unused
    axis."""
    batch_axes = batch_pspec(rules, global_batch)
    all_axes = (["pod", "data", "model"] if "pod" in rules.mesh_shape
                else ["data", "model"])
    seq_axes = tuple(ax for ax in all_axes if ax not in batch_axes)
    return batch_axes, seq_axes


class UnevenSlotsError(ValueError):
    """A cache's slots do not split evenly over its sequence axes.  XLA
    pads such a sequence; the port refuses it (ROADMAP Queue 3)."""


def cache_leaf_pspec(path: str, shape: tuple[int, ...], rules: AxisRules,
                     bspec, sspec) -> PartitionSpec:
    """One decode-cache leaf's spec (the reference's ``cache_shardings``
    rule, ``launch/steps.py:77-107``), its batch dim over ``bspec`` and an
    attention cache's slots over ``sspec``: keys and values ``(n_periods,
    B, T, KVH, hd)`` by slot; a ``cross`` cache by batch only; RWKV's
    ``wkv`` ``(n_periods, B, H, hs, hs)`` by head over ``model`` when the
    axis divides the heads; Mamba's ``ssm`` ``(n_periods, B, di, ds)`` and
    ``conv`` ``(n_periods, B, dc-1, di)`` along ``di`` over ``model``;
    the token shifts by batch; scalars (the index) replicated."""
    if not shape:
        return P()
    p = path.lower()
    if "cross" in p and len(shape) == 5:
        return P(None, bspec, None, None, None)
    if p.endswith("/k") or p.endswith("/v"):
        return P(None, bspec, sspec, None, None)
    if "wkv" in p:
        ok = len(shape) == 5 and shape[2] % max(rules.size("model"), 1) == 0
        return P(None, bspec, "model" if ok else None, None, None)
    if "ssm" in p:
        return P(None, bspec, "model", None)
    if "conv" in p:
        return P(None, bspec, None, "model")
    if "shift" in p:
        return P(None, bspec, None, None)
    return P()


# --------------------------------------------------------------------------
# Rank-local slices
# --------------------------------------------------------------------------


def spec_axes(entry: Any) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def chunk_of(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's chunk index, chunk count) over ``axes``, the first
    axis major."""
    sizes = mesh_sizes(mesh)
    idx, n = 0, 1
    for ax in axes:
        idx = idx * sizes[ax] + mesh.get_local_rank(ax)
        n *= sizes[ax]
    return idx, n


def local_slice(full: torch.Tensor, spec: PartitionSpec,
                mesh) -> torch.Tensor:
    """This rank's piece of the full leaf ``full`` under ``spec``: a
    contiguous copy in storage of its own when ``spec`` cuts it (a view
    would keep the full leaf's storage alive), else ``full`` made
    contiguous."""
    out = full
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        idx, n = chunk_of(mesh, axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {out.shape[dim]} does not "
                             f"split over {axes} ({n} ranks)")
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    if out is full:
        return out.contiguous()
    return out.clone(memory_format=torch.contiguous_format)


def gather_full(local: torch.Tensor, spec: PartitionSpec,
                mesh) -> torch.Tensor:
    """The full leaf from every rank's :func:`local_slice` (every rank of
    the sharded axes calls it; the result is on every rank)."""
    from repro_torch.parallel.collectives import all_gather

    out = local
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            out = all_gather(out, mesh, axes, dim)
    return out


def path_str(path: str) -> str:
    """A path of ``repro_torch.tree`` (``['blocks']/['pos0']/...``, ``[0]``,
    ``.step``) in the reference's ``launch.steps.path_str`` form
    (``blocks/pos0/...``, ``0``, ``.step``)."""
    parts = []
    for part in path.split("/"):
        if part.startswith("['") and part.endswith("']"):
            part = part[2:-2]
        elif part.startswith("[") and part.endswith("]"):
            part = part[1:-1]
        parts.append(part)
    return "/".join(parts)


def gather_tree(tree: Any, prefix: str = "", *,
                stacked: bool = False) -> Any:
    """``tree`` (a subtree of the parameters at ``prefix``) with every leaf
    the active rules' ``specs`` cut gathered whole for its use
    (``collectives.GatherParam``).  ``stacked``: the leaves are one
    repetition's slices of stacked ``(n_periods, ...)`` leaves, so their
    specs drop the leading entry.  The gradient of a gathered leaf is
    reduce-scattered over the batch axes (their ranks saw different rows)
    and sliced over any other (their ranks computed the same thing)."""
    from repro_torch.parallel.collectives import GatherParam
    from repro_torch.tree import leaves_with_paths, tree_map

    rules = active_rules()
    if rules is None or not rules.specs:
        return tree
    summed = frozenset(rules.axes("batch"))
    out = []
    for sub, leaf in leaves_with_paths(tree):
        rel = path_str(sub)
        spec = rules.specs.get("/".join(x for x in (prefix, rel) if x))
        if spec is not None and stacked:
            if spec and spec[0] is not None:
                raise ValueError(f"{prefix}/{rel}: a stacked leaf cut over "
                                 f"its layers ({spec})")
            spec = spec[1:]
        cuts = [(d, spec_axes(e)) for d, e in enumerate(spec or ())
                if spec_axes(e)]
        if cuts:
            leaf = GatherParam.apply(leaf, rules.mesh, cuts, summed)
        out.append(leaf)
    it = iter(out)
    return tree_map(lambda _: next(it), tree)
