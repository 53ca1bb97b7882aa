"""Collectives over a ``DeviceMesh``'s axes, their autograd forms, and the
reference's compressed, hierarchical and ring reductions.

A port of ``repro/parallel/collectives.py``.  Every function names the mesh
axes it reduces or gathers over; a tuple of axes runs one single-axis
collective after another (the first axis major), each over the process
group ``mesh.get_group(axis)`` of this rank.

Transport.  Every collective runs on the tensors where they are: NCCL
across cards, gloo on the CPU (the tests) and gloo when several ranks
share one card (NCCL refuses two ranks on one device), whose all-reduce,
all-gather, reduce-scatter and broadcast take CUDA tensors (torch 2.11 on
an H100).  Gloo's point-to-point sends do not: its TCP transport writes
from the tensor's pointer and fails on a device address.  So for backend
``gloo`` the ring and the pipeline's sends stage a CUDA tensor through the
host (copied to the CPU, sent, the received one copied back), and
:data:`STAGED` counts those calls.  NCCL never stages, nor does a CPU
tensor.

The autograd forms are the model axis's building blocks
(``models/layers.py``, ``models/moe.py``): :class:`CopyTo` (identity
forward, all-reduce backward) and :class:`ReduceFrom` (all-reduce forward,
identity backward) bracket a Megatron region; :class:`AllReduce` sums
forward and backward (statistics over the batch axes); :class:`GatherParam`
gathers a sharded leaf just before its use and either reduce-scatters its
gradient (over axes whose ranks hold different data) or keeps its own
slice (over axes whose ranks computed the same thing).

Every call over more than one rank reports itself to the active
``introspect.opcount`` counts: its kind, its group's size and its payload
by the reference's rule.  Nothing here reads a collective's result on
the host, so the dry-run's ``fake`` process group, whose collectives
return their buffers as they were, traces the same calls.
"""
from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.introspect import opcount

__all__ = ["STAGED", "group", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "shift", "CopyTo", "ReduceFrom", "AllReduce",
           "GatherParam", "batch_mean", "psum_compressed",
           "hierarchical_psum", "ring_all_gather"]

#: point-to-point calls staged through the host (gloo with CUDA tensors)
STAGED: collections.Counter = collections.Counter()

_RS = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _axes(axes: str | Sequence[str]) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.parallel.sharding import active_rules

    rules = active_rules()
    if rules is None:
        raise RuntimeError("no mesh: pass mesh= or install sharding_rules "
                           "with a mesh")
    return rules.mesh


def group(mesh, axis: str):
    """This rank's process group along ``axis``."""
    return mesh.get_group(axis)




def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _report(kind: str, payload: torch.Tensor, n: int,
            factor: float = 1.0) -> None:
    if opcount.counting():
        opcount.add_collective(kind, factor * payload.numel()
                               * payload.element_size(), n)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """Σ (or, ``op="max"``, the largest) of ``x`` over the ranks of
    ``axes`` (a new tensor)."""
    out = x.clone()
    for ax in _axes(axes):
        n = _size(mesh, ax)
        if n > 1:
            _report("all-reduce", out, n, 2.0)
            dist.all_reduce(out, op=_OPS[op], group=group(mesh, ax))
    return out


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in chunk order over
    ``axes`` (the first axis major)."""
    out = x
    for ax in reversed(_axes(axes)):
        n = _size(mesh, ax)
        if n == 1:
            continue
        src = out.movedim(dim, 0).contiguous()
        buf = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        _report("all-gather", buf, n)
        _AG(buf, src, group=group(mesh, ax))
        out = buf.movedim(0, dim)
    return out.contiguous()


def reduce_scatter(x: torch.Tensor, mesh, axes,
                   dim: int = 0) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``axes``, each rank keeping its chunk
    of ``dim`` (the inverse layout of :func:`all_gather`)."""
    out = x
    for ax in _axes(axes):
        n = _size(mesh, ax)
        if n == 1:
            continue
        src = out.movedim(dim, 0).contiguous()
        if src.shape[0] % n:
            raise ValueError(f"dim {dim} of size {src.shape[0]} does not "
                             f"split over {ax} ({n} ranks)")
        buf = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        _report("reduce-scatter", src, n)
        _RS(buf, src, group=group(mesh, ax))
        out = buf.movedim(0, dim)
    return out.contiguous()


def _own_chunk(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * size, size)


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src`` of ``axis``, on every rank
    of it (in place)."""
    n = _size(mesh, axis)
    if n == 1:
        return x
    _report("collective-broadcast", x, n)
    g = group(mesh, axis)
    dist.broadcast(x, src=dist.get_process_group_ranks(g)[src], group=g)
    return x


def shift(x: torch.Tensor, mesh, axis: str, name: str) -> torch.Tensor:
    """Every rank of ``axis`` sends ``x`` to the next (a ring) and returns
    what the previous one sent: point to point, ``batch_isend_irecv``.
    For gloo a CUDA tensor goes through the host, counted under ``name``
    in :data:`STAGED`."""
    n = _size(mesh, axis)
    me = mesh.get_local_rank(axis)
    g = group(mesh, axis)
    ranks = dist.get_process_group_ranks(g)
    staged = x.is_cuda and dist.get_backend(g) == "gloo"
    if staged:
        STAGED[name] += 1
    src = x.detach().cpu() if staged else x.detach().contiguous()
    _report("collective-permute", src, n)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(me + 1) % n], group=g),
           dist.P2POp(dist.irecv, out, ranks[(me - 1) % n], group=g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


class CopyTo(torch.autograd.Function):
    """Identity forward; backward sums the gradient over ``axes``: the
    entry of a region whose ranks each compute a part (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class ReduceFrom(torch.autograd.Function):
    """Sums the ranks' partial results over ``axes``; identity backward:
    the exit of such a region (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllReduce(torch.autograd.Function):
    """Σ over ``axes`` forward and backward: a statistic every rank
    computes from its own rows and every rank's loss reads."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class GatherParam(torch.autograd.Function):
    """A sharded leaf gathered whole just before its use.  ``cuts`` lists
    ``(dim, axes)`` as the leaf's spec cuts it.  In the backward an axis
    in ``summed`` reduce-scatters the gradient (its ranks saw different
    rows, so their gradients add up); any other axis keeps the rank's own
    slice (its ranks computed the same thing, so each holds the whole
    gradient, and a sum would count it once a rank)."""

    @staticmethod
    def forward(ctx, x, mesh, cuts, summed):
        ctx.mesh, ctx.cuts, ctx.summed = mesh, cuts, summed
        out = x
        for dim, axes in cuts:
            out = all_gather(out, mesh, axes, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        for dim, axes in reversed(ctx.cuts):
            for ax in axes:
                if ax in ctx.summed:
                    g = reduce_scatter(g, ctx.mesh, (ax,), dim)
                else:
                    g = _own_chunk(g, ctx.mesh, ax, dim)
        return g.contiguous(), None, None, None


def batch_mean(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """The mean of ``x`` over ``dims`` (the batch dim among them) across
    every rank's rows: local sums added over the active rules' batch axes
    (:class:`AllReduce`, so every rank's rows get their gradient), divided
    by the global count.  Ranks split the batch evenly."""
    from repro_torch.parallel.sharding import active_rules

    rules = active_rules()
    axes = rules.axes("batch")
    count = 1
    for d in dims:
        count *= x.shape[d]
    for ax in axes:
        count *= _size(rules.mesh, ax)
    return AllReduce.apply(x.sum(dim=dims), rules.mesh, axes) / count


# --------------------------------------------------------------------------
# The reference's helpers
# --------------------------------------------------------------------------


def psum_compressed(x: torch.Tensor, axis, dtype=torch.bfloat16, *,
                    mesh=None) -> torch.Tensor:
    """All-reduce in a narrower dtype (halves the collective's bytes)."""
    return all_reduce(x.to(dtype), _mesh(mesh), axis).to(x.dtype)


def hierarchical_psum(x: torch.Tensor, inner_axis: str, outer_axis: str, *,
                      mesh=None) -> torch.Tensor:
    """Reduce over the fast links first, then the slow (pod) axis: the
    outer payload is one already-reduced tensor per pod."""
    mesh = _mesh(mesh)
    return all_reduce(all_reduce(x, mesh, inner_axis), mesh, outer_axis)


def ring_all_gather(x: torch.Tensor, axis: str, *,
                    mesh=None) -> torch.Tensor:
    """Explicit ring all-gather → ``(n, *x.shape)`` in rank order: n - 1
    steps, each sending the piece last received to the next rank and
    receiving from the previous one (point-to-point, ``batch_isend_irecv``;
    the building block of overlapped pipelines)."""
    mesh = _mesh(mesh)
    n = _size(mesh, axis)
    me = mesh.get_local_rank(axis)
    pieces = [None] * n
    pieces[me] = cur = x
    for step in range(1, n):
        cur = shift(cur, mesh, axis, "ring_all_gather")
        pieces[(me - step) % n] = cur  # it started on rank me - step
    return torch.stack(pieces, dim=0)
