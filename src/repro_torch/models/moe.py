"""Mixture-of-Experts FFN: sort-based grouped dispatch with static capacity.

A port of ``repro/models/moe.py``, both of its paths: global dispatch
without a mesh, and the expert-parallel path under mesh rules.
Each token's router picks its top ``k`` experts (fp32 router and softmax,
weights renormalised); the (token, expert) pairs are sorted by expert
(stable), each expert keeps its first ``capacity`` pairs and drops the
rest, and the kept tokens go through three grouped products over ``(E, C,
d)`` buffers.  Nothing here is a kernel of ours: the reference computes the
same products with XLA einsums outside any Pallas kernel.

Dispatch and combine move rows with gathers only, forward and backward.
The reference fills its buffer with a scatter and combines with a
scatter-add; on the card a float scatter-add (``index_add_``,
``scatter_add_``, or an accumulating ``index_put_`` in a backward) uses
atomics and sums in whatever order they land.  Here the dispatch gathers
each slot's token, and its backward gathers each token's ``k`` slots
(:class:`_GatherRows`, the inverse permutation); the combine gathers each
pair's expert output and sums a token's ``k`` weighted slots in a fixed
order.  So two gradient calls give the same bits.

Three profiler ranges split the FFN's device time: ``moe_route`` (router,
top-k, sort and the dispatch gather), ``moe_experts`` (the grouped
products and their SwiGLU) and ``moe_combine``.

The expert-parallel path (the reference's ``shard_map``, ``moe.py:
117-196``) runs under mesh rules (``parallel/sharding.py``, installed by
``launch/steps.py``'s training step).  Tokens stay on their batch shard
and capacity is per shard: each rank routes its own rows, in groups of at
most :data:`GROUP` tokens (one group when they do not divide evenly).
Experts are sliced along d_ff over ``model``: a rank runs its slice of
every expert and the partial outputs are summed over ``model`` after the
combine; the expert input and the routing weights enter that region
through ``layers.model_in``, so their gradients sum the slices' parts.
ZeRO-3 expert storage (d_model over ``data``) is gathered just in time
and its gradient reduce-scattered.  The load-balance counts and router
probabilities are summed over the batch axes and the unused ones before
the aux loss, so it is the global batch's.  Gathers both ways here too.

Where the training step spreads a microbatch over more batch ranks than
it has rows (``launch/steps.py``), a rank runs a few rows of it at a
time, so no call sees the microbatch whole.  A first pass without
gradients then records each call's counts (:func:`collecting_counts`);
the step sums them per global microbatch over every rank and hands each
call its layer's ``aux_coef``, with which the aux loss is linear in the
call's own router probabilities: the pieces of a microbatch add up to
its aux loss, value and gradient.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import active_rules, bind_rules

__all__ = ["GROUP", "init_moe", "capacity", "moe_ffn", "collecting_counts"]

GROUP = 8192  # tokens per dispatch group on the expert-parallel path

#: the list :func:`collecting_counts` fills, while it is open
_COLLECT: contextvars.ContextVar = contextvars.ContextVar("moe_collect",
                                                          default=None)


@contextlib.contextmanager
def collecting_counts():
    """Within, each expert-parallel call appends its per-expert pair
    counts (E,) fp32, summed over its groups and not reduced over any
    rank, to the list yielded, in call order, and returns a zero aux loss
    (the step's count pass, module docstring)."""
    calls: list[torch.Tensor] = []
    token = _COLLECT.set(calls)
    try:
        yield calls
    finally:
        _COLLECT.reset(token)


def init_moe(normal, cfg: ModelConfig) -> dict:
    """One MoE FFN's parameters in the reference's layout and scales
    (``moe.py:37-47``).  ``normal(shape, scale, dtype=None)`` draws a
    weight in the model's dtype unless ``dtype`` says otherwise (the
    router is fp32)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": normal((d, e), d ** -0.5, torch.float32),
        "w_gate": normal((e, d, f), d ** -0.5),
        "w_in": normal((e, d, f), d ** -0.5),
        "w_out": normal((e, f, d), f ** -0.5),
    }


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``t`` tokens: the reference's expression on
    host numbers, ⌈t·k·cf / E⌉ clamped to [1, t]."""
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = int(-(-t * k * cfg.capacity_factor // e))
    return max(min(cap, t), 1)


def _gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[i] = Σ_j src[index[i, j]]``, summed in ``j`` order; an index of
    ``len(src)`` reads a zero row."""
    pad = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    out = pad[index[:, 0]]
    for j in range(1, index.shape[1]):
        out = out + pad[index[:, j]]
    return out


class _GatherRows(torch.autograd.Function):
    """:func:`_gather_rows` whose backward is a gather too: ``inverse``
    lists, for every row of ``src``, the output rows that read it (padded
    with ``len(out)``), so the gradient of a row is a fixed-order sum and
    no float atomics run."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _gather_rows(src, index)

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        return _gather_rows(grad, inverse), None, None


def _routing(probs: torch.Tensor, cfg: ModelConfig, cap: int):
    """The routing of ``probs`` (T, E) → (top-k weights (T, k), for each
    slot of the ``(E·cap)`` buffer the token it holds (``T`` if empty), for
    each pair its slot (``E·cap`` if dropped), for each slot its pair
    (``T·k`` if empty), per-expert pair counts before the drop)."""
    t, e = probs.shape
    k = cfg.experts_per_token
    dev = probs.device
    # jax.lax.top_k puts the lower index first on ties; a stable descending
    # sort does the same (torch.topk promises no order)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[:, :k], idx[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    pair_e = top_e.reshape(-1)
    order = torch.argsort(pair_e, stable=True)
    sorted_e = pair_e[order]
    # an int index_add_ (bincount would wait for the device to size its
    # output)
    counts = torch.zeros(e, dtype=torch.long, device=dev).index_add_(
        0, pair_e, torch.ones_like(pair_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[sorted_e]
    sink = e * cap
    slot = torch.where(rank < cap, sorted_e * cap + rank,
                       torch.full_like(rank, sink))
    # int scatters: the dropped pairs all land on the sink entry, cut off
    tok_of_slot = torch.full((sink + 1,), t, dtype=torch.long, device=dev)
    tok_of_slot[slot] = order // k
    pair_of_slot = torch.full((sink + 1,), t * k, dtype=torch.long,
                              device=dev)
    pair_of_slot[slot] = order
    slot_of_pair = torch.empty_like(slot)
    slot_of_pair[order] = slot
    return (top_w, tok_of_slot[:sink], slot_of_pair.reshape(t, k),
            pair_of_slot[:sink], counts)


def _aux_loss(counts: torch.Tensor, probs_sum: torch.Tensor, t: int,
              e: int, k: int) -> torch.Tensor:
    """The Switch load-balance loss, counting every pair before the drop
    (``moe.py:98-101``)."""
    frac_tokens = counts.float() / max(t * k, 1.0)
    frac_probs = probs_sum / max(t, 1.0)
    return e * torch.sum(frac_tokens * frac_probs)


def _dispatch_compute_combine(xf: torch.Tensor, params: dict,
                              cfg: ModelConfig, split: bool = False):
    """Route, run and combine the tokens ``xf`` (T, D) with capacity over
    T → (out (T, D), per-expert pair counts (E,), router probabilities
    summed over the tokens (E,)).  ``split``: the experts are this rank's
    d_ff slice, so the expert region is entered with ``layers.model_in``
    and its partial output summed over ``model``."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(t, cfg)
    with record_function("moe_route"):
        acc = torch.promote_types(xf.dtype, torch.float32)  # fp32 at least
        logits = xf.to(acc) @ params["router"].to(acc)  # (T, E)
        probs = torch.softmax(logits, dim=-1)
        top_w, tok_of_slot, slot_of_pair, pair_of_slot, counts = _routing(
            probs, cfg, cap)
        grouped = _GatherRows.apply(L.model_in(xf) if split else xf,
                                    tok_of_slot[:, None], slot_of_pair)
    with record_function("moe_experts"):
        grouped = grouped.reshape(e, cap, d)
        gate = F.silu(torch.bmm(grouped, params["w_gate"]))
        up = torch.bmm(grouped, params["w_in"])
        y = torch.bmm(gate * up, params["w_out"]).reshape(e * cap, d)
    with record_function("moe_combine"):
        y_pairs = _GatherRows.apply(y, slot_of_pair.reshape(-1, 1),
                                    pair_of_slot[:, None])
        w = top_w.to(xf.dtype)
        if split:
            w = L.model_in(w)
        out = (y_pairs.reshape(t, k, d) * w[..., None]).sum(1)
        if split:
            out = L.model_out(out)
    return out, counts, probs.sum(0)


def moe_ffn(x: torch.Tensor, params: dict, cfg: ModelConfig,
            aux_coef: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, S, D) → (out (B, S, D), aux loss): top-k with renormalised
    weights (the Mixtral convention), capacity over the B·S tokens, overflow
    dropped; under mesh rules the expert-parallel path (:func:`_moe_ep`),
    where ``x`` is this rank's rows.  ``aux_coef`` (E,): the aux loss is
    ``Σ aux_coef · (router probabilities summed over x's tokens)``, for
    rows of a microbatch spread over the ranks (module docstring)."""
    rules = active_rules()
    if rules is not None:
        return _moe_ep(x, params, cfg, rules, aux_coef)
    if aux_coef is not None:
        raise ValueError("aux_coef is for the expert-parallel path")
    b, s, d = x.shape
    t = b * s
    out, counts, probs_sum = _dispatch_compute_combine(x.reshape(t, d),
                                                       params, cfg)
    aux = _aux_loss(counts, probs_sum, t, cfg.n_experts,
                    cfg.experts_per_token)
    return out.reshape(b, s, d), aux


def _moe_ep(x: torch.Tensor, params: dict, cfg: ModelConfig, rules,
            aux_coef: torch.Tensor | None = None):
    """The expert-parallel path on this rank's tokens (``moe.py:117-196``):
    groups of at most :data:`GROUP` tokens, each group's capacity its own;
    experts f-sliced over ``model``; ZeRO-3 experts (d_model cut over
    ``data``) gathered just in time; counts and probabilities summed over
    the batch and unused axes for the aux loss, unless the counts are
    being collected or ``aux_coef`` holds them (module docstring)."""
    from repro_torch.parallel import collectives as C

    mesh = rules.mesh
    maxes, baxes = rules.axes("model"), rules.axes("batch")
    unused = tuple(a for a in mesh.mesh_dim_names
                   if a not in baxes and a not in maxes)
    summed = frozenset(baxes)
    p = dict(params)
    for name, d_dim in (("w_gate", 1), ("w_in", 1), ("w_out", 2)):
        if p[name].shape[d_dim] != cfg.d_model:  # ZeRO-3: d over data
            p[name] = C.GatherParam.apply(p[name], mesh,
                                          [(d_dim, rules.axes("data"))],
                                          summed)
    split = p["w_gate"].shape[-1] != cfg.d_ff
    b, s, d = x.shape
    t_loc = b * s
    xf = x.reshape(t_loc, d)
    n_groups = max(t_loc // GROUP, 1)
    if t_loc % GROUP:
        n_groups = 1
    tg = t_loc // n_groups

    def group(xg):
        return _dispatch_compute_combine(xg, p, cfg, split)

    outs, counts, probs_sum = [], 0, 0
    for gi in range(n_groups):
        xg = xf[gi * tg:(gi + 1) * tg]
        if n_groups > 1 and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            o, c, ps = checkpoint(bind_rules(group), xg,
                                  use_reentrant=False)
        else:
            o, c, ps = group(xg)
        outs.append(o)
        counts, probs_sum = counts + c, probs_sum + ps
    out = outs[0] if n_groups == 1 else torch.cat(outs)
    calls = _COLLECT.get()
    if calls is not None:
        calls.append(counts.to(torch.float32))
        return out.reshape(b, s, d), probs_sum.new_zeros(())
    if aux_coef is not None:
        return out.reshape(b, s, d), torch.sum(aux_coef * probs_sum)
    reduce_axes = tuple(baxes) + unused
    t_tot = t_loc
    for ax in reduce_axes:
        t_tot *= mesh.size(mesh.mesh_dim_names.index(ax))
    counts = C.all_reduce(counts, mesh, reduce_axes)
    probs_sum = C.AllReduce.apply(probs_sum, mesh, reduce_axes)
    aux = _aux_loss(counts, probs_sum, t_tot, cfg.n_experts,
                    cfg.experts_per_token)
    return out.reshape(b, s, d), aux
