"""The training, prefill and decode steps on a mesh, and the spec trees:
where models meet the mesh.

A port of ``repro/launch/steps.py``.  ``build_train_step``,
``build_prefill_step`` and ``build_decode_step`` return each step and its
spec trees; they are rank-local SPMD: every rank of the mesh calls the
step with the same global batch (or, with ``local=True``, its own rows of
it) and its own parameter slices, optimizer state or cache, and the
collectives are explicit.

One step (``TrainConfig``):

* the rank takes ``B/D`` rows of the global batch of ``B``, ``D`` the
  ranks of the batch axes that ``batch_pspec`` picks for ``B``, as the
  reference's input sharding gives them.  The reference cuts the global
  batch into ``n = grad_accum`` microbatches of ``m = B/n`` rows and
  splits each over the batch axes.  Where ``D`` divides ``m``, microbatch
  ``i`` of batch rank ``r`` is the global rows ``i·m + r·m/D`` onward,
  ``m/D`` of them, and the rank runs ``n`` microbatches.  Where it does
  not (``jamba-v0.1-52b``'s 16 rows a microbatch over 2 × 16 ranks), the
  reference pads each microbatch over every batch rank and a rank
  computes ``⌈m/D⌉`` rows of it an iteration (its compiled scan's
  activations are one row at the test cell, ``tests/test_torch_dryrun.py``);
  here the rank takes its block of ``B/D`` contiguous rows and runs them
  one row a microbatch, which keeps the step's sum.  A model with MoE
  layers runs them as many rows at a time as one of the reference's MoE
  dispatch groups holds (two of 4096 tokens for jamba), so each group
  routes the same tokens at the same capacity, and a pass without
  gradients first counts each layer's routed pairs per global microbatch
  over every rank, so that each microbatch's aux loss is the reference's
  (``moe_aux_coef``, ``models/moe.py``);
* ``accumulate_microbatches`` runs the model's loss on them under the
  rules (each leaf's spec installed, so the layers know their slices); a
  microbatch's gradients are summed over the batch axes, cast to bf16
  first under ``grad_compression="bf16"``, and with ``zero1`` reduce-
  scattered over ``data`` into the ZeRO-sharded fp32 accumulator (ZeRO-2).
  A leaf the model already reduced over an axis (the MoE's ZeRO-3 experts
  over ``data``) is not reduced over it again.  Each rank's loss is its
  share of the step's mean, so the sums are divided by ``D``; a
  ``loss_mask`` is counted per global microbatch over every rank's rows
  once a step, and each row's tokens weighted by it (``loss_weight``,
  ``transformer.loss_fn``), so the loss stays the mean of the
  microbatches' masked means;
* ``clip_by_global_norm`` over the whole gradient: each leaf's squares
  counted once, by the ranks at coordinate 0 of every axis its slice is
  replicated over, then summed over the mesh;
* ``compress_grads``, the schedule at the optimizer's step, and the
  optimizer on the ZeRO-1 slices of its fp32 state; the updated slices
  are all-gathered over ``data`` back into each rank's parameter slices.

The bundle's ``init_fns`` take the full parameter tree (as the port's
``lm_params_from_numpy`` or ``init_params`` give it) and return each
rank's slices, then its optimizer state.  The spec trees are trees of
``PartitionSpec``; the reference's ``mesh`` argument of the tree builders
is not needed, since a spec names axes and the rules carry the mesh.

Serving (:class:`ServeStepBundle`): the rank takes its rows of the batch
over the batch axes, and the cache is cut as :func:`cache_shardings`
says (the reference's flash-decode layout: batch over the batch axes,
the attention caches' slots over the axes left, Mamba's and RWKV's states
over ``model``).  Prefill returns each rank's logits rows and its slice
of the new cache; a decode step writes the new token's keys, values and
states into the rank's cache slices in place, as the reference donates
its cache (``models/transformer.py`` says how each layer runs on its
slices).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs import ModelConfig, RunConfig
from repro_torch.models.registry import Model, input_specs, param_shapes
from repro_torch.optim import (
    accumulate_microbatches, compress_grads, make_optimizer, make_schedule,
)
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (
    AxisRules, P, PartitionSpec, UnevenSlotsError, batch_pspec,
    cache_leaf_pspec, cache_pspec, local_slice, mesh_sizes, param_pspec,
    path_str, sharding_rules, spec_axes, zero1_pspec,
)
from repro_torch.tree import leaves, leaves_with_paths, tree_map

__all__ = ["path_str", "params_shardings", "opt_shardings",
           "batch_shardings", "cache_shardings", "batch_rows",
           "build_train_step", "build_prefill_step", "build_decode_step",
           "TrainStepBundle", "ServeStepBundle"]


def _tree_specs(tree: Any, spec_fn: Callable[[str, tuple], PartitionSpec]):
    """``spec_fn(path, shape)`` for every leaf of ``tree`` (tensors, meta
    ones included)."""
    out = [spec_fn(path_str(p), tuple(getattr(leaf, "shape", ())))
           for p, leaf in leaves_with_paths(tree)]
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def params_shardings(params_tree: Any, cfg: ModelConfig):
    """``param_pspec`` of every parameter (under the current rules)."""
    return _tree_specs(params_tree, lambda p, s: param_pspec(p, s, cfg))


def opt_shardings(opt_tree: Any, cfg: ModelConfig, rules: AxisRules,
                  zero1: bool = True):
    """Optimizer-state specs: each leaf's ``param_pspec`` (read from its
    path inside the state), with ZeRO-1's ``data`` cut added when
    ``zero1``; scalars replicate."""
    def spec(path, shape):
        if not shape:
            return P()
        ps = param_pspec(path, shape, cfg)
        return zero1_pspec(ps, shape, rules) if zero1 else ps
    return _tree_specs(opt_tree, spec)


def batch_shardings(batch_tree: Any, rules: AxisRules, global_batch: int):
    """Batch specs: the leading dim over ``batch_pspec``'s axes."""
    baxes = batch_pspec(rules, global_batch)
    bspec = baxes if baxes else None

    def spec(path, shape):
        if not shape:
            return P()
        return P(bspec, *([None] * (len(shape) - 1)))
    return _tree_specs(batch_tree, spec)


def _seq_axes(rules: AxisRules, global_batch: int) -> tuple[str, ...]:
    """The decode cache's sequence axes: ``cache_pspec``'s, less the
    batch's."""
    baxes, seq = cache_pspec(rules, global_batch)
    return tuple(a for a in seq if a not in baxes)


def cache_shardings(cache_tree: Any, cfg: ModelConfig, rules: AxisRules,
                    global_batch: int):
    """Decode-cache specs (``sharding.cache_leaf_pspec`` of every leaf):
    batch over (pod, data) when divisible, the attention caches' sequence
    over the leftover axes (sequence-parallel KV, the flash-decode
    layout), Mamba's and RWKV's states over ``model``."""
    baxes = batch_pspec(rules, global_batch)
    seq = _seq_axes(rules, global_batch)
    return _tree_specs(cache_tree, lambda p, s: cache_leaf_pspec(
        p, s, rules, baxes or None, seq or None))


def batch_rows(global_batch: int, n_micro: int, n_ranks: int,
               rank: int) -> list[int]:
    """The global rows batch rank ``rank`` of ``n_ranks`` takes, in the
    order it runs them: where the ranks split a microbatch evenly, its
    share of each microbatch in turn; otherwise its contiguous block of
    the global batch (module docstring)."""
    if global_batch % n_micro or global_batch % n_ranks:
        raise ValueError(f"a batch of {global_batch} does not split into "
                         f"{n_micro} microbatches and over {n_ranks} ranks")
    m = global_batch // n_micro
    if m % n_ranks:
        per = global_batch // n_ranks
        return list(range(rank * per, (rank + 1) * per))
    per = m // n_ranks
    return [i * m + rank * per + j for i in range(n_micro)
            for j in range(per)]


def local_microbatches(global_batch: int, n_micro: int, n_ranks: int,
                       group: int = 1) -> int:
    """How many microbatches a batch rank runs: ``n_micro`` where the ranks
    split a microbatch evenly, else one for each ``group`` rows of its
    block."""
    if (global_batch // n_micro) % n_ranks == 0:
        return n_micro
    if (global_batch // n_ranks) % group:
        raise ValueError(f"a rank's {global_batch // n_ranks} rows do not "
                         f"split into MoE dispatch groups of {group} rows")
    return global_batch // n_ranks // group


def moe_group_rows(rules: AxisRules, micro: int, seq: int) -> int:
    """The rows of one of the reference's MoE dispatch groups in a
    microbatch of ``micro`` rows of ``seq`` tokens, or 1 where a group is
    a part of a row: its ``shard_map`` cuts the microbatch over the batch
    axes that divide ``micro`` and routes each shard's tokens in groups of
    ``moe.GROUP`` where they divide into them, else whole
    (``src/repro/models/moe.py:119,158-166``)."""
    from repro_torch.models.moe import GROUP

    n = 1
    for ax in batch_pspec(rules, micro):
        n *= rules.mesh_shape[ax]
    shard = micro // n
    if shard * seq % GROUP:
        return shard
    return math.lcm(seq, GROUP) // seq


class TrainStepBundle(NamedTuple):
    step_fn: Callable  # (params, opt_state, batch) -> (params, opt, metrics)
    params_shape: Any  # tree of meta tensors: the full leaves
    opt_shape: Any     # the same for this rank's optimizer state
    in_shardings: tuple   # (param specs, optimizer specs, batch specs)
    out_shardings: tuple  # (param specs, optimizer specs, metric specs)
    init_fns: tuple  # (full params -> local params, local params -> opt)
    #: (params, batch) -> (loss, gradients): the step's mean loss and its
    #: reduced fp32 gradients (ZeRO-1 slices under ``zero1``) before
    #: clipping
    grad_fn: Callable | None = None
    #: this rank's rows of the global batch, in the order it runs them
    rows: list | None = None


class _Leaf(NamedTuple):
    spec: PartitionSpec     # the parameter's
    zdim: int | None        # the dim ZeRO-1 cuts over `data`, if any
    reduce: tuple[str, ...]  # batch axes its gradient is summed over
    canonical: bool         # this rank counts the leaf in the norm


def _zero1_dim(spec: PartitionSpec, zspec: PartitionSpec) -> int | None:
    for d, (a, b) in enumerate(zip(list(spec) + [None] * len(zspec), zspec)):
        if a != b:
            return d
    return None


class _Setup(NamedTuple):
    params_shape: Any
    p_specs: Any
    baxes: tuple[str, ...]
    n_batch: int
    rows: list[int]
    n_local: int  # the microbatches this rank runs
    spread: bool  # fewer rows a microbatch than batch ranks
    step_rules: AxisRules


def _setup(model: Model, mesh, rules: AxisRules, b_global: int,
           n_micro: int, extra: dict | None = None,
           seq: int | None = None) -> _Setup:
    """What every step shares: the full parameter shapes and their specs,
    the batch axes and this rank's rows, and the rules the step runs
    under (the batch axes used, each leaf's spec, and ``extra``
    logical axes).  ``seq``: a training step's sequence, which sizes an
    MoE's dispatch groups."""
    sizes = mesh_sizes(mesh)
    with sharding_rules(rules):
        params_shape = param_shapes(model)
        p_specs = params_shardings(params_shape, model.cfg)
        # the reference's input sharding: the axes that divide the global
        # batch.  Where a microbatch has fewer rows than those ranks
        # (jamba's 16 of 256 over 2 × 16), its compiled step still spreads
        # the microbatch's rows over all of them, padded, a row or so a
        # rank (the test cell's record), not replicated over the axes
        # left; so a rank runs its own rows one at a time.
        baxes = batch_pspec(rules, b_global)
    n_batch, batch_rank = 1, 0
    for ax in baxes:
        n_batch *= sizes[ax]
        batch_rank = batch_rank * sizes[ax] + mesh.get_local_rank(ax)
    rows = batch_rows(b_global, n_micro, n_batch, batch_rank)
    spread = (b_global // n_micro) % n_batch != 0
    if spread and model.cfg.family == "jpeg_resnet":
        raise ValueError(
            f"{model.cfg.name}: batch-norm statistics span a microbatch of "
            f"{b_global // n_micro} rows, fewer than the {n_batch} batch "
            "ranks; use fewer microbatches")
    group = moe_group_rows(rules, b_global // n_micro, seq) \
        if spread and model.cfg.n_experts else 1
    n_local = local_microbatches(b_global, n_micro, n_batch, group)
    step_rules = dataclasses.replace(
        rules, mesh=mesh, rules={**rules.rules, "batch": baxes,
                                 **(extra or {})},
        specs={path_str(p): s for p, s in leaves_with_paths(p_specs)})
    return _Setup(params_shape, p_specs, baxes, n_batch, rows, n_local,
                  spread, step_rules)


def _take_rows(batch: Any, rows: list[int], local: bool,
               device=None) -> Any:
    """This rank's rows of a global ``batch`` (``batch`` itself when
    ``local``), on ``device``."""
    if local:
        return batch if device is None else tree_map(
            lambda x: x.to(device), batch)
    idx = torch.as_tensor(rows)
    return tree_map(lambda x: x.index_select(0, idx.to(x.device)).to(
        x.device if device is None else device), batch)


def _weigh_loss_mask(batch: Any, rows: list[int], m: int, n_micro: int,
                     n_local: int, n_batch: int, mesh,
                     baxes: tuple[str, ...]) -> Any:
    """``batch`` with each row's ``loss_weight`` when it has a
    ``loss_mask``: ``(n_local · D / n_micro) / c``, ``c`` the unmasked
    tokens of the row's global microbatch (of ``m`` rows) over every rank,
    so that the step's means over the rank's ``n_local`` microbatches and
    the ``D`` batch ranks give the mean of the microbatches' masked
    means."""
    mask = batch.get("loss_mask") if isinstance(batch, dict) else None
    if mask is None:
        return batch
    mb = torch.as_tensor([r // m for r in rows], device=mask.device)
    counts = torch.zeros(n_micro, dtype=torch.float32, device=mask.device)
    counts = C.all_reduce(counts.index_add(
        0, mb, mask.to(torch.float32).sum(dim=1)), mesh, baxes)
    weight = (n_local * n_batch / n_micro) / torch.clamp(counts[mb], min=1)
    return dict(batch, loss_weight=weight)


def _weigh_moe_aux(model: Model, params: Any, batch: Any, rows: list[int],
                   m: int, n_micro: int, n_local: int, n_batch: int, mesh,
                   baxes: tuple[str, ...]) -> Any:
    """``batch`` with each row's ``moe_aux_coef`` (MoE layers, E).  A pass
    without gradients over the rank's ``n_local`` microbatches counts each
    MoE layer's routed pairs (``moe.collecting_counts``); the counts ``c``
    are summed per global microbatch (of ``m`` rows) over every rank, and
    a layer's coefficient ``E·c / (T·k) / T``, ``T`` the microbatch's
    tokens, makes its aux loss ``E·Σ (c/(T·k))·(p/T)`` linear in each
    call's router probabilities ``p``.  It is weighted as
    :func:`_weigh_loss_mask` weights a row, so the step's mean is the
    mean of the microbatches' aux losses, as the reference's."""
    from repro_torch.models import moe

    q = len(rows) // n_local
    with torch.no_grad():
        per = []
        for j in range(n_local):
            with moe.collecting_counts() as calls:
                model.loss_fn(params, tree_map(
                    lambda x: x[j * q:(j + 1) * q], batch))
            per.append(torch.stack(calls))
        counts = torch.stack(per)  # (n_local, MoE layers, E)
        mb = torch.as_tensor([rows[j * q] // m for j in range(n_local)],
                             device=counts.device)
        total = C.all_reduce(counts.new_zeros(
            (n_micro,) + counts.shape[1:]).index_add(0, mb, counts), mesh,
            baxes)
        k = model.cfg.experts_per_token
        t = torch.clamp(total.sum(-1, keepdim=True) / k, min=1)
        coef = (model.cfg.n_experts * n_local * n_batch / n_micro) \
            * total / (t * k) / t
    return dict(batch, moe_aux_coef=coef[mb].repeat_interleave(q, dim=0))


def build_train_step(model: Model, run: RunConfig, mesh,
                     rules: AxisRules) -> TrainStepBundle:
    """The fused loss, gradient and update step with DP/TP/EP cuts and
    ZeRO-1 (module docstring).  ``rules`` are the mesh's axis rules (their
    own ``mesh`` need not be set).  The step takes ``local=True`` when its
    batch is already this rank's rows (microbatch after microbatch)."""
    cfg, tc = model.cfg, run.train
    optimizer = make_optimizer(tc.optimizer, b1=tc.beta1, b2=tc.beta2,
                               eps=tc.eps, weight_decay=tc.weight_decay)
    schedule = make_schedule(tc.schedule, tc.learning_rate, tc.warmup_steps,
                             tc.total_steps)
    b_global = run.shape.global_batch
    sizes = mesh_sizes(mesh)
    setup = _setup(model, mesh, rules, b_global, tc.grad_accum,
                   seq=run.shape.seq_len)
    params_shape, p_specs, baxes = setup.params_shape, setup.p_specs, \
        setup.baxes
    n_batch, rows, step_rules = setup.n_batch, setup.rows, setup.step_rules

    data_axes = rules.axes("data")
    layout = []
    for (_, spec), shape in zip(leaves_with_paths(p_specs),
                                leaves(params_shape)):
        shape = tuple(shape.shape)
        used = {a for e in spec for a in spec_axes(e)}
        zspec = zero1_pspec(spec, shape, rules) if tc.zero1 else spec
        zdim = _zero1_dim(spec, zspec)
        held = used | ({a for a in data_axes} if zdim is not None else set())
        canonical = all(mesh.get_local_rank(a) == 0 for a in sizes
                        if a not in held)
        layout.append(_Leaf(spec, zdim, tuple(a for a in baxes
                                              if a not in used), canonical))

    def zslice(leaf: _Leaf, x: torch.Tensor) -> torch.Tensor:
        """A parameter slice's ZeRO-1 part (the optimizer's)."""
        if leaf.zdim is None:
            return x
        return local_slice(x, P(*([None] * leaf.zdim), data_axes), mesh)

    def per_leaf(fn, *trees):
        it = iter(layout)
        return tree_map(lambda *xs: fn(next(it), *xs), *trees)

    def reduce_grad(leaf: _Leaf, g: torch.Tensor) -> torch.Tensor:
        """Sum a rank's gradient over the batch axes (bf16 on the wire
        under compression), into its ZeRO part when ``zero1``."""
        x = g.to(torch.bfloat16) if tc.grad_compression == "bf16" else g
        for ax in leaf.reduce:
            if leaf.zdim is not None and ax in data_axes:
                x = C.reduce_scatter(x, mesh, (ax,), leaf.zdim)
            else:
                x = C.all_reduce(x, mesh, (ax,))
        if leaf.zdim is not None and not set(data_axes) & set(leaf.reduce):
            x = zslice(leaf, x)  # data ranks hold the same rows here
        return x.to(torch.float32) * (1.0 / n_batch)

    def grad_constraint(grads):
        return per_leaf(reduce_grad, grads)

    def global_norm(grads) -> torch.Tensor:
        """Every rank does the same work (so each rank's count is rank
        0's); a leaf's squares add where the rank is canonical for it."""
        dev = leaves(grads)[0].device
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        keep = torch.tensor([leaf.canonical for leaf in layout], device=dev)
        for i, g in enumerate(leaves(grads)):
            part = torch.sum(torch.square(g.to(torch.float32)))
            sq = sq + torch.where(keep[i], part, 0.0)
        return torch.sqrt(C.all_reduce(sq, mesh, tuple(sizes)))

    def loss_of(p, b):
        return model.loss_fn(p, b)[0]

    def grad_fn(params, batch, local=False):
        mine = _take_rows(batch, rows, local, leaves(params)[0].device)
        mine = _weigh_loss_mask(mine, rows, b_global // tc.grad_accum,
                                tc.grad_accum, setup.n_local, n_batch, mesh,
                                baxes)
        with sharding_rules(step_rules):
            if setup.spread and cfg.n_experts:
                mine = _weigh_moe_aux(model, params, mine, rows,
                                      b_global // tc.grad_accum,
                                      tc.grad_accum, setup.n_local, n_batch,
                                      mesh, baxes)
            loss, grads = accumulate_microbatches(
                loss_of, params, mine, setup.n_local,
                grad_constraint=grad_constraint if tc.zero1 else None)
            if not tc.zero1:
                grads = grad_constraint(grads)
        loss = C.all_reduce(loss.to(torch.float32), mesh, baxes) / n_batch
        return loss, grads

    def train_step(params, opt_state, batch, local=False):
        loss, grads = grad_fn(params, batch, local)
        gnorm = global_norm(grads)
        scale = torch.clamp(tc.grad_clip / (gnorm + 1e-6), max=1.0)
        grads = tree_map(lambda g: (g * scale).to(g.dtype), grads)
        grads = compress_grads(grads, tc.grad_compression)
        lr = schedule(opt_state.step)
        zparams = per_leaf(zslice, params)
        new_z, new_opt = optimizer.update(grads, opt_state, zparams, lr)

        def regather(leaf, z):
            if leaf.zdim is None:
                return z
            return C.all_gather(z, mesh, data_axes, leaf.zdim)

        new_params = per_leaf(regather, new_z)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     "lr": lr}

    def init_params(full: Any) -> Any:
        return per_leaf(lambda leaf, x: local_slice(x, leaf.spec, mesh),
                        full)

    def init_opt(params: Any) -> Any:
        return optimizer.init(per_leaf(zslice, params))

    with sharding_rules(rules):
        opt_shape = optimizer.init(_local_shapes(params_shape, layout,
                                                 sizes, data_axes))
        o_specs = opt_shardings(optimizer.init(params_shape), cfg, rules,
                                tc.zero1)
        host = input_specs(cfg, b_global, run.shape.seq_len, "train")
        b_specs = batch_shardings(host, rules, b_global)
    metrics = {"loss": P(), "grad_norm": P(), "lr": P()}
    return TrainStepBundle(
        step_fn=train_step, params_shape=params_shape, opt_shape=opt_shape,
        in_shardings=(p_specs, o_specs, b_specs),
        out_shardings=(p_specs, o_specs, metrics),
        init_fns=(init_params, init_opt), grad_fn=grad_fn, rows=rows)


class ServeStepBundle(NamedTuple):
    #: prefill: (params, batch) -> (logits, cache); decode: (params, cache,
    #: batch) -> (logits, cache), the cache written in place; both take
    #: ``local=True`` when the batch is already this rank's rows
    step_fn: Callable
    params_shape: Any  # tree of meta tensors: the full leaves
    cache_shape: Any   # the full decode cache (meta), None for prefill
    in_shardings: tuple   # (param specs, [cache specs,] batch specs)
    #: (full params -> local params, full cache -> local cache)
    init_fns: tuple
    rows: list          # this rank's rows of the global batch


def _serve_setup(model: Model, run: RunConfig, mesh, rules: AxisRules,
                 kind: str):
    """What the prefill and decode steps share: the slot check (a cache
    that does not split evenly raises), the setup with the cache's
    sequence axes, the batch and cache specs and the init functions."""
    cfg, b = model.cfg, run.shape.global_batch
    seq = _seq_axes(rules, b)
    n_seq = 1
    for ax in seq:
        n_seq *= mesh_sizes(mesh)[ax]
    slots = run.shape.seq_len if cfg.sliding_window is None \
        else min(run.shape.seq_len, cfg.sliding_window)
    attends = cfg.ssm_kind != "rwkv6" and not (kind == "prefill"
                                               and cfg.encoder_decoder)
    if attends and slots % n_seq:
        raise UnevenSlotsError(
            f"{cfg.name}: an attention cache of {slots} slots does not "
            f"split over {seq} ({n_seq} ranks)")
    setup = _setup(model, mesh, rules, b, 1, {"cache_seq": seq})
    with sharding_rules(rules):
        host = input_specs(cfg, b, run.shape.seq_len, kind)
        b_specs = batch_shardings(host, rules, b)
        cache_shape = model.init_cache(b, run.shape.seq_len, "meta") \
            if kind == "decode" else None
        c_specs = None if cache_shape is None else cache_shardings(
            cache_shape, cfg, rules, b)

    def init_params(full: Any) -> Any:
        return tree_map(lambda x, s: local_slice(x, s, mesh), full,
                        setup.p_specs)

    def init_cache(full: Any) -> Any:
        return tree_map(lambda x, s: local_slice(x, s, mesh), full, c_specs)

    return setup, b_specs, cache_shape, c_specs, (init_params, init_cache)


def build_prefill_step(model: Model, run: RunConfig, mesh,
                       rules: AxisRules) -> ServeStepBundle:
    """The prompt pass on this rank's rows (module docstring): its logits
    rows and its slice of the cache ``cache_shardings`` lays out for the
    run's global batch (the audio family's encoder output rows and
    None)."""
    setup, b_specs, _, _, init_fns = _serve_setup(model, run, mesh, rules,
                                                  "prefill")

    def prefill_step(params, batch, local=False):
        mine = _take_rows(batch, setup.rows, local)
        with sharding_rules(setup.step_rules):
            return model.prefill(params, mine)

    return ServeStepBundle(prefill_step, setup.params_shape, None,
                           (setup.p_specs, b_specs), init_fns, setup.rows)


def build_decode_step(model: Model, run: RunConfig, mesh,
                      rules: AxisRules) -> ServeStepBundle:
    """One token for each of this rank's rows against its cache slices,
    written in place (module docstring); ``init_fns[1]`` cuts a full
    cache of the run's global batch and sequence."""
    setup, b_specs, cache_shape, c_specs, init_fns = _serve_setup(
        model, run, mesh, rules, "decode")

    def decode_step(params, cache, batch, local=False):
        mine = _take_rows(batch, setup.rows, local)
        with sharding_rules(setup.step_rules):
            return model.decode_step(params, cache, mine)

    return ServeStepBundle(decode_step, setup.params_shape, cache_shape,
                           (setup.p_specs, c_specs, b_specs), init_fns,
                           setup.rows)


def _local_shapes(params_shape, layout, sizes, data_axes) -> Any:
    """Meta tensors of this rank's ZeRO-1 parameter slices (the optimizer
    state's shapes)."""
    def local(leaf, s):
        shape = list(s.shape)
        for d, e in enumerate(leaf.spec):
            for ax in spec_axes(e):
                shape[d] //= sizes[ax]
        if leaf.zdim is not None:
            for ax in data_axes:
                shape[leaf.zdim] //= sizes[ax]
        return torch.empty(shape, dtype=s.dtype, device="meta")

    it = iter(layout)
    return tree_map(lambda s: local(next(it), s), params_shape)
