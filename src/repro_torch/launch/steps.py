"""The training step on a mesh, and the spec trees: where models meet the
mesh.

A port of ``repro/launch/steps.py``'s training half.  ``build_train_step``
returns the step and its spec trees; it is rank-local SPMD: every rank of
the mesh calls the step with the same global batch and its own parameter
slices and optimizer state, and the collectives are explicit.

One step (``TrainConfig``):

* the rank takes its rows of the global batch over the batch axes that
  ``batch_pspec`` picks.  As in the reference, which cuts the global batch
  into ``grad_accum`` microbatches and then splits each over the batch
  axes, microbatch ``i`` of batch rank ``r`` (of ``D``) is the global rows
  ``i·B/n + r·B/(n·D)`` onward, ``B/(n·D)`` of them;
* ``accumulate_microbatches`` runs the model's loss on them under the
  rules (each leaf's spec installed, so the layers know their slices); a
  microbatch's gradients are summed over the batch axes, cast to bf16
  first under ``grad_compression="bf16"``, and with ``zero1`` reduce-
  scattered over ``data`` into the ZeRO-sharded fp32 accumulator (ZeRO-2).
  A leaf the model already reduced over an axis (the MoE's ZeRO-3 experts
  over ``data``) is not reduced over it again.  Each rank's loss is its
  share of the microbatch's mean over every rank's rows (a ``loss_mask``
  is counted over them all, ``transformer.loss_fn``), so the sums are
  divided by ``D``;
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
The prefill and decode bundles and the cache specs are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs import ModelConfig, RunConfig
from repro_torch.models.registry import Model, input_specs, param_shapes
from repro_torch.optim import (
    accumulate_microbatches, compress_grads, make_optimizer, make_schedule,
)
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (
    AxisRules, P, PartitionSpec, batch_pspec, local_slice, mesh_sizes,
    param_pspec, path_str, sharding_rules, spec_axes, zero1_pspec,
)
from repro_torch.tree import leaves, leaves_with_paths, tree_map

__all__ = ["path_str", "params_shardings", "opt_shardings",
           "batch_shardings", "batch_rows", "build_train_step",
           "TrainStepBundle"]


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


def batch_rows(global_batch: int, n_micro: int, n_ranks: int,
               rank: int) -> list[int]:
    """The global rows batch rank ``rank`` of ``n_ranks`` takes, microbatch
    after microbatch: microbatch ``i`` of the global batch split evenly
    over the ranks."""
    if global_batch % (n_micro * n_ranks):
        raise ValueError(f"a batch of {global_batch} does not split into "
                         f"{n_micro} microbatches over {n_ranks} ranks")
    m = global_batch // n_micro
    per = m // n_ranks
    return [i * m + rank * per + j for i in range(n_micro)
            for j in range(per)]


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


def build_train_step(model: Model, run: RunConfig, mesh,
                     rules: AxisRules) -> TrainStepBundle:
    """The fused loss, gradient and update step with DP/TP/EP cuts and
    ZeRO-1 (module docstring).  ``rules`` are the mesh's axis rules (their
    own ``mesh`` need not be set)."""
    cfg, tc = model.cfg, run.train
    optimizer = make_optimizer(tc.optimizer, b1=tc.beta1, b2=tc.beta2,
                               eps=tc.eps, weight_decay=tc.weight_decay)
    schedule = make_schedule(tc.schedule, tc.learning_rate, tc.warmup_steps,
                             tc.total_steps)
    b_global = run.shape.global_batch
    sizes = mesh_sizes(mesh)
    with sharding_rules(rules):
        params_shape = param_shapes(model)
        p_specs = params_shardings(params_shape, cfg)
        baxes = batch_pspec(rules, b_global)
    n_batch = 1
    for ax in baxes:
        n_batch *= sizes[ax]
    batch_rank = 0
    for ax in baxes:
        batch_rank = batch_rank * sizes[ax] + mesh.get_local_rank(ax)
    rows = batch_rows(b_global, tc.grad_accum, n_batch, batch_rank)
    step_rules = dataclasses.replace(
        rules, mesh=mesh, rules={**rules.rules, "batch": baxes},
        specs={path_str(p): s for p, s in leaves_with_paths(p_specs)})

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
        sq = torch.zeros((), dtype=torch.float32,
                         device=leaves(grads)[0].device)
        for leaf, g in zip(layout, leaves(grads)):
            if leaf.canonical:
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(C.all_reduce(sq, mesh, tuple(sizes)))

    def loss_of(p, b):
        return model.loss_fn(p, b)[0]

    def grad_fn(params, batch):
        dev = leaves(params)[0].device
        idx = torch.as_tensor(rows)
        local = tree_map(
            lambda x: x.index_select(0, idx.to(x.device)).to(dev), batch)
        with sharding_rules(step_rules):
            loss, grads = accumulate_microbatches(
                loss_of, params, local, tc.grad_accum,
                grad_constraint=grad_constraint if tc.zero1 else None)
            if not tc.zero1:
                grads = grad_constraint(grads)
        loss = C.all_reduce(loss.to(torch.float32), mesh, baxes) / n_batch
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
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
        init_fns=(init_params, init_opt), grad_fn=grad_fn)


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
