"""Gradients of a loss over a parameter tree, global-norm clipping,
compression and microbatch accumulation.

Compression casts gradients to a narrower dtype; the mesh step
(``launch/steps.py``) casts each microbatch's gradients before the
data-parallel reduction, so the bytes on the wire halve, and the reduced
ones again after clipping, where the reference casts them."""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["value_and_grad", "global_norm", "clip_by_global_norm",
           "compress_grads", "accumulate_microbatches"]


def value_and_grad(fn: Callable[..., torch.Tensor], tree: Any,
                   *args: Any) -> tuple[torch.Tensor, Any]:
    """``(fn(tree, *args), ∂fn/∂tree)`` for a scalar ``fn``, like
    ``jax.value_and_grad``: every leaf gets a gradient, zero where the
    value does not depend on it."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), tree)
    value = fn(live, *args)
    wrt = leaves(live)
    grads = torch.autograd.grad(value, wrt, allow_unused=True)
    it = iter([torch.zeros_like(w) if g is None else g
               for w, g in zip(wrt, grads)])
    return value.detach(), tree_map(lambda _: next(it), live)


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over leaves of Σ x²) in float32, summed in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Scale ``grads`` by ``min(1, max_norm / (norm + 1e-6))``; returns
    ``(clipped, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def compress_grads(grads: Any, mode: str) -> Any:
    """'none' | 'bf16': the gradients, or each cast to bfloat16."""
    if mode == "none":
        return grads
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    raise ValueError(f"unknown gradient compression {mode!r}")


def accumulate_microbatches(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    params: Any,
    batch: Any,
    n_micro: int,
    grad_constraint: Callable[[Any], Any] | None = None,
) -> tuple[torch.Tensor, Any]:
    """Gradient accumulation: the mean loss and mean fp32 gradients over
    ``n_micro`` contiguous chunks of the leading batch axis.

    ``grad_constraint`` maps each microbatch's gradient tree before it is
    added: the mesh step passes its ZeRO-2 reduction, which reduce-scatters
    the gradients over ``data`` into a data-sharded fp32 accumulator (the
    reference's ``with_sharding_constraint``, made explicit), so a
    full-size fp32 accumulator never exists.  With ``n_micro`` <= 1 one
    gradient, constrained the same way."""
    if n_micro <= 1:
        loss, g = value_and_grad(loss_fn, params, batch)
        return loss, grad_constraint(g) if grad_constraint else g

    def chunk(i):
        def cut(x):
            if x.shape[0] % n_micro:
                raise ValueError(f"batch of {x.shape[0]} does not split "
                                 f"into {n_micro} microbatches")
            m = x.shape[0] // n_micro
            return x[i * m:(i + 1) * m]
        return tree_map(cut, batch)

    loss_sum = acc = None
    for i in range(n_micro):
        loss, g = value_and_grad(loss_fn, params, chunk(i))
        if grad_constraint is not None:
            g = grad_constraint(g)
        g = tree_map(lambda x: x.to(torch.float32), g)
        acc = g if acc is None else tree_map(torch.add, acc, g)
        loss = loss.to(torch.float32)
        loss_sum = loss if loss_sum is None else loss_sum + loss
    inv = 1.0 / n_micro
    return loss_sum * inv, tree_map(lambda x: x * inv, acc)
