"""Gradients of a loss over a parameter tree, and global-norm clipping."""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["value_and_grad", "global_norm", "clip_by_global_norm"]


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
