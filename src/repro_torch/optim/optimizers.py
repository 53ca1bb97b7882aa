"""AdamW, SGD with momentum and Lion as functional updates over trees.

``update(grads, state, params, lr)`` returns new trees and never writes
into its arguments.  AdamW keeps float32 master weights in its state and
casts them back to each parameter's dtype.  ``OptState.step`` is a 0-d
int32 tensor on the parameters' device, so an update runs on the device
without a host round trip.  The arithmetic is the reference package's,
operation for operation.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["Optimizer", "OptState", "adamw", "sgd", "lion", "make_optimizer"]


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any  # optimizer-specific trees


class Optimizer(NamedTuple):
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any, torch.Tensor],
                     tuple[Any, OptState]]
    # update(grads, state, params, lr) -> (new_params, new_state)


def _zeros(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _step0(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def _part(like: Any, out: Any, i: int) -> Any:
    """Field ``i`` of the per-leaf tuples of ``out`` (shaped like ``like``)."""
    return tree_map(lambda _, o: o[i], like, out)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with decoupled weight decay and float32 master weights."""

    def init(params):
        master = tree_map(lambda p: p.detach().to(torch.float32).clone(),
                          params)
        return OptState(_step0(params), {"m": _zeros(params),
                                         "v": _zeros(params),
                                         "master": master})

    def update(grads, state, params, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(g, m, v, master):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            new_master = master - lr * (mh / (torch.sqrt(vh) + eps)
                                        + weight_decay * master)
            return m, v, new_master

        out = tree_map(upd, grads, state.inner["m"], state.inner["v"],
                       state.inner["master"])
        new_master = _part(grads, out, 2)
        new_params = tree_map(lambda w, p: w.to(p.dtype), new_master, params)
        return new_params, OptState(step, {"m": _part(grads, out, 0),
                                           "v": _part(grads, out, 1),
                                           "master": new_master})

    return Optimizer(init, update)


def sgd(momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(_step0(params), {"vel": _zeros(params)})

    def update(grads, state, params, lr):
        def upd(g, v, p):
            g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
            v = momentum * v + g
            d = g + momentum * v if nesterov else v
            return v, (p.to(torch.float32) - lr * d).to(p.dtype)

        out = tree_map(upd, grads, state.inner["vel"], params)
        return _part(grads, out, 1), OptState(
            state.step + 1, {"vel": _part(grads, out, 0)})

    return Optimizer(init, update)


def lion(b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.1) -> Optimizer:
    """Lion (EvoLved Sign Momentum): sign updates, one state tree."""

    def init(params):
        return OptState(_step0(params), {"m": _zeros(params)})

    def update(grads, state, params, lr):
        def upd(g, m, p):
            g = g.to(torch.float32)
            pf = p.to(torch.float32)
            d = torch.sign(b1 * m + (1 - b1) * g)
            new_p = pf - lr * (d + weight_decay * pf)
            return b2 * m + (1 - b2) * g, new_p.to(p.dtype)

        out = tree_map(upd, grads, state.inner["m"], params)
        return _part(grads, out, 1), OptState(
            state.step + 1, {"m": _part(grads, out, 0)})

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "sgd":
        return sgd(**{k: v for k, v in kw.items()
                      if k in ("momentum", "nesterov", "weight_decay")})
    if name == "lion":
        return lion(**{k: v for k, v in kw.items()
                       if k in ("b1", "b2", "weight_decay")})
    raise ValueError(f"unknown optimizer {name!r}")
