"""Pipeline parallelism: a microbatch schedule over a ``stage`` mesh axis.

A port of ``repro/parallel/pipeline.py``: the GPipe fill/steady/drain
schedule.  Every rank of the ``stage`` axis holds one stage's parameters;
activations hop stage → stage + 1 each tick, point to point on the stage
group; ``n_micro + n_stages - 1`` ticks in all.  Bubble fraction
(S - 1) / (M + S - 1), reported by :func:`bubble_fraction`.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.parallel import collectives as C
from repro_torch.tree import tree_map

__all__ = ["pipelined_apply", "bubble_fraction", "stack_stage_params"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stack_stage_params(per_stage: list[Any]) -> Any:
    """Stack per-stage parameter trees along a leading stage axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *per_stage)


def pipelined_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    stage_params: Any, microbatches: torch.Tensor, mesh,
                    axis: str = "stage") -> torch.Tensor:
    """Run ``y_mb = stage_{S-1}(... stage_0(x_mb))`` for every microbatch.

    ``stage_params``: this rank's slice of the stacked stage parameters (a
    leading stage axis of 1, as ``local_slice`` of :func:`
    stack_stage_params` under ``P(axis)`` gives it); ``microbatches``:
    ``(n_micro, mb, ...)``, the same on every rank (only stage 0 reads
    them).  Tick ``t``: stage 0 takes microbatch ``t`` (clipped), every
    other stage its carry; the result goes to stage + 1; the last stage
    records microbatch ``t - (S - 1)``.  Returns ``(n_micro, mb, ...)``,
    broadcast from the last stage to every rank of ``axis``.  Forward
    only: the carries leave autograd."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    n_micro = microbatches.shape[0]
    stage_id = mesh.get_local_rank(axis)
    params = tree_map(lambda x: x[0], stage_params)
    carry = torch.zeros_like(microbatches[0])
    outputs = torch.zeros_like(microbatches)
    for t in range(n_micro + n_stages - 1):
        x_in = microbatches[min(max(t, 0), n_micro - 1)] if stage_id == 0 \
            else carry
        y = stage_fn(params, x_in)
        if stage_id == n_stages - 1 and t >= n_stages - 1:
            outputs[t - (n_stages - 1)] = y
        carry = C.shift(y, mesh, axis, "pipeline_send")
    return C.broadcast(outputs, mesh, axis, n_stages - 1)
