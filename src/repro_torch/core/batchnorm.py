"""Batch norm in the JPEG domain (paper §4.3 / Algorithm 3), and its fold.

Coefficient activations are ``(N, bh, bw, C, 64)`` in the orthonormal-DCT
convention, where for each block ``coef[..., 0] = 8·block_mean`` and
``mean_k(coef[..., k]²) = E[x²]`` over its 64 pixels (Parseval).  So the
per-channel statistics are coefficient reductions, centering touches DC
only, and scaling is a scalar multiply.

An inference batch norm ``y = x·inv + (β − μ·inv)`` multiplies every
coefficient by ``inv`` and adds ``8·(β − μ·inv)`` to DC only; both fold
into the preceding conv (:func:`fold_batchnorm`): the scale into Ξ's
output-channel rows, the shift as a DC bias carried on the operator.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import dct as dctlib

__all__ = ["DC_GAIN", "BatchNormParams", "BatchNormState", "init_batchnorm",
           "batchnorm_jpeg", "batchnorm_spatial", "fold_batchnorm"]

DC_GAIN = float(dctlib.BLOCK)  # orthonormal DC coefficient = 8 * mean


class BatchNormParams(NamedTuple):
    gamma: torch.Tensor  # (C,)
    beta: torch.Tensor   # (C,)


class BatchNormState(NamedTuple):
    running_mean: torch.Tensor  # (C,)
    running_var: torch.Tensor   # (C,)


def init_batchnorm(channels: int, dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cpu"
                   ) -> tuple[BatchNormParams, BatchNormState]:
    """Identity batch norm: γ = 1, β = 0, running mean 0 and variance 1."""
    def full(v):
        return torch.full((channels,), v, dtype=dtype, device=device)

    return (BatchNormParams(full(1.0), full(0.0)),
            BatchNormState(full(0.0), full(1.0)))


def _update(state: BatchNormState, mu: torch.Tensor, var: torch.Tensor,
            momentum: float) -> BatchNormState:
    return BatchNormState(
        (1 - momentum) * state.running_mean + momentum * mu,
        (1 - momentum) * state.running_var + momentum * var)


def _batch_mean():
    """The batch mean: over this process's rows, or under mesh rules over
    every rank's rows of the batch axes (``collectives.batch_mean``: the
    global batch's statistics, as the reference's SPMD computes them)."""
    from repro_torch.parallel.sharding import active_rules

    if active_rules() is None:
        return lambda x, dims: x.mean(dim=dims)
    from repro_torch.parallel.collectives import batch_mean

    return batch_mean


def batchnorm_jpeg(coef: torch.Tensor, params: BatchNormParams,
                   state: BatchNormState, *, training: bool,
                   momentum: float = 0.1, eps: float = 1e-5,
                   dc_gain: float = DC_GAIN
                   ) -> tuple[torch.Tensor, BatchNormState]:
    """Batch norm over ``(N, bh, bw, C, 64)`` coefficients → ``(out,
    new_state)``; in training the batch statistics normalise and the
    running ones move by ``momentum``."""
    if training:
        mean = _batch_mean()
        mu = mean(coef[..., 0] / dc_gain, (0, 1, 2))
        second = mean((coef * coef).mean(dim=-1), (0, 1, 2))
        var = second - mu * mu
        new_state = _update(state, mu, var, momentum)
    else:
        mu, var = state.running_mean, state.running_var
        new_state = state
    inv = params.gamma / torch.sqrt(var + eps)
    shift = (params.beta - mu * inv) * dc_gain
    out = coef * inv[None, None, None, :, None]
    out[..., 0] += shift
    return out, new_state


def batchnorm_spatial(x: torch.Tensor, params: BatchNormParams,
                      state: BatchNormState, *, training: bool,
                      momentum: float = 0.1, eps: float = 1e-5
                      ) -> tuple[torch.Tensor, BatchNormState]:
    """Spatial-domain batch norm over ``(N, C, H, W)`` — the oracle twin."""
    if training:
        mu = x.mean(dim=(0, 2, 3))
        var = (x * x).mean(dim=(0, 2, 3)) - mu * mu
        new_state = _update(state, mu, var, momentum)
    else:
        mu, var = state.running_mean, state.running_var
        new_state = state
    inv = params.gamma / torch.sqrt(var + eps)
    out = (x - mu[None, :, None, None]) * inv[None, :, None, None]
    return out + params.beta[None, :, None, None], new_state


def fold_batchnorm(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, *,
                   eps: float = 1e-5, dc_gain: float = DC_GAIN
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference batch norm as ``(scale (C,), dc_shift (C,))``."""
    inv = gamma / torch.sqrt(var + eps)
    shift = (beta - mean * inv) * dc_gain
    return inv, shift
