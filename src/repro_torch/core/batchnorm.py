"""Inference-mode batch norm in the JPEG domain (paper §4.3), as a fold.

In the orthonormal-DCT convention ``coef[..., 0] = 8·block_mean``, so an
inference batch norm ``y = x·inv + (β − μ·inv)`` multiplies every
coefficient by ``inv`` and adds ``8·(β − μ·inv)`` to DC only.  Both fold
into the preceding conv: the scale into Ξ's output-channel rows, the shift
as a DC bias carried on the operator.
"""
from __future__ import annotations

import torch

from repro_torch.core import dct as dctlib

__all__ = ["DC_GAIN", "fold_batchnorm"]

DC_GAIN = float(dctlib.BLOCK)  # orthonormal DC coefficient = 8 * mean


def fold_batchnorm(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, *,
                   eps: float = 1e-5, dc_gain: float = DC_GAIN
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(scale (C,), dc_shift (C,))``."""
    inv = gamma / torch.sqrt(var + eps)
    shift = (beta - mean * inv) * dc_gain
    return inv, shift
