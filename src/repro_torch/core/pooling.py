"""JPEG-domain residual addition and global pooling (paper §4.4, §4.5)."""
from __future__ import annotations

import torch

from repro_torch.core.batchnorm import DC_GAIN

__all__ = ["residual_add", "global_avg_pool_jpeg"]


def residual_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """J(F + G) = J(F) + J(G) — Eq. 25."""
    return a + b


def global_avg_pool_jpeg(coef: torch.Tensor, *,
                         dc_gain: float = DC_GAIN) -> torch.Tensor:
    """``(N, bh, bw, C, 64) -> (N, C)``: channel-wise mean via DC reads."""
    return coef[..., 0].mean(dim=(1, 2)) / dc_gain
