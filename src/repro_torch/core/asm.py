"""Approximated Spatial Masking (ASM) ReLU — the paper's §4.2 / Algorithm 2.

A cheap spatial approximation from the lowest ``phi`` frequency bands
gives the mask; the exact reconstruction is masked and re-encoded:

    M  = (F @ R_phi) > 0
    F' = ((F @ R) * M) @ R.T

All functions take ``(..., nf)`` zigzag coefficient tensors in the
orthonormal-DCT convention.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dct as dctlib

__all__ = ["EXACT_PHI", "AsmConstants", "asm_constants", "asm_relu"]

EXACT_PHI = dctlib.NBANDS - 1  # 14: all 15 bands -> exact reconstruction


class AsmConstants(NamedTuple):
    """Precomputed numpy matrices (float64)."""

    recon_phi: np.ndarray  # (bands, 64) truncated reconstruction (mask path)
    recon: np.ndarray      # (bands, 64) exact reconstruction
    recon_t: np.ndarray    # (64, bands) forward DCT back to zigzag coefficients


def asm_constants(phi: int, bands: int = dctlib.NFREQ) -> AsmConstants:
    """Build ASM constants in the orthonormal-DCT convention.

    ``bands`` keeps only the first ``bands`` zigzag coefficients: the
    reconstruction matrices become ``(bands, 64)`` and the forward matrix
    ``(64, bands)``.
    """
    recon = dctlib.reconstruction_matrix().copy()
    recon_phi = dctlib.truncated_reconstruction_matrix(phi).copy()
    recon_t = recon.T.copy()
    if bands < dctlib.NFREQ:
        recon = recon[:bands]
        recon_phi = recon_phi[:bands]
        recon_t = recon_t[:, :bands]
    return AsmConstants(recon_phi, recon, recon_t)


def asm_relu(coef: torch.Tensor, phi: int = EXACT_PHI,
             bands: int = dctlib.NFREQ) -> torch.Tensor:
    """Plain ASM ReLU on ``(..., nf)`` coefficients.

    With ``bands < nf`` the input is sliced to the kept coefficients before
    the three matmuls and the output is zero-padded back to ``nf``.
    """
    nf = coef.shape[-1]
    c = asm_constants(phi, bands=min(bands, nf))
    if bands < nf:
        coef = coef[..., :bands]

    def t(a):
        return torch.as_tensor(a, dtype=coef.dtype, device=coef.device)

    mask = (coef @ t(c.recon_phi)) > 0
    spatial = coef @ t(c.recon)
    out = torch.where(mask, spatial, torch.zeros_like(spatial)) @ t(c.recon_t)
    return torch.nn.functional.pad(out, (0, nf - out.shape[-1]))
