"""Approximated Spatial Masking (ASM) — the paper's §4.2 / Algorithm 2.

ASM applies a piecewise-linear function to transform-domain blocks: a
cheap spatial approximation from the lowest ``phi`` frequency bands
(the least-squares optimal truncation, Theorem 1) is thresholded into
masks, one per linear piece, and each piece acts on the *exact*
reconstruction.  For ReLU that is masking:

    M  = (F @ R_phi) > 0
    F' = ((F @ R) * M) @ R.T

All functions take ``(..., nf)`` zigzag coefficient tensors in the
orthonormal-DCT convention; with a ``qtable`` they take JPEG-scaled
coefficients instead, the quantization diagonals folded into the three
matrices (Eq. 20).  They are plain PyTorch on the tensor's device, as the
reference computes them outside its kernels; the ReLU of the network's
path is ``dispatch.asm_relu`` (the ASM kernel on a CUDA tensor).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dct as dctlib

__all__ = ["EXACT_PHI", "PiecewiseLinear", "RELU", "LEAKY_RELU",
           "approx_spatial", "nonnegative_mask", "asm_relu", "apx_relu",
           "asm_piecewise", "spatial_relu_oracle", "AsmConstants",
           "asm_constants"]

EXACT_PHI = dctlib.NBANDS - 1  # 14: all 15 bands -> exact reconstruction


class PiecewiseLinear(NamedTuple):
    """``f(x) = slope_i * x + intercept_i`` on ``[edges[i], edges[i+1])``;
    ``edges`` holds the ``len(slopes) - 1`` interior breakpoints, in
    increasing order."""

    edges: tuple[float, ...]
    slopes: tuple[float, ...]
    intercepts: tuple[float, ...]


RELU = PiecewiseLinear(edges=(0.0,), slopes=(0.0, 1.0), intercepts=(0.0, 0.0))
LEAKY_RELU = PiecewiseLinear(edges=(0.0,), slopes=(0.01, 1.0),
                             intercepts=(0.0, 0.0))


class AsmConstants(NamedTuple):
    """Precomputed numpy matrices (float64)."""

    recon_phi: np.ndarray  # (bands, 64) truncated reconstruction (mask path)
    recon: np.ndarray      # (bands, 64) exact reconstruction
    recon_t: np.ndarray    # (64, bands) forward DCT back to zigzag coefficients


def asm_constants(phi: int, qtable: np.ndarray | None = None,
                  bands: int = dctlib.NFREQ) -> AsmConstants:
    """Build ASM constants.  A ``qtable`` (the JPEG-scaled convention,
    Eq. 20) folds de-quantization into both reconstruction matrices and
    re-quantization into the forward one.  ``bands`` keeps only the first
    ``bands`` zigzag coefficients: the reconstruction matrices become
    ``(bands, 64)`` and the forward matrix ``(64, bands)``.
    """
    recon = dctlib.reconstruction_matrix().copy()
    recon_phi = dctlib.truncated_reconstruction_matrix(phi).copy()
    recon_t = recon.T.copy()
    if qtable is not None:
        q = np.asarray(qtable, np.float64)
        recon = q[:, None] * recon
        recon_phi = q[:, None] * recon_phi
        recon_t = recon_t / q[None, :]
    if bands < dctlib.NFREQ:
        recon = recon[:bands]
        recon_phi = recon_phi[:bands]
        recon_t = recon_t[:, :bands]
    return AsmConstants(recon_phi, recon, recon_t)


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def approx_spatial(coef: torch.Tensor, phi: int) -> torch.Tensor:
    """Truncated spatial reconstruction ``(..., 64 coef) → (..., 64
    pixel)`` from the bands up to ``phi``."""
    return coef @ _on(dctlib.truncated_reconstruction_matrix(phi), coef)


def nonnegative_mask(coef: torch.Tensor, phi: int) -> torch.Tensor:
    """The paper's ``annm``: approximate nonnegative mask of the block."""
    return approx_spatial(coef, phi) > 0


def asm_relu(coef: torch.Tensor, phi: int = EXACT_PHI,
             qtable: np.ndarray | None = None,
             bands: int = dctlib.NFREQ) -> torch.Tensor:
    """ASM ReLU on ``(..., nf)`` coefficients (Algorithm 2).

    With ``bands < nf`` the input is sliced to the kept coefficients before
    the three matmuls and the output is zero-padded back to ``nf``.
    """
    nf = coef.shape[-1]
    c = asm_constants(phi, qtable, bands=min(bands, nf))
    if bands < nf:
        coef = coef[..., :bands]
    mask = (coef @ _on(c.recon_phi, coef)) > 0
    spatial = coef @ _on(c.recon, coef)
    out = torch.where(mask, spatial, torch.zeros_like(spatial)) \
        @ _on(c.recon_t, coef)
    return torch.nn.functional.pad(out, (0, nf - out.shape[-1]))


def apx_relu(coef: torch.Tensor, phi: int = EXACT_PHI,
             qtable: np.ndarray | None = None) -> torch.Tensor:
    """The APX baseline (paper Fig. 1/4): ReLU applied *to the
    approximation* from ``phi`` bands, re-encoded.  Unlike ASM it does not
    keep the exact pixel values where the mask is right."""
    c = asm_constants(phi, qtable)
    approx = coef @ _on(c.recon_phi, coef)
    return torch.clamp(approx, min=0.0) @ _on(c.recon_t, coef)


def asm_piecewise(coef: torch.Tensor, fn: PiecewiseLinear,
                  phi: int = EXACT_PHI,
                  qtable: np.ndarray | None = None) -> torch.Tensor:
    """General ASM for any piecewise-linear ``fn`` (paper §4.2): piece
    ``i`` contributes ``slope_i · x + intercept_i`` on the exact pixels
    where the ``phi``-band approximation lies in its interval."""
    c = asm_constants(phi, qtable)
    approx = coef @ _on(c.recon_phi, coef)
    spatial = coef @ _on(c.recon, coef)
    edges = (-np.inf,) + tuple(fn.edges) + (np.inf,)
    out = torch.zeros_like(spatial)
    for i, (slope, intercept) in enumerate(zip(fn.slopes, fn.intercepts)):
        mask = (approx >= edges[i]) & (approx < edges[i + 1])
        out = out + torch.where(mask, slope * spatial + intercept,
                                torch.zeros_like(spatial))
    return out @ _on(c.recon_t, coef)


def spatial_relu_oracle(coef: torch.Tensor) -> torch.Tensor:
    """The exact result (decode → ReLU → encode), for error measurement."""
    r = _on(dctlib.reconstruction_matrix(), coef)
    return torch.clamp(coef @ r, min=0.0) @ r.T
