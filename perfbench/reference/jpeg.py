"""JPEG constants and 8x8 block transforms for the plain reference.

Written from the standard (ISO/IEC 10918-1: the Annex K.1 luminance table,
the IJG quality scaling, the zigzag scan, the orthonormal 8x8 DCT-II) and
from nothing of the program under test.  Coefficients are ``(..., 64)`` in
zigzag order; images are ``(N, C, H, W)``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK = 8
NFREQ = 64

#: ISO/IEC 10918-1 Annex K.1 luminance quantization table (quality 50)
LUMA_Q50 = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def zigzag() -> np.ndarray:
    """``(64,)``: zigzag index -> row-major index in the 8x8 block."""
    cells = [(r, c) for r in range(BLOCK) for c in range(BLOCK)]
    # even anti-diagonals run up and to the right, odd ones down and left
    cells.sort(key=lambda rc: (rc[0] + rc[1],
                               rc[1] if (rc[0] + rc[1]) % 2 == 0 else rc[0]))
    return np.array([r * BLOCK + c for r, c in cells], np.int64)


def ijg_table(quality: int) -> np.ndarray:
    """The IJG-scaled luminance table at ``quality``, zigzag ``(64,)``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    t = np.clip(np.floor((LUMA_Q50 * scale + 50.0) / 100.0), 1.0, 255.0)
    return t.reshape(-1)[zigzag()]


def canonical_table(quality: int = 50) -> np.ndarray:
    """The network's input convention: the IJG table with DC forced to 8,
    so a quantized DC holds the block's mean pixel (paper §4.3)."""
    t = ijg_table(quality).copy()
    t[0] = 8.0
    return t


@functools.lru_cache(maxsize=None)
def dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II ``D`` (8, 8): a block's coefficients are
    ``D @ X @ D.T``."""
    a = np.arange(BLOCK)[:, None]
    m = np.arange(BLOCK)[None, :]
    d = np.cos((2 * m + 1) * a * np.pi / (2 * BLOCK)) * np.sqrt(2.0 / BLOCK)
    d[0] = np.sqrt(1.0 / BLOCK)
    return d


@functools.lru_cache(maxsize=None)
def basis() -> np.ndarray:
    """``R`` (64 zigzag coefficients, 64 row-major pixels): pixels =
    coefficients @ R, coefficients = pixels @ R.T (R is orthonormal)."""
    d = dct_matrix()
    full = np.einsum("am,bn->abmn", d, d).reshape(NFREQ, NFREQ)
    return full[zigzag()]


@functools.lru_cache(maxsize=None)
def band_projector(bands: int) -> np.ndarray:
    """``(64, 64)`` projection of row-major block pixels onto the span of
    the first ``bands`` zigzag basis images."""
    r = basis()[:bands]
    return r.T @ r


def to_blocks(x: torch.Tensor) -> torch.Tensor:
    """``(N, C, H, W)`` -> ``(N, H/8, W/8, C, 64)`` row-major block pixels."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // BLOCK, BLOCK, w // BLOCK, BLOCK)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(n, h // BLOCK, w // BLOCK, c,
                                                NFREQ)


def from_blocks(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_blocks`."""
    n, bh, bw, c, _ = b.shape
    x = b.reshape(n, bh, bw, c, BLOCK, BLOCK).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, c, bh * BLOCK, bw * BLOCK)


def const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)
