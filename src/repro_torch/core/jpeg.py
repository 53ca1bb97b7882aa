"""The JPEG transform as a linear map (paper §3.2): steps 1–4 of encoding.

Spatial images are ``(..., H, W)``; their transform-domain representation
is ``(..., H/8, W/8, 64)`` — block-row, block-col, zigzag coefficient.
``scaled=True`` divides by the quantization table (the network's input
convention); ``scaled=False`` is the plain orthonormal DCT.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dct as dctlib

__all__ = ["block_image", "unblock_image", "jpeg_encode", "jpeg_decode"]


def block_image(img: torch.Tensor, block: int = dctlib.BLOCK) -> torch.Tensor:
    """``(..., H, W) -> (..., H/b, W/b, b, b)``."""
    *lead, h, w = img.shape
    if h % block or w % block:
        raise ValueError(
            f"image ({h}x{w}) not divisible into {block}x{block} blocks")
    img = img.reshape(*lead, h // block, block, w // block, block)
    return torch.movedim(img, -3, -2)


def unblock_image(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`block_image`."""
    *lead, bh, bw, b1, b2 = blocks.shape
    blocks = torch.movedim(blocks, -2, -3)
    return blocks.reshape(*lead, bh * b1, bw * b2)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def jpeg_encode(img: torch.Tensor, *, quality: int = 50, scaled: bool = True,
                qtable: np.ndarray | None = None) -> torch.Tensor:
    """``(..., H, W) -> (..., H/8, W/8, 64)`` zigzag coefficients."""
    d = _const(dctlib.dct_matrix(), img)
    zz = torch.as_tensor(dctlib.zigzag_permutation().astype(np.int64),
                         device=img.device)
    coef = torch.einsum("am,...mn,bn->...ab", d, block_image(img), d)
    coef = coef.reshape(*coef.shape[:-2], dctlib.NFREQ)[..., zz]
    if scaled:
        q = qtable if qtable is not None else dctlib.quantization_table(quality)
        coef = coef / _const(q, coef)
    return coef


def jpeg_decode(coef: torch.Tensor, *, quality: int = 50, scaled: bool = True,
                qtable: np.ndarray | None = None) -> torch.Tensor:
    """Inverse of :func:`jpeg_encode` (no rounding — exact inverse)."""
    if scaled:
        q = qtable if qtable is not None else dctlib.quantization_table(quality)
        coef = coef * _const(q, coef)
    inv_zz = torch.as_tensor(np.argsort(dctlib.zigzag_permutation()),
                             device=coef.device)
    coef = coef[..., inv_zz]
    coef = coef.reshape(*coef.shape[:-1], dctlib.BLOCK, dctlib.BLOCK)
    d = _const(dctlib.dct_matrix(), coef)
    return unblock_image(torch.einsum("am,...ab,bn->...mn", d, coef, d))
