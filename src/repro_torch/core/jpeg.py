"""Pixel blocks in the coefficient layout (paper §3.2: the JPEG transform,
steps 1–4, as a linear map on 8×8 blocks).

Coefficient activations are ``(N, bh, bw, C, 64)``: block-row, block-col,
channel, zigzag coefficient.  The transform itself is one 64×64 operator
per block (``kernels/block_dct.py``: orthonormal DCT and zigzag, divided
by the quantization table in the ``scaled`` convention of the network's
input); this module moves ``(N, C, H, W)`` images to and from blocks in
that layout's order, so the transform's rows land where the network
reads them.
"""
from __future__ import annotations

import torch

from repro_torch.core import dct as dctlib

__all__ = ["block_channels_last", "unblock_channels_last"]


def block_channels_last(img: torch.Tensor,
                        block: int = dctlib.BLOCK) -> torch.Tensor:
    """``(N, C, H, W) -> (N, H/b, W/b, C, b, b)`` (a view)."""
    n, c, h, w = img.shape
    if h % block or w % block:
        raise ValueError(
            f"image ({h}x{w}) not divisible into {block}x{block} blocks")
    img = img.reshape(n, c, h // block, block, w // block, block)
    return img.permute(0, 2, 4, 1, 3, 5)


def unblock_channels_last(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`block_channels_last`."""
    n, bh, bw, c, b1, b2 = blocks.shape
    return blocks.permute(0, 3, 1, 4, 2, 5).reshape(n, c, bh * b1, bw * b2)
