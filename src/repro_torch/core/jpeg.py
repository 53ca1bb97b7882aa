"""The JPEG transform as a linear map (paper §3.2: steps 1–4 on 8×8 blocks).

The transform itself is one 64×64 operator per block
(``kernels/block_dct.py``: orthonormal DCT and zigzag, divided by the
quantization table in the ``scaled`` convention of the network's input),
applied by ``dispatch.block_dct`` / ``block_idct``: the block-transform
kernel on a CUDA tensor, its plain version on a CPU one.

Layouts
-------
* The network's coefficient activations are ``(N, bh, bw, C, 64)``:
  block-row, block-col, channel, zigzag coefficient.
  :func:`block_channels_last` moves ``(N, C, H, W)`` images to and from
  blocks in that layout's order.
* The paper's functions take spatial images ``(..., H, W)`` to
  ``(..., H/8, W/8, 64)``, the leading axes untouched (:func:`jpeg_encode`,
  :func:`jpeg_decode`; :func:`block_image` is the paper's B tensor).

Conventions: ``scaled=True`` are true step-4 coefficients (divided by the
quantization table of ``quality``, or by a caller's ``qtable``);
``scaled=False`` the orthonormal DCT.  Step 5's rounding lives only in
:func:`jpeg_round_trip_lossy` (and in ``repro_torch.codec``).

:func:`jpeg_tensor` / :func:`ijpeg_tensor` build the paper's J and J̃
explicitly (numpy, O((HW)²)): for tests and for Algorithm 1
(``core.conv.explode_full``) on small images.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dct as dctlib

__all__ = ["block_channels_last", "unblock_channels_last", "block_image",
           "unblock_image", "jpeg_encode", "jpeg_decode",
           "jpeg_round_trip_lossy", "jpeg_tensor", "ijpeg_tensor"]


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


def block_image(img: torch.Tensor, block: int = dctlib.BLOCK) -> torch.Tensor:
    """``(..., H, W) -> (..., H/b, W/b, b, b)`` — the paper's B tensor (a
    view)."""
    *lead, h, w = img.shape
    if h % block or w % block:
        raise ValueError(
            f"image ({h}x{w}) not divisible into {block}x{block} blocks")
    img = img.reshape(*lead, h // block, block, w // block, block)
    return img.movedim(-3, -2)


def unblock_image(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`block_image`."""
    *lead, bh, bw, b1, b2 = blocks.shape
    return blocks.movedim(-2, -3).reshape(*lead, bh * b1, bw * b2)


def _table(scaled: bool, quality: int, qtable: np.ndarray | None,
           like: torch.Tensor) -> tuple[int | None, torch.Tensor | None]:
    """The block transform's ``quality`` and the caller's table to apply
    beside it: a ``qtable`` runs the orthonormal transform and is divided
    out (or multiplied in) as a tensor; a ``quality`` is folded into the
    transform's operator."""
    if not scaled:
        return None, None
    if qtable is None:
        return quality, None
    return None, torch.as_tensor(np.asarray(qtable, np.float64),
                                 dtype=like.dtype, device=like.device)


def jpeg_encode(img: torch.Tensor, *, quality: int = 50, scaled: bool = True,
                qtable: np.ndarray | None = None) -> torch.Tensor:
    """Steps 1–4 of JPEG encoding: ``(..., H, W) -> (..., H/8, W/8, 64)``."""
    from repro_torch.core import dispatch as dsp

    q, table = _table(scaled, quality, qtable, img)
    coef = dsp.block_dct(block_image(img), q)
    return coef if table is None else coef / table


def jpeg_decode(coef: torch.Tensor, *, quality: int = 50, scaled: bool = True,
                qtable: np.ndarray | None = None) -> torch.Tensor:
    """Inverse of :func:`jpeg_encode` (no rounding — exact inverse)."""
    from repro_torch.core import dispatch as dsp

    q, table = _table(scaled, quality, qtable, coef)
    if table is not None:
        coef = coef * table
    return unblock_image(dsp.block_idct(coef, q))


def jpeg_round_trip_lossy(img: torch.Tensor, *,
                          quality: int = 50) -> torch.Tensor:
    """Lossy JPEG round trip with step 5's rounding (half to even, as
    ``jnp.round``) — for data simulation."""
    coef = jpeg_encode(img, quality=quality, scaled=True)
    return jpeg_decode(torch.round(coef), quality=quality, scaled=True)


# --------------------------------------------------------------------------
# Explicit J / J~ tensors (numpy float64; tests and Algorithm 1, small images)
# --------------------------------------------------------------------------


def jpeg_tensor(h: int, w: int, *, quality: int = 50,
                scaled: bool = True) -> np.ndarray:
    """The paper's ``J`` (Eq. 8) as ``(h, w, h/8, w/8, 64)``: pixels →
    coefficients."""
    b = dctlib.BLOCK
    fwd = dctlib.reconstruction_matrix().T.copy()  # (pixel, zigzag coef)
    if scaled:
        fwd = fwd / dctlib.quantization_table(quality)[None, :]
    j = np.zeros((h, w, h // b, w // b, b * b))
    for x in range(h // b):
        for y in range(w // b):
            for m in range(b):
                for n in range(b):
                    j[x * b + m, y * b + n, x, y, :] = fwd[m * b + n]
    return j


def ijpeg_tensor(h: int, w: int, *, quality: int = 50,
                 scaled: bool = True) -> np.ndarray:
    """The paper's ``J̃`` (Eq. 10) as ``(h/8, w/8, 64, h, w)``: coefficients
    → pixels."""
    b = dctlib.BLOCK
    rec = dctlib.reconstruction_matrix()  # (zigzag coef, pixel)
    if scaled:
        rec = rec * dctlib.quantization_table(quality)[:, None]
    blk = rec.reshape(b * b, b, b)
    jt = np.zeros((h // b, w // b, b * b, h, w))
    for x in range(h // b):
        for y in range(w // b):
            jt[x, y, :, x * b:(x + 1) * b, y * b:(y + 1) * b] = blk
    return jt
