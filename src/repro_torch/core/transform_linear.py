"""Transform-domain linear folding beyond the paper's CNN.

The paper's precondition is a fixed invertible linear codec ``T`` in front
of a learned linear layer ``W``: then ``W ∘ T⁻¹`` is one matrix and the
layer reads codec coefficients directly.  :func:`fold_patch_embed` folds
JPEG decoding into a ViT patch embedding (patch a multiple of 8; exact);
:func:`fold_frontend` folds any orthonormal analysis map into the layer
after it.  Both return tensors to use as drop-in weights.
:func:`coefficient_patches` lays an image batch's block-DCT coefficients
(the ``block_dct`` kernel on a CUDA tensor) out per patch, the input
:func:`fold_patch_embed`'s weight reads.
"""
from __future__ import annotations

import torch

from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import jpeg as jpeglib

__all__ = ["fold_patch_embed", "unfold_patches_to_blocks", "fold_frontend",
           "coefficient_patches"]


def fold_frontend(analysis: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """Fold ``y = W (A⁻¹ c)`` into one matrix for an orthonormal ``A``.

    ``analysis``: ``(n, n)``, rows the basis functions; ``weight``:
    ``(n, d)`` acting on raw samples.  Returns the ``(n, d)`` weight acting
    on coefficients, ``A @ weight`` (``A⁻ᵀ = A``).
    """
    return analysis @ weight


def fold_patch_embed(weight: torch.Tensor, patch: int, channels: int, *,
                     quality: int = 50, scaled: bool = True) -> torch.Tensor:
    """Fold JPEG decoding into a ViT patch-embed projection.

    ``weight``: ``(patch·patch·channels, d)`` acting on row-major
    ``(C, P, P)`` pixel patches.  Returns the weight of the same shape
    acting on the patch's coefficients laid out ``(C, P/8, P/8, 64)``
    (zigzag, divided by ``quality``'s table when ``scaled``): per 8×8
    block the reconstruction matrix, de-quantized when ``scaled``.
    """
    b = dctlib.BLOCK
    if patch % b:
        raise ValueError("patch size must be a multiple of 8")
    g = patch // b
    d = weight.shape[-1]
    rec = dctlib.reconstruction_matrix()  # (64 coef, 64 pixel)
    if scaled:
        rec = dctlib.quantization_table(quality)[:, None] * rec
    rec = torch.as_tensor(rec, dtype=weight.dtype, device=weight.device)
    w = weight.reshape(channels, g, b, g, b, d)
    w = w.movedim(2, 3).reshape(channels, g, g, b * b, d)
    w = torch.einsum("kp,cxypd->cxykd", rec, w)
    return w.reshape(channels * g * g * b * b, d)


def unfold_patches_to_blocks(images: torch.Tensor,
                             patch: int) -> torch.Tensor:
    """``(N, C, H, W)`` → ``(N, n_patches, C·P·P)`` row-major patches."""
    n, c, h, w = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(n, c, gh, patch, gw, patch)
    x = x.movedim(4, 3)  # (n, c, gh, gw, P, P)
    x = x.movedim(1, 3)  # (n, gh, gw, c, P, P)
    return x.reshape(n, gh * gw, c * patch * patch)


def coefficient_patches(images: torch.Tensor, patch: int,
                        quality: int = 50) -> torch.Tensor:
    """``(N, C, H, W)`` pixels → ``(N, n_patches, C·(P/8)²·64)``: each
    8×8 block's zigzag DCT coefficients, divided by ``quality``'s table
    (``core.dispatch.block_dct``: the kernel on a CUDA tensor), laid out
    per patch as ``(C, P/8, P/8, 64)`` in row-major patch order."""
    coef = dsp.block_dct(jpeglib.block_channels_last(images), quality)
    n, bh, bw, c, nf = coef.shape
    pb = patch // dctlib.BLOCK
    x = coef.reshape(n, bh // pb, pb, bw // pb, pb, c, nf)
    x = x.permute(0, 1, 3, 5, 2, 4, 6)  # (n, gh, gw, c, pb, pb, 64)
    return x.reshape(n, (bh // pb) * (bw // pb), c * pb * pb * nf)
