"""Convolution explosion — the paper's §4.1, over a translation-invariant basis.

Away from the borders the JPEG-domain operator Ξ = J ∘ C ∘ J̃ depends only
on the relative block offset, and with centred zero padding the border
cases are the interior operator with missing neighbours reading zero.  So
Ξ is assembled from a precomputed separable basis (numpy, built once):

    Ξ[dy, dx, i, k, o, k'] = Σ_uv K[o, i, u, v] · basis[u, v, dy, dx, k, k']

and :func:`apply_exploded` is ``ndy·ndx`` dense ``(Cin·b) → (Cout·b')``
matmuls per block.  Wide layers whose Ξ would exceed
:data:`MATERIALIZE_LIMIT` elements run factored instead
(:func:`_jpeg_conv_factored`: decode → spatial conv → encode).

Layouts: coefficients ``(N, bh, bw, C, 64)``; filters ``(Cout, Cin, r, r)``
with odd ``r``.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dct as dctlib
from repro_torch.core import jpeg as jpeglib

__all__ = ["block_offsets", "explosion_basis", "explode", "apply_exploded",
           "pad_bands", "operator_elems", "spatial_conv", "MATERIALIZE_LIMIT"]

# Above this operator size (elements of Ξ) the conv goes factored.  The same
# value and the same environment override as the reference package, so both
# packages pick the same schedule.
MATERIALIZE_LIMIT = int(os.environ.get("JPEG_CONV_MATERIALIZE_LIMIT",
                                       64 * 1024 * 1024))


def block_offsets(stride: int, r: int,
                  block: int = dctlib.BLOCK) -> tuple[int, int]:
    """Range ``[d_min, d_max]`` of relative input-block offsets per axis."""
    if r % 2 != 1:
        raise ValueError("only odd receptive fields supported")
    pad = (r - 1) // 2
    d_min = (0 * stride - pad) // block  # floor division
    d_max = ((block - 1) * stride + pad) // block
    return d_min, d_max


@functools.lru_cache(maxsize=None)
def _basis_1d(stride: int, r: int, block: int = dctlib.BLOCK) -> np.ndarray:
    """1-D explosion basis ``(r, nd, block, block)``: tap ``u`` maps input
    frequency ``a`` of the block at offset ``d + d_min`` to output
    frequency ``a'`` for ``out[m'] = in[stride·m' + u - pad]``."""
    d = dctlib.dct_matrix(block)
    pad = (r - 1) // 2
    d_min, d_max = block_offsets(stride, r, block)
    nd = d_max - d_min + 1
    out = np.zeros((r, nd, block, block))
    for u in range(r):
        t = u - pad
        for mp in range(block):
            src = stride * mp + t
            blk, pos = src // block, src % block
            out[u, blk - d_min] += np.einsum("a,b->ab", d[:, pos], d[:, mp])
    return out


@functools.lru_cache(maxsize=None)
def explosion_basis(stride: int, r: int, quality: int = 50,
                    in_scaled: bool = False, out_scaled: bool = False,
                    bands: int = dctlib.NFREQ) -> np.ndarray:
    """2-D explosion basis ``(r, r, ndy, ndx, bands, bands)`` in zigzag
    order; ``in_scaled``/``out_scaled`` fold the de-/re-quantization
    diagonals; ``bands`` keeps the first zigzag coefficients on both sides."""
    if not 1 <= bands <= dctlib.NFREQ:
        raise ValueError(f"bands must be in [1, {dctlib.NFREQ}], got {bands}")
    b1 = _basis_1d(stride, r)
    b = dctlib.BLOCK
    full = np.einsum("udaA,vxcC->uvdxacAC", b1, b1)
    r_, nd = b1.shape[0], b1.shape[1]
    full = full.reshape(r_, r_, nd, nd, b * b, b * b)
    zz = dctlib.zigzag_permutation()
    full = full[..., zz, :][..., zz]
    full = full[..., :bands, :bands]
    q = dctlib.quantization_table(quality)
    if in_scaled:
        full = full * q[:bands, None]
    if out_scaled:
        full = full / q[None, :bands]
    return np.ascontiguousarray(full)


def explode(kernel: torch.Tensor, stride: int = 1, *, quality: int = 50,
            in_scaled: bool = False, out_scaled: bool = False,
            bands: int = dctlib.NFREQ) -> torch.Tensor:
    """Exploded operator ``(ndy, ndx, Cin, bands, Cout, bands)``, on the
    kernel's device and in its dtype."""
    r = kernel.shape[-1]
    basis = torch.as_tensor(
        explosion_basis(stride, r, quality, in_scaled, out_scaled, bands),
        dtype=kernel.dtype, device=kernel.device)
    return torch.einsum("oiuv,uvyxkl->yxikol", kernel, basis)


def pad_bands(coef: torch.Tensor, nf: int = dctlib.NFREQ) -> torch.Tensor:
    """Zero-pad the trailing coefficient axis back up to ``nf`` entries."""
    have = coef.shape[-1]
    if have == nf:
        return coef
    return F.pad(coef, (0, nf - have))


def operator_elems(kernel_shape, stride: int,
                   bands: int = dctlib.NFREQ) -> int:
    """Element count of the materialised Ξ for a (Cout, Cin, r, r) kernel —
    the quantity compared against :data:`MATERIALIZE_LIMIT`."""
    cout, cin, r = kernel_shape[0], kernel_shape[1], kernel_shape[-1]
    d_min, d_max = block_offsets(stride, r)
    nd = d_max - d_min + 1
    return nd * nd * cin * cout * bands * bands


def _offsets_from(nd: int, stride: int) -> tuple[int, int]:
    """Recover ``(d_min, d_max)`` from the basis offset count: ``d_min = -1``
    iff the filter pads; the only ``nd > 1`` case without padding is the
    1×1 stride-2 projection, whose offsets are {0, 1}."""
    if nd == 1:
        return 0, 0
    if stride == 2 and nd == 2:
        return 0, 1
    return -1, nd - 2


def apply_exploded(coef: torch.Tensor, xi: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Apply Ξ to ``(N, bh, bw, Cin, ≥bands)`` coefficients (plain torch):

    ``out[n, y, x, o, k'] = Σ coef[n, s·y+dy, s·x+dx, i, k]·xi[dy, dx, i, k, o, k']``

    with zero padding outside the block grid.  The input is sliced to Ξ's
    ``nf_in`` lanes; the output has Ξ's ``nf_out`` lanes.
    """
    ndy, ndx = xi.shape[0], xi.shape[1]
    nf_in = xi.shape[3]
    if coef.shape[-1] > nf_in:
        coef = coef[..., :nf_in]
    n, bh, bw, cin, nf = coef.shape
    d_min_y, _ = _offsets_from(ndy, stride)
    d_min_x, _ = _offsets_from(ndx, stride)
    bh_out, bw_out = bh // stride, bw // stride
    padded = F.pad(coef, (0, 0, 0, 0, -d_min_x, ndx - 1 + d_min_x,
                          -d_min_y, ndy - 1 + d_min_y))
    out = None
    for iy in range(ndy):
        for ix in range(ndx):
            sl = padded[:, iy: iy + stride * bh_out: stride,
                        ix: ix + stride * bw_out: stride]
            term = torch.einsum("nxyik,ikol->nxyol", sl, xi[iy, ix])
            out = term if out is None else out + term
    return out


def spatial_conv(img: torch.Tensor, kernel: torch.Tensor,
                 stride: int = 1) -> torch.Tensor:
    """Centred zero-padded spatial conv (``padding=r//2``), NCHW/OIHW."""
    return F.conv2d(img, kernel, stride=stride,
                    padding=(kernel.shape[-1] - 1) // 2)


def _jpeg_conv_factored(coef: torch.Tensor, kernel: torch.Tensor, stride: int,
                        *, quality: int, in_scaled: bool, out_scaled: bool,
                        bands: int = dctlib.NFREQ) -> torch.Tensor:
    """Ξ = J ∘ C ∘ J̃ applied as its factors (exact, never forms Ξ).

    ``(N, bh, bw, Cin, 64) -> (N, bh/s, bw/s, Cout, 64)``; ``bands`` zeroes
    the coefficients above the cutoff on both sides.
    """
    if bands < coef.shape[-1]:
        coef = pad_bands(coef[..., :bands])
    img = jpeglib.jpeg_decode(torch.movedim(coef, 3, 1), scaled=in_scaled,
                              quality=quality)
    out = spatial_conv(img, kernel, stride)
    enc = jpeglib.jpeg_encode(out, scaled=out_scaled, quality=quality)
    enc = torch.movedim(enc, 1, 3)
    if bands < enc.shape[-1]:
        enc = pad_bands(enc[..., :bands])
    return enc
