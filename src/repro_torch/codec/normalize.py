"""Per-image quantization normalization: file coefficients → plan convention.

One compiled plan serves mixed-quality traffic because every decoded image
is **exactly linearly rescaled** into the plan's canonical coefficient
convention before it touches the network (no spatial decode, no rounding):

* the file's quantized integers are multiplied by the file's own DQT
  vector (de-quantization — still zigzag, still per component);
* pixels are mapped from JPEG's level-shifted ``[-128, 128)`` to the
  network's ``[-1, 1)`` (a ``1/128`` scale, which commutes with the DCT);
* the result is divided by the plan's canonical quantization table
  (``core.dct.quantization_table(spec.quality)``, the convention of
  ``kernels.block_dct.block_dct(blocks, quality)``).

Net effect per zigzag index ``k`` (non-subsampled components):
``coef[k] · q_file[k] / (128 · q_canon[k])`` — one multiply per
coefficient, exact in float64 and then cast.  Subsampled components
de-quantize first, upsample in the plain DCT basis, and apply the
canonical divide last — the upsample map mixes zigzag indices, so the
per-index rescales must bracket it, not precede it.

Chroma subsampling is undone **in the coefficient domain**: replicating a
pixel ``f×`` is linear, so the DCT coefficients of each upsampled output
block are an exact 64×64 linear map of the source block's coefficients
(:func:`upsample_matrices`; one matrix per output quadrant, precomputed).
The result equals spatial nearest-neighbour upsampling exactly — again no
pixels are materialised.

Finally :func:`fit_grid` pads (zero blocks — mid-gray after the level
shift) or center-crops the block grid to the plan's expected input.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core import dct as dctlib
from repro_torch.codec.bitstream import DecodedJpeg

__all__ = [
    "PIXEL_SCALE",
    "canonical_qtable",
    "rescale_component",
    "upsample_matrices",
    "upsample_coefficients",
    "fit_grid",
    "normalize_image",
]

#: pixel-range scale between JPEG's level-shifted samples and the
#: network's ~[-1, 1) convention: x = (p - 128) / 128.
PIXEL_SCALE = 128.0


def canonical_qtable(quality: int) -> np.ndarray:
    """The plan's zigzag quantization vector (``dc_is_mean`` convention)."""
    return dctlib.quantization_table(quality)


def rescale_component(coef: np.ndarray, q_file: np.ndarray, *,
                      quality: int) -> np.ndarray:
    """Exact linear rescale of one component's quantized integers into the
    canonical ``scaled=True`` convention: ``coef · q_file / (128 · q_canon)``.
    """
    q_file = np.asarray(q_file, np.float64).reshape(dctlib.NFREQ)
    gain = q_file / (PIXEL_SCALE * canonical_qtable(quality))
    return (np.asarray(coef, np.float64) * gain).astype(np.float32)


@functools.lru_cache(maxsize=None)
def upsample_matrices(fy: int, fx: int) -> np.ndarray:
    """Coefficient-domain replication upsampling operators.

    ``out[qy, qx]`` is the 64×64 (zigzag→zigzag) map taking one source
    block's coefficients to the coefficients of output quadrant
    ``(qy, qx)`` of its ``fy × fx`` pixel-replicated expansion:
    ``M = R @ S @ Rᵀ`` with ``R`` the orthonormal zigzag reconstruction
    matrix and ``S`` the pixel-selection matrix of the quadrant.  Exact —
    replication is linear, and ``R`` is orthonormal.
    """
    b = dctlib.BLOCK
    rec = dctlib.reconstruction_matrix()  # (64 coef, 64 flat pixel)
    mats = np.zeros((fy, fx, dctlib.NFREQ, dctlib.NFREQ))
    for qy in range(fy):
        for qx in range(fx):
            sel = np.zeros((dctlib.NFREQ, dctlib.NFREQ))
            for m in range(b):
                for n in range(b):
                    sm = (qy * b + m) // fy
                    sn = (qx * b + n) // fx
                    sel[m * b + n, sm * b + sn] = 1.0
            mats[qy, qx] = rec @ sel @ rec.T
    return mats


def upsample_coefficients(coef: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """``(by, bx, 64) → (by·fy, bx·fx, 64)`` coefficient-domain replication
    upsample (chroma to the luma block grid) — no pixels materialised."""
    if fy == 1 and fx == 1:
        return coef
    mats = upsample_matrices(fy, fx)  # (fy, fx, 64out, 64in)
    by, bx, _ = coef.shape
    # out[y, qy, x, qx, j] = sum_k coef[y, x, k] mats[qy, qx, j, k]
    out = np.einsum("yxk,abjk->yaxbj", coef, mats, optimize=True)
    return out.reshape(by * fy, bx * fx, dctlib.NFREQ).astype(coef.dtype)


def fit_grid(coef: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Zero-pad (bottom/right) or center-crop a ``(by, bx, 64)`` block grid
    to ``(bh, bw, 64)`` — the plan's expected input grid."""
    by, bx, nf = coef.shape
    if by > bh:
        off = (by - bh) // 2
        coef = coef[off: off + bh]
    if bx > bw:
        off = (bx - bw) // 2
        coef = coef[:, off: off + bw]
    by, bx = coef.shape[:2]
    if by < bh or bx < bw:
        out = np.zeros((bh, bw, nf), coef.dtype)
        out[:by, :bx] = coef
        coef = out
    return coef


def normalize_image(dec: DecodedJpeg, *, quality: int,
                    grid: tuple[int, int] | None = None,
                    channels: int | None = None) -> np.ndarray:
    """One decoded file → ``(bh, bw, C, 64)`` float32 network coefficients.

    Per component: de-quantize with the file's own table, rescale into the
    canonical convention, undo chroma subsampling in the coefficient
    domain, crop the MCU padding, then fit the plan's ``grid``.  A
    grayscale file feeding a ``channels=3`` network replicates luma; a
    color file feeding ``channels=1`` keeps only luma.
    """
    hmax = max(c.h for c in dec.components)
    vmax = max(c.v for c in dec.components)
    gain_out = 1.0 / (PIXEL_SCALE * canonical_qtable(quality))
    planes = []
    for i, c in enumerate(dec.components):
        # order matters: de-quantize in the file basis (where quantization
        # happened), upsample in the plain DCT basis, and only then apply
        # the per-index canonical rescale — the upsample map mixes zigzag
        # indices, so a per-index divide must not precede it
        plane = (np.asarray(dec.coefficients[i], np.float64)
                 * np.asarray(dec.qtable(i), np.float64))
        fy, fx = vmax // c.v, hmax // c.h
        if vmax % c.v or hmax % c.h:
            raise ValueError(
                f"non-integer sampling ratio {(vmax, c.v, hmax, c.h)}")
        plane = upsample_coefficients(plane, fy, fx)
        plane = (plane * gain_out).astype(np.float32)
        # crop the MCU padding down to the true luma-grid block dims
        bh_true = -(-dec.height // dctlib.BLOCK)
        bw_true = -(-dec.width // dctlib.BLOCK)
        plane = plane[:bh_true, :bw_true]
        planes.append(plane)
    if channels is not None and len(planes) != channels:
        if len(planes) == 1:
            planes = planes * channels
        elif channels == 1:
            planes = planes[:1]
        else:
            raise ValueError(
                f"file has {len(planes)} components, network wants "
                f"{channels} channels")
    out = np.stack(planes, axis=2)  # (bh, bw, C, 64)
    if grid is not None:
        bh, bw = grid
        out = np.stack([fit_grid(out[:, :, c], bh, bw)
                        for c in range(out.shape[2])], axis=2)
    return np.ascontiguousarray(out, np.float32)
