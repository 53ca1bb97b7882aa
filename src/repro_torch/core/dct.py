"""Discrete Cosine Transform primitives for the JPEG transform domain.

Everything in this module is a *constant builder*: functions return numpy
arrays that are closed over by jitted code (they become XLA constants).

Conventions
-----------
* Block size is 8 (JPEG standard); a block of pixels is ``(8, 8)``.
* ``dct_matrix()`` returns the orthonormal DCT-II matrix ``D`` with
  ``D @ D.T == I``.  The 2-D DCT of a block ``X`` is ``D @ X @ D.T``; the
  inverse is ``D.T @ F @ D``.
* Zigzag order follows the JPEG standard (ISO/IEC 10918-1 Figure 5).
* "Spatial frequency" φ of coefficient ``(α, β)`` is the diagonal band
  ``α + β`` — the paper's Theorem 1 ordering.  There are 15 bands
  (0..14) for an 8×8 block; φ = 14 (all bands) is exact.
"""
from __future__ import annotations

import functools

import numpy as np

BLOCK = 8
NFREQ = BLOCK * BLOCK  # 64 coefficients per block
NBANDS = 2 * BLOCK - 1  # 15 diagonal frequency bands

__all__ = [
    "BLOCK",
    "NFREQ",
    "NBANDS",
    "dct_matrix",
    "dct2",
    "idct2",
    "zigzag_order",
    "zigzag_permutation",
    "band_of_zigzag",
    "band_mask",
    "reconstruction_matrix",
    "truncated_reconstruction_matrix",
    "harmonic_mixing_tensor",
    "quantization_table",
    "quality_scale_table",
]


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II matrix of size ``(n, n)``: ``Y = D @ X``.

    ``D[a, m] = V(a) * cos((2m + 1) a pi / (2n))`` with
    ``V(0) = sqrt(1/n)``, ``V(a>0) = sqrt(2/n)`` — matches the paper's
    Eq. (5) normalisation (so that ``D @ D.T = I``).
    """
    a = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    d = np.cos((2 * m + 1) * a * np.pi / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d.astype(np.float64)


def dct2(block: np.ndarray) -> np.ndarray:
    """2-D orthonormal DCT of trailing two (8, 8) axes (numpy reference)."""
    d = dct_matrix()
    return np.einsum("am,...mn,bn->...ab", d, block, d)


def idct2(coef: np.ndarray) -> np.ndarray:
    """Inverse 2-D orthonormal DCT of trailing two (8, 8) axes."""
    d = dct_matrix()
    return np.einsum("am,...ab,bn->...mn", d, coef, d)


@functools.lru_cache(maxsize=None)
def zigzag_order(n: int = BLOCK) -> np.ndarray:
    """``(n*n, 2)`` array: zigzag index -> (row α, col β).

    Standard JPEG zigzag: walk anti-diagonals, alternating direction.
    """
    out = []
    for band in range(2 * n - 1):
        coords = [(a, band - a) for a in range(n) if 0 <= band - a < n]
        # Even bands run bottom-left -> top-right (decreasing row);
        # odd bands run top-right -> bottom-left (increasing row).
        coords.sort(key=lambda rc: rc[0], reverse=(band % 2 == 0))
        out.extend(coords)
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def zigzag_permutation(n: int = BLOCK) -> np.ndarray:
    """``(n*n,)`` flat permutation: ``flat_coef[zz[k]] == zigzag_coef[k]``."""
    order = zigzag_order(n)
    return (order[:, 0] * n + order[:, 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def band_of_zigzag(n: int = BLOCK) -> np.ndarray:
    """``(n*n,)``: diagonal frequency band (α+β) of each zigzag coefficient."""
    order = zigzag_order(n)
    return (order[:, 0] + order[:, 1]).astype(np.int32)


def band_mask(phi: int, n: int = BLOCK) -> np.ndarray:
    """Boolean ``(n*n,)`` mask of zigzag coefficients with band <= phi.

    ``phi`` counts *spatial frequencies* as in the paper: using
    ``phi = k`` keeps bands ``0..k``.  ``phi >= 2n-2`` keeps everything.
    """
    return band_of_zigzag(n) <= phi


@functools.lru_cache(maxsize=None)
def reconstruction_matrix(n: int = BLOCK) -> np.ndarray:
    """``R`` of shape ``(n*n, n*n)``: zigzag coefficients -> flat pixels.

    ``pixels.flat[p] = sum_k coef_zz[k] * R[k, p]``.  Orthonormal:
    ``R @ R.T == I``, and the forward DCT (pixels -> zigzag coefficients)
    is ``R.T``.
    """
    d = dct_matrix(n)
    # full[a, b, m, n] = contribution of coefficient (a, b) to pixel (m, n)
    full = np.einsum("am,bn->abmn", d, d).reshape(n * n, n * n)
    return full[zigzag_permutation(n)].astype(np.float64)


def truncated_reconstruction_matrix(phi: int, n: int = BLOCK) -> np.ndarray:
    """Reconstruction matrix using only bands <= phi (rows zeroed above phi).

    This is the paper's least-squares-optimal approximation operator
    (Theorem 1): ``approx.flat = coef_zz @ R_phi``.
    """
    r = reconstruction_matrix(n).copy()
    r[~band_mask(phi, n)] = 0.0
    return r


@functools.lru_cache(maxsize=None)
def harmonic_mixing_tensor(n: int = BLOCK) -> np.ndarray:
    """The paper's harmonic mixing tensor H (Eq. 17), zigzag indexed.

    Shape ``(n*n [k], n*n [pixel p], n*n [k'])`` with
    ``H[k, p, k'] = R[k, p] * R[k', p]`` so that masking a block is

        ``F'[k'] = sum_{k,p} F[k] * H[k, p, k'] * M[p]``

    which equals ``DCT(IDCT(F) * M)`` exactly.
    """
    r = reconstruction_matrix(n)
    return np.einsum("kp,lp->kpl", r, r)


# --------------------------------------------------------------------------
# Quantization tables
# --------------------------------------------------------------------------

# ISO/IEC 10918-1 Annex K.1 luminance table (quality 50), row-major.
_IJG_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float64,
)


def quality_scale_table(quality: int, table: np.ndarray) -> np.ndarray:
    """IJG quality scaling of a base table (quality in [1, 100])."""
    quality = int(np.clip(quality, 1, 100))
    if quality < 50:
        scale = 5000.0 / quality
    else:
        scale = 200.0 - 2.0 * quality
    q = np.floor((table * scale + 50.0) / 100.0)
    return np.clip(q, 1.0, 255.0)


def quantization_table(
    quality: int = 50, *, dc_is_mean: bool = True, n: int = BLOCK
) -> np.ndarray:
    """Zigzag-ordered quantization vector ``q`` of shape ``(n*n,)``.

    With ``dc_is_mean`` the DC entry is forced to 8 so that the quantized
    DC coefficient stores *exactly* the block mean (paper §4.3: orthonormal
    DC gain is ``1/8 * sum = 8 * mean``; dividing by 8 leaves the mean).
    """
    q = quality_scale_table(quality, _IJG_LUMA)
    if dc_is_mean:
        q = q.copy()
        q[0, 0] = 8.0
    return q.reshape(-1)[zigzag_permutation(n)].astype(np.float64)
