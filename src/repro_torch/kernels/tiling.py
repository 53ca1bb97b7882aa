"""Tile-packed operators and their plain executors.

* ``PackedConv`` — a band-truncated Ξ ``(ndy, ndx, Cin, b, Cout, b')``
  padded once to per-channel widths ``w_in``/``w_out`` and laid out as one
  ``(ndy·ndx, Cin·w_in, Cout·w_out)`` buffer (offset-major K), plus a
  ``(1, Cout·w_out)`` shift row that is non-zero only at the DC lanes.
* ``PackedAsm`` — the ASM ReLU matrices at width ``w``: ``cat`` ``(w, 128)``
  holds the φ-truncated reconstruction in lanes ``[:64]`` and the exact one
  in ``[64:]``; ``recon_t`` ``(64, w)`` maps back to coefficients.
* ``conv_slices`` / ``packed_conv_apply`` / ``packed_asm_apply`` /
  ``fit_width`` — plain PyTorch over the packed ``(N, bh, bw, C·w)``
  activation layout; the CUDA kernels compute the same functions.

``round_up``/``pick_tile``/``SUBLANE`` keep the reference package's width
rules (multiples of 8), so both packages pack to identical widths.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import asm as asmlib
from repro_torch.core import dct as dctlib
from repro_torch.core.conv import _offsets_from

__all__ = ["SUBLANE", "round_up", "pick_tile", "PackedConv", "PackedAsm",
           "pack_conv", "pack_asm", "conv_slices", "packed_conv_apply",
           "packed_asm_apply", "fit_width"]

#: per-channel widths are multiples of this
SUBLANE = 8


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is ≥ ``n``."""
    return -(-n // m) * m


def pick_tile(n: int, max_tile: int, align: int = SUBLANE) -> int:
    """Aligned row tile for ``n`` rows, balanced over ``ceil(n/max_tile)``
    tiles."""
    if n <= 0:
        raise ValueError(f"need at least one row, got {n}")
    num = -(-n // max_tile)
    return min(round_up(-(-n // num), align), round_up(max_tile, align))


class PackedConv(NamedTuple):
    xi: torch.Tensor      # (ndy·ndx, Cin·w_in, Cout·w_out)
    shift: torch.Tensor   # (1, Cout·w_out)
    stride: int
    ndy: int
    ndx: int
    cin: int
    w_in: int
    cout: int
    w_out: int


class PackedAsm(NamedTuple):
    cat: torch.Tensor      # (w, 128)
    recon_t: torch.Tensor  # (64, w)
    w: int
    bands: int
    phi: int


def pack_conv(xi: torch.Tensor, shift: torch.Tensor | None, stride: int, *,
              w_in: int, w_out: int) -> PackedConv:
    """Pack Ξ ``(ndy, ndx, Cin, b, Cout, b')`` and an optional per-channel
    DC ``shift`` on Ξ's device; band axes are cropped to ``min(b, w)``."""
    ndy, ndx, cin, b_in, cout, b_out = xi.shape
    k_in, k_out = min(b_in, w_in), min(b_out, w_out)
    packed = xi.new_zeros((ndy * ndx, cin, w_in, cout, w_out))
    packed[:, :, :k_in, :, :k_out] = xi.reshape(
        ndy * ndx, cin, b_in, cout, b_out)[:, :, :k_in, :, :k_out]
    packed = packed.reshape(ndy * ndx, cin * w_in, cout * w_out)
    row = xi.new_zeros((1, cout * w_out))
    if shift is not None:
        row[0, ::w_out] = shift.to(row)
    return PackedConv(packed, row, stride, ndy, ndx, cin, w_in, cout, w_out)


@functools.lru_cache(maxsize=None)
def _asm_arrays(phi: int, bands: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    c = asmlib.asm_constants(phi, bands=bands)
    cat = np.zeros((w, 2 * dctlib.NFREQ), np.float32)
    cat[:bands, : dctlib.NFREQ] = c.recon_phi
    cat[:bands, dctlib.NFREQ:] = c.recon
    rt = np.zeros((dctlib.NFREQ, w), np.float32)
    rt[:, :bands] = c.recon_t
    return cat, rt


def pack_asm(phi: int, bands: int, w: int,
             device: str | torch.device = "cpu") -> PackedAsm:
    """Pack the ASM ReLU matrices at band count ``bands``, padded to ``w``."""
    cat, rt = _asm_arrays(phi, bands, w)
    return PackedAsm(torch.as_tensor(cat, device=device),
                     torch.as_tensor(rt, device=device), w, bands, phi)


def conv_slices(x: torch.Tensor, stride: int, ndy: int,
                ndx: int) -> torch.Tensor:
    """im2col over block offsets: ``(N, bh, bw, K)`` → ``(N, bh/s, bw/s,
    ndy·ndx·K)``, offset-major like :func:`pack_conv`."""
    n, bh, bw, k = x.shape
    d_min_y, _ = _offsets_from(ndy, stride)
    d_min_x, _ = _offsets_from(ndx, stride)
    bh_o, bw_o = bh // stride, bw // stride
    padded = F.pad(x, (0, 0, -d_min_x, ndx - 1 + d_min_x,
                       -d_min_y, ndy - 1 + d_min_y))
    parts = [padded[:, iy: iy + stride * bh_o: stride,
                    ix: ix + stride * bw_o: stride]
             for iy in range(ndy) for ix in range(ndx)]
    return torch.cat(parts, dim=-1)


def packed_conv_apply(h: torch.Tensor, pc: PackedConv) -> torch.Tensor:
    """One GEMM per layer: gather offset slices, multiply the packed Ξ."""
    n, bh, bw, _ = h.shape
    cat = conv_slices(h, pc.stride, pc.ndy, pc.ndx)
    noff, k, m = pc.xi.shape
    out = cat.reshape(-1, noff * k) @ pc.xi.reshape(noff * k, m)
    return out.reshape(n, bh // pc.stride, bw // pc.stride, m) + pc.shift


def fit_width(h: torch.Tensor, c: int, w_to: int) -> torch.Tensor:
    """Slice or zero-pad each of the ``c`` channels of a packed ``(..., c·w)``
    activation to ``w_to`` lanes; no-op when the widths match."""
    w_from = h.shape[-1] // c
    if w_from == w_to:
        return h
    lead = h.shape[:-1]
    t = h.reshape(*lead, c, w_from)
    t = t[..., :w_to] if w_to < w_from else F.pad(t, (0, w_to - w_from))
    return t.reshape(*lead, c * w_to)


def packed_asm_apply(h: torch.Tensor, pa: PackedAsm) -> torch.Tensor:
    """ASM ReLU over a packed ``(..., C·w)`` activation (rows of ``w``)."""
    t = h.reshape(-1, pa.w)
    both = t @ pa.cat
    nf = dctlib.NFREQ
    masked = torch.where(both[:, :nf] > 0, both[:, nf:],
                         torch.zeros((), dtype=both.dtype, device=both.device))
    return (masked @ pa.recon_t).reshape(h.shape)
