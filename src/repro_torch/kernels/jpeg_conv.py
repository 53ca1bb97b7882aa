"""Exploded JPEG-domain convolution (paper §4.1) — CUDA kernel.

Replaces ``repro/kernels/jpeg_conv.py:jpeg_conv_pallas``.  The device
kernel (``csrc/jpeg_kernels.cu:banded_conv_kernel``) is an implicit GEMM

    out[r, :] = Σ_o x[gather_o(r), :] @ Ξ[o] (+ shift row)

over the packed layout: Ξ ``(ndy, ndx, Cin, nf, Cout, nf')`` is read as
``(ndy·ndx·Cin·nf, Cout·nf')`` without a copy, the gather reads each
offset's input block straight from ``coef`` (zero outside the block grid —
no padded copy), and the ragged edges of rows and columns are masked
instead of padding channels to 256 as the Pallas kernel did.  A CTA walks
all of K itself, so sums never cross CTAs and results do not vary from
run to run.

Bound: fp32 FFMA at the path's shapes (see the note in the source); the
kernel stages 64×128 output tiles through shared memory with a 4×8
register block per thread.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.conv import _offsets_from, apply_exploded
from repro_torch.kernels import _build
from repro_torch.kernels.tiling import PackedAsm

__all__ = ["LAUNCHES", "jpeg_conv", "jpeg_conv_plain", "banded_conv",
           "conv_smem_bytes"]

#: kernel launches made by :func:`jpeg_conv`
LAUNCHES = 0

# tile geometry of banded_conv_kernel (csrc/jpeg_kernels.cu)
_BM, _BN, _BK, _WARPS, _NF = 64, 128, 16, 8, 64


def conv_smem_bytes(w_o: int, with_asm: bool) -> int:
    """Dynamic shared memory of one banded-conv CTA (mirrors
    ``jk_banded_conv_smem`` in the CUDA source)."""
    if not with_asm:
        return (_BK * (_BM + 2) + _BK * _BN) * 4
    return (_BM * (_BN + 16) + w_o * 2 * _NF + _NF * w_o + _WARPS * _NF) * 4


def banded_conv(x: torch.Tensor, *, cin: int, w_in: int, xi: torch.Tensor,
                ndy: int, ndx: int, stride: int, cout: int, w_b: int,
                w_o: int, shift: torch.Tensor | None = None,
                res: torch.Tensor | None = None,
                asm: PackedAsm | None = None) -> torch.Tensor:
    """One launch of the banded-conv kernel on CUDA tensors.

    ``x`` ``(N, bh, bw, cin·w_x)`` is read at ``w_in`` lanes per channel;
    ``xi`` is ``(ndy·ndx·cin·w_in, cout·w_b)``; the output
    ``(N, bh/s, bw/s, cout·w_o)`` holds Ξ's ``w_b`` lanes fitted to ``w_o``
    (+ ``shift`` ``(cout·w_b)``, + ``res`` ``(N, bh/s, bw/s, cout·w_r)``
    fitted to ``w_o``, then ASM at width ``w_o`` when ``asm`` is given).
    Counts nothing: the calling wrapper counts its launches.
    """
    n, bh, bw, kx = x.shape
    if kx % cin or xi.shape != (ndy * ndx * cin * w_in, cout * w_b):
        raise ValueError(f"operand shapes disagree: x {tuple(x.shape)} "
                         f"cin={cin}, xi {tuple(xi.shape)}")
    if not (1 <= w_b <= _NF and 1 <= w_o <= _NF):
        raise ValueError(f"per-channel widths must be in 1..64: "
                         f"w_b={w_b} w_o={w_o}")
    if asm is not None and asm.w != w_o:
        raise ValueError(f"ASM width {asm.w} != output width {w_o}")
    bh_o, bw_o = bh // stride, bw // stride
    w_r = 0
    if res is not None:
        if res.shape[:3] != (n, bh_o, bw_o) or res.shape[3] % cout:
            raise ValueError(f"residual {tuple(res.shape)} does not match "
                             f"the output grid {(n, bh_o, bw_o)}")
        w_r = res.shape[3] // cout
    ops = [t for t in (x, xi, shift, res) if t is not None]
    if asm is not None:
        ops += [asm.cat, asm.recon_t]
    _build.check_device(*ops)
    out = torch.empty((n, bh_o, bw_o, cout * w_o), dtype=x.dtype,
                      device=x.device)
    dmin_y, _ = _offsets_from(ndy, stride)
    dmin_x, _ = _offsets_from(ndx, stride)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.library().jk_banded_conv(
        x.data_ptr(), xi.data_ptr(), ptr(shift), ptr(res),
        ptr(asm.cat if asm is not None else None),
        ptr(asm.recon_t if asm is not None else None), out.data_ptr(),
        n, bh, bw, cin, kx // cin, w_in, stride, ndy, ndx, dmin_y, dmin_x,
        cout, w_b, w_r, w_o, _build.stream_of(x))
    _build.launch_check(err, "banded_conv")
    return out


def _shift_row(shift: torch.Tensor, cout: int, nf: int) -> torch.Tensor:
    row = shift.new_zeros(cout * nf)
    row[::nf] = shift
    return row


def jpeg_conv_plain(coef: torch.Tensor, xi: torch.Tensor, stride: int = 1, *,
                    shift: torch.Tensor | None = None,
                    w_out: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`jpeg_conv` (``apply_exploded``)."""
    out = apply_exploded(coef, xi, stride)
    nf = out.shape[-1]
    if w_out is not None and w_out != nf:
        out = out[..., :w_out] if w_out < nf else F.pad(out, (0, w_out - nf))
    if shift is not None:
        out[..., 0] += shift
    return out


def jpeg_conv(coef: torch.Tensor, xi: torch.Tensor, stride: int = 1, *,
              shift: torch.Tensor | None = None,
              w_out: int | None = None) -> torch.Tensor:
    """Apply Ξ ``(ndy, ndx, Cin, nf, Cout, nf')`` to ``(N, bh, bw, Cin, ≥nf)``
    coefficients → ``(N, bh/s, bw/s, Cout, w_out)`` (default ``w_out =
    nf'``; extra lanes are zero), adding ``shift`` ``(Cout,)`` to DC.
    A CPU tensor takes :func:`jpeg_conv_plain`; a CUDA tensor launches the
    kernel or raises."""
    global LAUNCHES
    if coef.device.type == "cpu":
        return jpeg_conv_plain(coef, xi, stride, shift=shift, w_out=w_out)
    n, bh, bw, cin, nf = coef.shape
    ndy, ndx, _, nf_in, cout, nf_out = xi.shape
    w_o = nf_out if w_out is None else w_out
    out = banded_conv(
        coef.reshape(n, bh, bw, cin * nf), cin=cin, w_in=nf_in,
        xi=xi.reshape(ndy * ndx * cin * nf_in, cout * nf_out), ndy=ndy,
        ndx=ndx, stride=stride, cout=cout, w_b=nf_out, w_o=w_o,
        shift=None if shift is None else _shift_row(shift, cout, nf_out))
    LAUNCHES += 1
    return out.reshape(n, bh // stride, bw // stride, cout, w_o)
