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
kernel computes 128×128 output tiles with an 8×8 register block per
thread, fed by 32-wide K slices double-buffered by ``cp.async``, and a
64-row variant that :func:`banded_conv` picks where the 128-row grid would
leave more than half the SMs idle.  In training the kernel sits in the
autograd graph (the stem conv); its backward is plain PyTorch.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.conv import _offsets_from, apply_exploded
from repro_torch.introspect import opcount
from repro_torch.kernels import _build
from repro_torch.kernels.tiling import PackedAsm

__all__ = ["LAUNCHES", "TILE_ROWS", "jpeg_conv", "jpeg_conv_plain",
           "banded_conv", "conv_smem_bytes", "tile_rows"]

#: kernel launches made by :func:`jpeg_conv`
LAUNCHES = 0

# tile geometry of banded_conv_kernel (csrc/jpeg_kernels.cu): the GEMM
# ring, and the ASM epilogue's tile and masked tile row strides
_BN, _BK, _LDA, _STAGES, _NF = 128, 32, 36, 2, 64
_LDC, _LDM = _BN + 4, _NF + 4
#: output rows per tile: the kernel's two variants
TILE_ROWS = (128, 64)


def conv_smem_bytes(w_o: int, with_asm: bool, bm: int = 128) -> int:
    """Dynamic shared memory of one banded-conv CTA of ``bm`` rows (mirrors
    ``jk_banded_conv_smem`` in the CUDA source): the GEMM ring or, with the
    ASM epilogue where it is larger, the epilogue's output tile, ``cat`` and
    ``recon_t`` at ``w_o`` rounded up to 4 lanes, and the masked tile."""
    gemm = _STAGES * (bm * _LDA + _BK * _BN)
    if not with_asm:
        return gemm * 4
    wp = -(-w_o // 4) * 4
    return max(gemm, bm * _LDC + wp * 3 * _NF + bm * _LDM) * 4


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_rows(m_rows: int, col_tiles: int, sms: int) -> int:
    """128-row tiles, or 64 where the 128-row grid would leave more than
    half the card's SMs idle.  On an H100 (132 SMs; PERF.md) the 64-row
    tiles are 1.6× faster at the served s2b0 projection (64 CTAs of 128
    rows) and 4 % slower at s1b0.conv1 (128 CTAs of 128 rows)."""
    return 128 if 2 * -(-m_rows // 128) * col_tiles >= sms else 64


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
    cpt = _BN // (w_o if asm is not None else w_b)
    bm = tile_rows(n * bh_o * bw_o, -(-cout // cpt),
                   _sm_count(x.device.index or 0))
    dmin_y, _ = _offsets_from(ndy, stride)
    dmin_x, _ = _offsets_from(ndx, stride)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.library().jk_banded_conv(
        x.data_ptr(), xi.data_ptr(), ptr(shift), ptr(res),
        ptr(asm.cat if asm is not None else None),
        ptr(asm.recon_t if asm is not None else None), out.data_ptr(),
        n, bh, bw, cin, kx // cin, w_in, stride, ndy, ndx, dmin_y, dmin_x,
        cout, w_b, w_r, w_o, bm, _build.stream_of(x))
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


def _launch(coef: torch.Tensor, xi: torch.Tensor, stride: int,
            shift: torch.Tensor | None, w_out: int | None) -> torch.Tensor:
    global LAUNCHES
    coef, xi = coef.contiguous(), xi.contiguous()
    n, bh, bw, cin, nf = coef.shape
    ndy, ndx, _, nf_in, cout, nf_out = xi.shape
    w_o = nf_out if w_out is None else w_out
    if _build.is_fake(coef):  # the dry-run: the output, the work, no launch
        out = coef.new_empty((n, bh // stride, bw // stride, cout * w_o))
    else:
        out = banded_conv(
            coef.reshape(n, bh, bw, cin * nf), cin=cin, w_in=nf_in,
            xi=xi.reshape(ndy * ndx * cin * nf_in, cout * nf_out), ndy=ndy,
            ndx=ndx, stride=stride, cout=cout, w_b=nf_out, w_o=w_o,
            shift=None if shift is None
            else _shift_row(shift, cout, nf_out))
        LAUNCHES += 1
    if opcount.counting():
        opcount.add_kernel_work(*opcount.conv_work(
            n * bh * bw, cin, nf_in, ndy * ndx, nf_in, cout, nf_out, w_o,
            out.shape[0] * out.shape[1] * out.shape[2]))
    return out.reshape(n, bh // stride, bw // stride, cout, w_o)


class _JpegConv(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version,
    recomputed under ``enable_grad`` (the reference package has no
    backward kernel either)."""

    @staticmethod
    def forward(ctx, coef, xi, shift, stride, w_out):
        ctx.save_for_backward(coef, xi, shift)
        ctx.stride, ctx.w_out = stride, w_out
        return _launch(coef, xi, stride, shift, w_out)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, needs)]
            out = jpeg_conv_plain(leaves[0], leaves[1], ctx.stride,
                                  shift=leaves[2], w_out=ctx.w_out)
            wrt = [t for t, n in zip(leaves, needs) if n and t is not None]
            grads = iter(torch.autograd.grad(out, wrt, grad) if wrt else ())
        return (*(next(grads) if n and t is not None else None
                  for t, n in zip(leaves, needs)), None, None)


def jpeg_conv(coef: torch.Tensor, xi: torch.Tensor, stride: int = 1, *,
              shift: torch.Tensor | None = None,
              w_out: int | None = None) -> torch.Tensor:
    """Apply Ξ ``(ndy, ndx, Cin, nf, Cout, nf')`` to ``(N, bh, bw, Cin, ≥nf)``
    coefficients → ``(N, bh/s, bw/s, Cout, w_out)`` (default ``w_out =
    nf'``; extra lanes are zero), adding ``shift`` ``(Cout,)`` to DC.
    A CPU tensor takes :func:`jpeg_conv_plain`; a CUDA tensor launches the
    kernel (differentiably in ``coef``, Ξ and ``shift``) or raises; a
    fake tensor takes the kernel's route and launches nothing."""
    if coef.device.type == "cpu" and not _build.is_fake(coef):
        return jpeg_conv_plain(coef, xi, stride, shift=shift, w_out=w_out)
    return _JpegConv.apply(coef, xi, shift, stride, w_out)
