"""ASM ReLU (paper §4.2) over rows of zigzag coefficients — CUDA kernel.

Replaces ``repro/kernels/asm_relu.py:asm_relu_pallas``.  Each row of ``nf``
lanes is read at its first ``bands`` lanes; ``both = t @ cat`` (``cat`` =
``[R_φ | R]`` packed ``(bands, 128)``) gives the approximate and the exact
reconstruction, the exact one is masked by ``both[:64] > 0`` and mapped
back with ``recon_t`` ``(64, bands)``; lanes at and above ``bands`` are
written as zero.

Bound: 192 FFMA per lane read, so the fp32 FFMA rate bounds it at 64
bands; at 16 bands bytes and operations are about even.  The kernel
(``csrc/jpeg_kernels.cu:asm_kernel``) runs persistent CTAs that hold
``cat`` and ``recon_t`` in shared memory for the whole launch and walk
tiles of 128 rows, the next tile in flight by ``cp.async`` while this one
is computed by ``asm_tile``, the routine the fused block's ASM epilogue
shares: both products register-blocked (a thread holds 8 rows × 4
frequencies of both halves, so the mask is applied in registers), the
masked tile in shared memory once between them, and the tile's output
stored from shared memory by one bulk copy.  Device memory sees each row
once in and once out.  The Pallas kernel padded rows up to a
``pick_tile`` tile; here the ragged last tile is masked.  In training the
kernel sits in the autograd graph; its backward is plain PyTorch in closed
form (the reference package has no backward kernel either).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.introspect import opcount
from repro_torch.kernels import _build
from repro_torch.kernels.tiling import PackedAsm, pack_asm, packed_asm_apply

__all__ = ["LAUNCHES", "asm_relu", "asm_relu_plain",
           "asm_relu_backward_plain"]

#: kernel launches made by :func:`asm_relu` (reset by callers that count)
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _operands(phi: int, bands: int, device: torch.device) -> PackedAsm:
    # normal tensors even when first made under inference_mode (the plain
    # version's autograd saves them), and real under a fake-tensor mode
    with torch.inference_mode(False), _build.real_constants():
        return pack_asm(phi, bands, bands, device=device)


def _bands(coef: torch.Tensor, bands: int | None) -> int:
    nf = coef.shape[-1]
    return nf if bands is None else min(bands, nf)


def asm_relu_plain(coef: torch.Tensor, phi: int = 14,
                   bands: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`asm_relu`."""
    nf, b = coef.shape[-1], _bands(coef, bands)
    t = coef.reshape(-1, nf)[:, :b]
    out = packed_asm_apply(t, _operands(phi, b, coef.device))
    return F.pad(out, (0, nf - b)).reshape(coef.shape)


def asm_relu_backward_plain(coef: torch.Tensor, grad: torch.Tensor,
                            phi: int = 14,
                            bands: int | None = None) -> torch.Tensor:
    """Gradient of :func:`asm_relu` with respect to ``coef`` in closed form,
    plain PyTorch: the mask is a constant, as ``jnp.where`` makes it in the
    reference package, so ``∂coef = ((grad @ recon_t.T) · mask) @ recon.T``
    at the first ``bands`` lanes and zero above them."""
    nf, b = coef.shape[-1], _bands(coef, bands)
    pa = _operands(phi, b, coef.device)
    nfreq = pa.cat.shape[1] // 2
    t = coef.reshape(-1, nf)[:, :b]
    mask = (t @ pa.cat[:, :nfreq]) > 0
    g = grad.reshape(-1, nf)[:, :b] @ pa.recon_t.T
    g = torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return F.pad(g @ pa.cat[:, nfreq:].T, (0, nf - b)).reshape(coef.shape)


def _launch(coef: torch.Tensor, phi: int, bands: int | None) -> torch.Tensor:
    global LAUNCHES
    coef = coef.contiguous()
    nf, b = coef.shape[-1], _bands(coef, bands)
    out = torch.empty_like(coef)
    if not _build.is_fake(coef):  # a fake one: the work, no launch
        pa = _operands(phi, b, coef.device)
        _build.check_device(coef, pa.cat, pa.recon_t)
        err = _build.library().jk_asm(
            coef.data_ptr(), pa.cat.data_ptr(), pa.recon_t.data_ptr(),
            out.data_ptr(), coef.numel() // nf, nf, b, nf,
            _build.stream_of(coef))
        _build.launch_check(err, "asm_relu")
        LAUNCHES += 1
    if opcount.counting():
        opcount.add_kernel_work(*opcount.asm_work(coef.numel() // nf, b, nf))
    return out


class _AsmRelu(torch.autograd.Function):
    """The kernel forward; the closed-form plain backward
    (:func:`asm_relu_backward_plain`)."""

    @staticmethod
    def forward(ctx, coef, phi, bands):
        ctx.save_for_backward(coef)
        ctx.phi, ctx.bands = phi, bands
        return _launch(coef, phi, bands)

    @staticmethod
    def backward(ctx, grad):
        (coef,) = ctx.saved_tensors
        return asm_relu_backward_plain(coef, grad, ctx.phi, ctx.bands), \
            None, None


def asm_relu(coef: torch.Tensor, phi: int = 14,
             bands: int | None = None) -> torch.Tensor:
    """ASM ReLU over ``(..., nf)`` coefficients at their first ``bands``
    lanes (default all ``nf``); the output keeps ``nf`` lanes, zero above
    ``bands``.  A CPU tensor takes :func:`asm_relu_plain`; a CUDA tensor
    launches the kernel (differentiably) or raises.  Where no gradient is
    wanted the kernel is launched without the autograd ``Function``, whose
    cost to issue exceeds the kernel's time at the served walk's row
    counts (PERF.md).  A fake tensor takes the kernel's route and
    launches nothing."""
    if coef.device.type == "cpu" and not _build.is_fake(coef):
        return asm_relu_plain(coef, phi, bands)
    if torch.is_grad_enabled() and coef.requires_grad:
        return _AsmRelu.apply(coef, phi, bands)
    return _launch(coef, phi, bands)
