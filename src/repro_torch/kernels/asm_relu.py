"""ASM ReLU (paper §4.2) over rows of zigzag coefficients — CUDA kernel.

Replaces ``repro/kernels/asm_relu.py:asm_relu_pallas``.  Each row of ``nf``
lanes is read at its first ``bands`` lanes; a warp computes
``both = t @ cat`` (``cat`` = ``[R_φ | R]`` packed ``(bands, 128)``), masks
the exact reconstruction ``both[64:]`` by ``both[:64] > 0`` and maps back
with ``recon_t`` ``(64, bands)``; lanes at and above ``bands`` are written
as zero.  ``cat`` and ``recon_t`` sit in shared memory for the whole
launch, so device memory sees each row once in and once out.

Bound: 192 FFMA per element moved (64·2 + 64 multiply-adds per lane), so
the fp32 FFMA rate bounds it, not memory.  The Pallas kernel padded rows
up to a ``pick_tile`` tile; the CUDA grid strides over rows and needs no
padding.  In training the kernel sits in the autograd graph; its backward
is plain PyTorch in closed form (the reference package has no backward
kernel either).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.tiling import PackedAsm, pack_asm, packed_asm_apply

__all__ = ["LAUNCHES", "asm_relu", "asm_relu_plain",
           "asm_relu_backward_plain"]

#: kernel launches made by :func:`asm_relu` (reset by callers that count)
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _operands(phi: int, bands: int, device: str) -> PackedAsm:
    # normal tensors even when first made under inference_mode: the plain
    # version's autograd saves them
    with torch.inference_mode(False):
        return pack_asm(phi, bands, bands, device=device)


def _bands(coef: torch.Tensor, bands: int | None) -> int:
    nf = coef.shape[-1]
    return nf if bands is None else min(bands, nf)


def asm_relu_plain(coef: torch.Tensor, phi: int = 14,
                   bands: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`asm_relu`."""
    nf, b = coef.shape[-1], _bands(coef, bands)
    t = coef.reshape(-1, nf)[:, :b]
    out = packed_asm_apply(t, _operands(phi, b, str(coef.device)))
    return F.pad(out, (0, nf - b)).reshape(coef.shape)


def asm_relu_backward_plain(coef: torch.Tensor, grad: torch.Tensor,
                            phi: int = 14,
                            bands: int | None = None) -> torch.Tensor:
    """Gradient of :func:`asm_relu` with respect to ``coef`` in closed form,
    plain PyTorch: the mask is a constant, as ``jnp.where`` makes it in the
    reference package, so ``∂coef = ((grad @ recon_t.T) · mask) @ recon.T``
    at the first ``bands`` lanes and zero above them."""
    nf, b = coef.shape[-1], _bands(coef, bands)
    pa = _operands(phi, b, str(coef.device))
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
    pa = _operands(phi, b, str(coef.device))
    _build.check_device(coef, pa.cat, pa.recon_t)
    out = torch.empty_like(coef)
    lib = _build.library()
    err = lib.jk_asm(coef.data_ptr(), pa.cat.data_ptr(),
                     pa.recon_t.data_ptr(), out.data_ptr(),
                     coef.numel() // nf, nf, b, nf, _build.stream_of(coef))
    _build.launch_check(err, "asm_relu")
    LAUNCHES += 1
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
    launches the kernel (differentiably) or raises."""
    if coef.device.type == "cpu":
        return asm_relu_plain(coef, phi, bands)
    return _AsmRelu.apply(coef, phi, bands)
