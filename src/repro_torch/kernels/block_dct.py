"""Batched 8×8 block DCT / IDCT (zigzag and quantization folded) — CUDA kernel.

Replaces ``repro/kernels/block_dct.py:block_dct_pallas`` and
``block_idct_pallas`` (one ``pallas_call`` in their ``_run``).  Both are
one product of rows by a 64×64 operator: the forward operator maps 64
flat pixels to 64 zigzag coefficients (``R.T``, divided by the
quantization table when a ``quality`` is given), the inverse one maps
back (``q · R``).  So one device kernel, ``csrc/block_dct.cu:
block_matmul_kernel``, takes the operator as an argument and serves
both; the backward of either is the same kernel with the transposed
operator (the reference package has no backward kernel: JAX
differentiates its product).

Bound: 16 FLOP per byte moved, next to the card's fp32 ridge of ~20, so
memory and FFMA bound it about equally.  The kernel keeps the operator in
shared memory for the whole launch, reads each row once and writes each
output once with coalesced 16-byte accesses, and masks the ragged tail:
unlike the Pallas ``_run``, it pads no row count up to a tile.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dct as dctlib
from repro_torch.introspect import opcount
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "block_dct", "block_idct", "block_dct_plain",
           "block_idct_plain", "operator"]

#: kernel launches made by :func:`block_dct` and :func:`block_idct`, each
#: counted under the function whose forward or backward launched it
LAUNCHES = {"block_dct": 0, "block_idct": 0}

_NF, _B = dctlib.NFREQ, dctlib.BLOCK


@functools.lru_cache(maxsize=None)
def _fwd_operator(quality: int | None) -> np.ndarray:
    """(64 flat-pixel, 64 zigzag-coef) forward DCT operator."""
    op = dctlib.reconstruction_matrix().T.copy()
    if quality is not None:
        op = op / dctlib.quantization_table(quality)[None, :]
    return op


@functools.lru_cache(maxsize=None)
def _inv_operator(quality: int | None) -> np.ndarray:
    """(64 zigzag-coef, 64 flat-pixel) inverse operator."""
    r = dctlib.reconstruction_matrix().copy()
    if quality is not None:
        r = dctlib.quantization_table(quality)[:, None] * r
    return r


@functools.lru_cache(maxsize=None)
def _operators(name: str, quality: int | None, device: torch.device,
               dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    op = _fwd_operator(quality) if name == "block_dct" \
        else _inv_operator(quality)
    # cached constants must be normal tensors even when first made under
    # inference_mode (the backward saves them), and real under a
    # fake-tensor mode
    with torch.inference_mode(False), _build.real_constants():
        t = torch.as_tensor(op, dtype=dtype, device=device)
        return t, t.T.contiguous()


def operator(name: str, quality: int | None, like: torch.Tensor
             ) -> torch.Tensor:
    """The ``(64, 64)`` operator of ``name`` ("block_dct" or
    "block_idct") on ``like``'s device and in its dtype."""
    return _operators(name, quality, like.device, like.dtype)[0]


def _launch(rows: torch.Tensor, op: torch.Tensor, name: str) -> torch.Tensor:
    rows = rows.contiguous()
    if rows.dim() != 2 or rows.shape[1] != _NF or op.shape != (_NF, _NF):
        raise ValueError(f"{name}: expected (n, 64) rows and a (64, 64) "
                         f"operator, got {tuple(rows.shape)} and "
                         f"{tuple(op.shape)}")
    out = torch.empty_like(rows)
    if not _build.is_fake(rows):  # a fake one: the work, no launch
        _build.check_device(rows, op)
        if rows.data_ptr() % 16 or op.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
        err = _build.library().jk_block_matmul(
            rows.data_ptr(), op.data_ptr(), out.data_ptr(), rows.shape[0],
            _build.stream_of(rows))
        _build.launch_check(err, name)
        LAUNCHES[name] += 1
    if opcount.counting():
        opcount.add_kernel_work(*opcount.block_matmul_work(rows.shape[0]))
    return out


class _BlockMatmul(torch.autograd.Function):
    """``rows @ op`` by the kernel; the gradient is ``grad @ op.T``, the
    same kernel on the transposed operator (passed contiguous)."""

    @staticmethod
    def forward(ctx, rows, op, op_t, name):
        ctx.save_for_backward(op_t)
        ctx.name = name
        return _launch(rows, op, name)

    @staticmethod
    def backward(ctx, grad):
        (op_t,) = ctx.saved_tensors
        return _launch(grad, op_t, ctx.name), None, None, None


def _plain(rows: torch.Tensor, name: str, quality: int | None
           ) -> torch.Tensor:
    return rows @ operator(name, quality, rows)


def block_dct_plain(blocks: torch.Tensor, quality: int | None = None
                    ) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_dct`."""
    lead = blocks.shape[:-2]
    return _plain(blocks.reshape(-1, _NF), "block_dct", quality).reshape(
        *lead, _NF)


def block_idct_plain(coef: torch.Tensor, quality: int | None = None
                     ) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_idct`."""
    lead = coef.shape[:-1]
    return _plain(coef.reshape(-1, _NF), "block_idct", quality).reshape(
        *lead, _B, _B)


def block_dct(blocks: torch.Tensor, quality: int | None = None
              ) -> torch.Tensor:
    """``(..., 8, 8)`` pixel blocks → ``(..., 64)`` zigzag coefficients,
    divided by the quality's quantization table when ``quality`` is given.
    A CPU tensor takes :func:`block_dct_plain`; a CUDA tensor launches the
    kernel (differentiably) or raises; a fake tensor takes the kernel's
    route and launches nothing."""
    if blocks.device.type == "cpu" and not _build.is_fake(blocks):
        return block_dct_plain(blocks, quality)
    if blocks.shape[-2:] != (_B, _B):
        raise ValueError(f"block_dct: expected (..., 8, 8), got "
                         f"{tuple(blocks.shape)}")
    op, op_t = _operators("block_dct", quality, blocks.device,
                          torch.float32)
    out = _BlockMatmul.apply(blocks.reshape(-1, _NF), op, op_t, "block_dct")
    return out.reshape(*blocks.shape[:-2], _NF)


def block_idct(coef: torch.Tensor, quality: int | None = None
               ) -> torch.Tensor:
    """``(..., 64)`` zigzag coefficients (times the quantization table when
    ``quality`` is given) → ``(..., 8, 8)`` pixel blocks.  A CPU tensor
    takes :func:`block_idct_plain`; a CUDA tensor launches the kernel
    (differentiably) or raises; a fake tensor takes the kernel's route and
    launches nothing."""
    if coef.device.type == "cpu" and not _build.is_fake(coef):
        return block_idct_plain(coef, quality)
    if coef.shape[-1] != _NF:
        raise ValueError(f"block_idct: expected (..., 64), got "
                         f"{tuple(coef.shape)}")
    op, op_t = _operators("block_idct", quality, coef.device, torch.float32)
    out = _BlockMatmul.apply(coef.reshape(-1, _NF), op, op_t, "block_idct")
    return out.reshape(*coef.shape[:-1], _B, _B)
