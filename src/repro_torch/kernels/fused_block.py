"""One JPEG-domain residual block over tile-packed operators — CUDA kernels.

Replaces ``repro/kernels/fused_block.py:fused_block_pallas``.  The Pallas
megakernel holds one image's whole feature map and every Ξ in VMEM; at
stage 0 of the full model that is some 80 MB, against 227 KB of shared
memory per CTA on Hopper.  So the block runs as (at most) three launches
of the banded-conv kernel (``csrc/jpeg_kernels.cu``), with no plain-torch
step between them:

    h     = ASM(conv1(x) + sh₁)                 # ASM epilogue at w_mid
    short = proj(x) + sh_p                      # projection blocks only
    out   = ASM(conv2(h) + sh₂ + fit(short|x))  # residual + ASM epilogue

Ξ streams from device memory (L2-resident across neighbouring CTAs), ``h``
makes one round trip through device memory, and every width fit
(``tiling.fit_width``) is index arithmetic inside the kernel.  Bound: fp32
FFMA, as for ``jpeg_conv``.  A single-launch design is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.jpeg_conv import banded_conv, conv_smem_bytes
from repro_torch.kernels.tiling import PackedAsm, PackedConv, fit_width, \
    packed_asm_apply, packed_conv_apply

__all__ = ["LAUNCHES", "fused_block", "fused_block_reference",
           "fused_smem_bytes"]

#: kernel launches made by :func:`fused_block` (two or three per block)
LAUNCHES = 0


def fused_block_reference(x: torch.Tensor, conv1: PackedConv,
                          asm_mid: PackedAsm, conv2: PackedConv,
                          asm_out: PackedAsm,
                          proj: PackedConv | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_block`."""
    h = packed_conv_apply(fit_width(x, conv1.cin, conv1.w_in), conv1)
    h = packed_asm_apply(h, asm_mid)
    y = packed_conv_apply(fit_width(h, conv2.cin, conv2.w_in), conv2)
    y = fit_width(y, conv2.cout, asm_out.w)
    if proj is None:
        short = fit_width(x, conv1.cin, asm_out.w)
    else:
        short = packed_conv_apply(fit_width(x, proj.cin, proj.w_in), proj)
        short = fit_width(short, proj.cout, asm_out.w)
    return packed_asm_apply(y + short, asm_out)


def _conv(x: torch.Tensor, pc: PackedConv, w_o: int, **kw) -> torch.Tensor:
    return banded_conv(x, cin=pc.cin, w_in=pc.w_in,
                       xi=pc.xi.reshape(-1, pc.cout * pc.w_out), ndy=pc.ndy,
                       ndx=pc.ndx, stride=pc.stride, cout=pc.cout,
                       w_b=pc.w_out, w_o=w_o, shift=pc.shift.reshape(-1),
                       **kw)


def fused_block(x: torch.Tensor, conv1: PackedConv, asm_mid: PackedAsm,
                conv2: PackedConv, asm_out: PackedAsm,
                proj: PackedConv | None = None) -> torch.Tensor:
    """One residual block; ``x`` is ``(N, bh, bw, Cin·w)``, the result
    ``(N, bh/s, bw/s, Cout·asm_out.w)``.  A CPU tensor takes
    :func:`fused_block_reference`; a CUDA tensor launches the kernels or
    raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_block_reference(x, conv1, asm_mid, conv2, asm_out, proj)
    if x.shape[-1] % conv1.cin:
        raise ValueError(f"input width {x.shape[-1]} not a multiple of "
                         f"Cin={conv1.cin}")
    h = _conv(x, conv1, asm_mid.w, asm=asm_mid)
    short = x
    if proj is not None:
        short = _conv(x, proj, proj.w_out)
    out = _conv(h, conv2, asm_out.w, res=short, asm=asm_out)
    LAUNCHES += 2 if proj is None else 3
    return out


def fused_smem_bytes(asm_mid: PackedAsm, asm_out: PackedAsm,
                     proj: PackedConv | None = None) -> int:
    """Largest per-CTA dynamic shared memory among the block's launches."""
    sizes = [conv_smem_bytes(asm_mid.w, True), conv_smem_bytes(asm_out.w, True)]
    if proj is not None:
        sizes.append(conv_smem_bytes(proj.w_out, False))
    return max(sizes)
