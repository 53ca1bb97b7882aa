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

:func:`fused_block_spatial` and :func:`fused_stem_spatial` are the
reference's other lowering of the same block (its
``kernels/fused_block.py:236``/``:283``), which it serves wherever there
is no TPU: decode once at block entry, both convs in pixel space
(``F.conv2d``, cuDNN on the card, fp32), the ASM masks taken from the
pixel tile, encode once at the join.  They are plain PyTorch, not a
kernel: the decode and encode are truncated ``torch.matmul`` products and
the masks ``torch.where``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import conv as convlib
from repro_torch.core import dct as dctlib
from repro_torch.introspect import opcount
from repro_torch.kernels.jpeg_conv import banded_conv, conv_smem_bytes
from repro_torch.kernels.tiling import PackedAsm, PackedConv, fit_width, \
    packed_asm_apply, packed_conv_apply

__all__ = ["LAUNCHES", "fused_block", "fused_block_reference",
           "fused_block_spatial", "fused_stem_spatial", "fused_smem_bytes"]

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
    if opcount.counting():
        convs = [pc for pc in (conv1, conv2, proj) if pc is not None]
        opcount.add_kernel_work(*opcount.fused_work(
            x.numel(), out.numel(), out.shape[0] * out.shape[1]
            * out.shape[2], [pc.xi.numel() for pc in convs], conv2.cout,
            asm_mid.w, asm_out.w))
    return out


def fused_smem_bytes(asm_mid: PackedAsm, asm_out: PackedAsm,
                     proj: PackedConv | None = None) -> int:
    """Largest per-CTA dynamic shared memory among the block's launches."""
    sizes = [conv_smem_bytes(asm_mid.w, True), conv_smem_bytes(asm_out.w, True)]
    if proj is not None:
        sizes.append(conv_smem_bytes(proj.w_out, False))
    return max(sizes)


# --------------------------------------------------------------------------
# Spatial-resident lowering (the reference's off-TPU serving path)
# --------------------------------------------------------------------------
#
# Ξ application costs ndy·ndx·Cin·Cout·b² per block against 64·r²·Cin·Cout
# for the spatial convolution it factors through.  A fused block can take
# the cheaper side: decode once at block entry, run both convolutions on
# the pixel tile, take the ASM masks from it (ASM is project onto the kept
# bands, then threshold) and encode once at the join.  Every band
# truncation of the plan is kept as a subspace projection, so the result
# is the Ξ walk's up to fp32 rounding.


def _blocks_to_image(px: torch.Tensor) -> torch.Tensor:
    """``(N, bh, bw, C, 64)`` raster-ordered block pixels → ``(N, C, H, W)``."""
    n, bh, bw, c, _ = px.shape
    b = dctlib.BLOCK
    t = px.reshape(n, bh, bw, c, b, b).permute(0, 3, 1, 4, 2, 5)
    return t.reshape(n, c, bh * b, bw * b)


def _image_to_blocks(img: torch.Tensor) -> torch.Tensor:
    """``(N, C, H, W)`` → ``(N, bh, bw, C, 64)`` raster-ordered pixels."""
    n, c, h, w = img.shape
    b = dctlib.BLOCK
    t = img.reshape(n, c, h // b, b, w // b, b).permute(0, 2, 4, 1, 3, 5)
    return t.reshape(n, h // b, w // b, c, b * b)


@functools.lru_cache(maxsize=None)
def _matrices(phi: int, quality: int | None, device: torch.device,
              dtype: torch.dtype):
    """``(R, R_φ, q)`` on ``device``: made once, so that a CUDA graph
    capture after the first eager walk copies nothing from the host."""
    with torch.inference_mode(False):
        q = None if quality is None else torch.as_tensor(
            dctlib.quantization_table(quality), dtype=dtype, device=device)
        return (torch.as_tensor(dctlib.reconstruction_matrix(), dtype=dtype,
                                device=device),
                torch.as_tensor(dctlib.truncated_reconstruction_matrix(phi),
                                dtype=dtype, device=device), q)


def _spatial_op(img: torch.Tensor, op) -> torch.Tensor:
    """One conv layer in pixel space: BN-scaled kernel, stride, DC shift
    (a coefficient-DC shift ``s`` is a per-pixel bias ``s/8``, the
    orthonormal DC basis value)."""
    k = op.kernel
    if op.bn_scale is not None:
        k = k * op.bn_scale[:, None, None, None]
    img = convlib.spatial_conv(img, k, op.stride)
    if op.shift is not None:
        img = img + (op.shift / dctlib.BLOCK)[None, :, None, None]
    return img


def _pad_last(t: torch.Tensor, w: int) -> torch.Tensor:
    return t if t.shape[-1] == w else F.pad(t, (0, w - t.shape[-1]))


def fused_block_spatial(x: torch.Tensor, blk, phi: int) -> torch.Tensor:
    """Whole-block execution on a spatial-resident activation.

    ``blk`` is a ``core.plan.CompiledBlock`` (its ``ops`` carry the raw
    kernels and the retained batch-norm folds); ``x`` is the packed
    ``(N, bh, bw, Cin·w_in)`` activation with true content in the first
    ``blk.bands_in`` lanes per channel.  Returns ``(N, bh/s, bw/s,
    Cout·blk.w_out)``.
    """
    ops = blk.ops
    c1, c2, pr = ops["conv1"], ops["conv2"], ops.get("proj")
    n, bh, bw, k_in = x.shape
    w_in = k_in // blk.cin
    r, rphi, _ = _matrices(phi, None, x.device, x.dtype)
    coef = x.reshape(n, bh, bw, blk.cin, w_in)
    b1, b2 = c1.bands, c2.bands

    # conv1 (input truncated to its band cutoff, decoded once)
    bin1 = min(b1, blk.bands_in, w_in)
    img = _blocks_to_image(coef[..., :bin1] @ r[:bin1])
    px = _image_to_blocks(_spatial_op(img, c1))
    # mid ASM at b1: project onto the kept bands, threshold, keep pixels
    t = px @ r[:b1].T
    px = torch.where(t @ rphi[:b1] > 0, t @ r[:b1], 0.0)
    # conv2 input truncation (nested projections collapse: P_a∘P_b = P_min)
    bin2 = min(b2, b1)
    px = (px @ r[:bin2].T) @ r[:bin2]
    img = _spatial_op(_blocks_to_image(px), c2)
    y = _image_to_blocks(img) @ r[:b2].T  # encode + truncate, once per block
    # shortcut: identity stays coefficients (never decoded); a projection
    # shortcut runs its own spatial conv
    if pr is not None:
        binp = min(pr.bands, blk.bands_in, w_in)
        simg = _spatial_op(_blocks_to_image(coef[..., :binp] @ r[:binp]), pr)
        s_coef = _image_to_blocks(simg) @ r[:pr.bands].T
    else:
        s_coef = coef[..., : min(blk.bands_in, w_in)]
    j = blk.bands_out
    yj = _pad_last(y, j) + _pad_last(s_coef, j)
    # join ASM at the residual-join bands, back to packed coefficients
    out = torch.where(yj @ rphi[:j] > 0, yj @ r[:j], 0.0) @ r[:j].T
    s = c1.stride
    return _pad_last(out, blk.w_out).reshape(n, bh // s, bw // s,
                                             blk.cout * blk.w_out)


def fused_stem_spatial(coef: torch.Tensor, op, phi: int,
                       w_out: int) -> torch.Tensor:
    """Spatial-resident stem: de-quantize and decode the kept bands, one
    spatial conv, encode, ASM at the stem bands.  ``coef`` is the raw
    ``(N, bh, bw, C, 64)`` quantization-scaled input; returns ``(N, bh/s,
    bw/s, Cout·w_out)``."""
    n, bh, bw = coef.shape[:3]
    r, rphi, q = _matrices(phi, op.quality if op.in_scaled else None,
                           coef.device, coef.dtype)
    b = op.bands
    t = coef[..., :b]
    if q is not None:
        t = t * q[:b]
    img = _spatial_op(_blocks_to_image(t @ r[:b]), op)
    y = _image_to_blocks(img) @ r[:b].T
    out = torch.where(y @ rphi[:b] > 0, y @ r[:b], 0.0) @ r[:b].T
    s = op.stride
    return _pad_last(out, w_out).reshape(n, bh // s, bw // s,
                                         op.kernel.shape[0] * w_out)
