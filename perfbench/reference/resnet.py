"""The plain reference of the JPEG-domain ResNet (arXiv:1812.11690, Fig. 3).

Plain PyTorch in float32, TF32 off, with no kernel, cache or batching of the
program under test.  It works in pixels: a JPEG-domain layer at ``b`` bands
keeps the first ``b`` zigzag coefficients of every 8x8 block of its input
and output, which is, in pixels, a projection of each block onto its first
``b`` DCT basis images (:func:`band_limit`).  With ``b = 64`` and the exact
ASM ReLU (phi = 14) the JPEG-domain network is the ordinary spatial network
on the decoded image, which is what the training reference runs.

``precision="tf32"`` rounds the operands of every convolution and matrix
product to TF32 (10 mantissa bits, round to nearest even) and accumulates
in float32, as TF32 tensor cores do: the control that a correct run has to
tell apart from the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import jpeg

EPS = 1e-5


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _Operand(torch.autograd.Function):
    """A product's operand in TF32; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    """A product's result; the gradient it hands the backward's products
    is rounded to TF32, as their operand."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


class Arith:
    """The reference's products, forward and backward, in one precision."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"

    def _in(self, t):
        return _Operand.apply(t) if self.tf32 else t

    def _out(self, t):
        return _Result.apply(t) if self.tf32 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._out(self._in(a) @ self._in(b))

    def conv(self, x: torch.Tensor, k: torch.Tensor,
             stride: int) -> torch.Tensor:
        return self._out(F.conv2d(self._in(x), self._in(k), stride=stride,
                                  padding=(k.shape[-1] - 1) // 2))


def stages(widths, blocks_per_stage: int):
    """``(name, stride, cin, cout)`` of every residual block: stage 0 keeps
    the resolution, each later stage halves it in its first block."""
    cin = widths[0]
    for si, w in enumerate(widths):
        for bi in range(blocks_per_stage):
            yield f"s{si}b{bi}", 2 if si and not bi else 1, cin, w
            cin = w


def decode(coef: torch.Tensor, ar: Arith) -> torch.Tensor:
    """``(N, bh, bw, C, b)``: the first ``b`` orthonormal zigzag
    coefficients of each block -> pixels."""
    r = jpeg.basis()[: coef.shape[-1]]
    return jpeg.from_blocks(ar.mm(coef, jpeg.const(r, coef)))


def band_limit(x: torch.Tensor, bands: int, ar: Arith) -> torch.Tensor:
    """Keep the first ``bands`` zigzag coefficients of every block."""
    if bands >= jpeg.NFREQ:
        return x
    p = jpeg.const(jpeg.band_projector(bands), x)
    return jpeg.from_blocks(ar.mm(jpeg.to_blocks(x), p))


def _bn_eval(x, params, state, name):
    inv = params[name]["gamma"] / torch.sqrt(state[name]["var"] + EPS)
    shift = params[name]["beta"] - state[name]["mean"] * inv
    return x * inv[None, :, None, None] + shift[None, :, None, None]


def _bn_train(x, params, name):
    mu = x.mean(dim=(0, 2, 3))
    var = (x * x).mean(dim=(0, 2, 3)) - mu * mu
    inv = params[name]["gamma"] / torch.sqrt(var + EPS)
    return (x - mu[None, :, None, None]) * inv[None, :, None, None] \
        + params[name]["beta"][None, :, None, None]


def forward(params, state, coef: torch.Tensor, *, widths,
            blocks_per_stage: int, bands: int = jpeg.NFREQ,
            training: bool = False, precision: str = "fp32") -> torch.Tensor:
    """Logits of the network on ``coef``, ``(N, bh, bw, C, 64)`` orthonormal
    zigzag DCT coefficients of the input pixels.

    Every conv reads and writes ``bands`` coefficients a block; batch norm
    uses the running statistics (``training=False``) or the batch's
    (``training=True``); each ReLU is exact on the band-limited block and
    re-limited after.  The head averages the last activation's pixels (the
    DC read)."""
    ar = Arith(precision)

    def limit(x):
        return band_limit(x, bands, ar)

    def bn(x, name):
        return _bn_train(x, params, name) if training \
            else _bn_eval(x, params, state, name)

    h = decode(coef[..., :bands], ar)
    h = limit(bn(ar.conv(h, params["stem"]["kernel"], 1), "stem_bn"))
    h = limit(F.relu(h))
    for name, s, _cin, _cout in stages(widths, blocks_per_stage):
        blk = params[name]
        short = h
        if "proj" in blk:
            short = limit(ar.conv(h, blk["proj"], s))
        y = limit(bn(ar.conv(h, blk["conv1"], s), name + "_bn1"))
        y = limit(F.relu(y))
        y = limit(bn(ar.conv(y, blk["conv2"], 1), name + "_bn2"))
        h = limit(F.relu(y + short))
    pooled = h.mean(dim=(2, 3))
    return ar.mm(pooled, params["head"]["w"]) + params["head"]["b"]
