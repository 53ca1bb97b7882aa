"""Operator dispatch for the JPEG-domain network.

Each op the forward needs — convolution, ASM ReLU, a fused residual block —
runs along one of three paths:

* ``reference`` — plain PyTorch (the kernels' plain versions);
* ``cuda``      — the hand-written kernels of ``repro_torch.kernels``;
* ``factored``  — convolution as decode → spatial conv → encode, for layers
  whose Ξ would exceed ``MATERIALIZE_LIMIT`` elements.

``auto`` resolves by operator size (factored above the limit), then by
device: ``cuda`` for CUDA tensors, ``reference`` for CPU ones.  A path is
resolved per operator when a plan is built; at apply time a config whose
path is ``reference`` runs the plain version of every kernel on the same
operators (factored layers stay factored), which is how a served batch is
held against the plain walk on the same device.

``bands`` keeps the first ``bands`` zigzag coefficients (paper §6);
activations stay 64 lanes wide at op boundaries, zero above the cutoff.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import asm as asmlib
from repro_torch.core import conv as convlib
from repro_torch.core import dct as dctlib

__all__ = ["PATHS", "DispatchConfig", "choose_path", "ConvOperator",
           "precompute_conv", "apply_conv", "asm_relu", "fused_block"]

PATHS = ("reference", "cuda", "factored")


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """``path``: 'auto' or a forced path; ``bands``: zigzag coefficients
    kept (1..64); ``materialize_limit``: Ξ elements above which a conv goes
    factored (None = ``core.conv.MATERIALIZE_LIMIT``)."""

    path: str = "auto"
    bands: int = dctlib.NFREQ
    materialize_limit: int | None = None

    def __post_init__(self):
        if self.path not in ("auto",) + PATHS:
            raise ValueError(f"unknown dispatch path {self.path!r}")
        if not 1 <= self.bands <= dctlib.NFREQ:
            raise ValueError(f"bands must be in [1, {dctlib.NFREQ}]")

    @property
    def limit(self) -> int:
        if self.materialize_limit is not None:
            return self.materialize_limit
        return convlib.MATERIALIZE_LIMIT


def choose_path(op: str, cfg: DispatchConfig, *, device: torch.device,
                op_elems: int | None = None) -> str:
    """Resolve 'auto' (and an oversized forced-``cuda`` conv) to a path."""
    too_big = op == "conv" and op_elems is not None and op_elems > cfg.limit
    if cfg.path != "auto":
        return "factored" if cfg.path == "cuda" and too_big else cfg.path
    if too_big:
        return "factored"
    return "cuda" if torch.device(device).type == "cuda" else "reference"


def _runtime_path(path: str, cfg: DispatchConfig) -> str:
    return "reference" if path == "cuda" and cfg.path == "reference" else path


# --------------------------------------------------------------------------
# Convolution
# --------------------------------------------------------------------------


class ConvOperator(NamedTuple):
    """A precomputed layer operator with its resolved apply path.

    ``xi`` is the band-truncated Ξ with any batch-norm scale folded into its
    output-channel axis (None on the factored path, which keeps ``kernel``
    and applies ``scale`` per step); ``shift`` is the folded DC bias.
    """

    xi: torch.Tensor | None
    kernel: torch.Tensor
    stride: int
    bands: int
    quality: int
    in_scaled: bool
    out_scaled: bool
    path: str
    scale: torch.Tensor | None = None
    shift: torch.Tensor | None = None


def precompute_conv(kernel: torch.Tensor, stride: int = 1, *,
                    in_scaled: bool = False, out_scaled: bool = False,
                    quality: int = 50, bands: int | None = None,
                    scale: torch.Tensor | None = None,
                    shift: torch.Tensor | None = None,
                    cfg: DispatchConfig | None = None) -> ConvOperator:
    """Explode a layer once, on the kernel's device, resolving its path."""
    cfg = cfg or DispatchConfig()
    bands = cfg.bands if bands is None else bands
    path = choose_path("conv", cfg, device=kernel.device,
                       op_elems=convlib.operator_elems(kernel.shape, stride,
                                                       bands))
    xi = None
    if path != "factored":
        xi = convlib.explode(kernel, stride, quality=quality,
                             in_scaled=in_scaled, out_scaled=out_scaled,
                             bands=bands)
        if scale is not None:
            xi = xi * scale.to(xi)[None, None, None, None, :, None]
            scale = None
    return ConvOperator(xi, kernel, stride, bands, quality, in_scaled,
                        out_scaled, path, scale, shift)


def apply_conv(coef: torch.Tensor, op: ConvOperator,
               cfg: DispatchConfig | None = None) -> torch.Tensor:
    """Apply an operator along its path → 64-wide coefficients (+ shift)."""
    from repro_torch.kernels import jpeg_conv as kjc

    cfg = cfg or DispatchConfig()
    path = _runtime_path(op.path, cfg)
    if path == "cuda":
        return kjc.jpeg_conv(coef, op.xi, op.stride, shift=op.shift,
                             w_out=dctlib.NFREQ)
    if path == "reference":
        return kjc.jpeg_conv_plain(coef, op.xi, op.stride, shift=op.shift,
                                   w_out=dctlib.NFREQ)
    out = convlib._jpeg_conv_factored(
        coef, op.kernel, op.stride, quality=op.quality,
        in_scaled=op.in_scaled, out_scaled=op.out_scaled, bands=op.bands)
    if op.scale is not None:
        out = out * op.scale[None, None, None, :, None]
    if op.shift is not None:
        out[..., 0] += op.shift
    return out


# --------------------------------------------------------------------------
# ASM ReLU and the fused block
# --------------------------------------------------------------------------


def asm_relu(coef: torch.Tensor, phi: int = asmlib.EXACT_PHI,
             cfg: DispatchConfig | None = None, *,
             bands: int | None = None) -> torch.Tensor:
    """ASM ReLU on ``(..., 64)`` coefficients at ``bands`` (default
    ``cfg.bands``); lanes above the cutoff come back zero."""
    from repro_torch.kernels import asm_relu as kasm

    cfg = cfg or DispatchConfig()
    bands = cfg.bands if bands is None else bands
    if choose_path("asm_relu", cfg, device=coef.device) == "cuda":
        return kasm.asm_relu(coef, phi, bands=bands)
    return asmlib.asm_relu(coef, phi, bands=bands)


def fused_block(x: torch.Tensor, block, *, path: str,
                cfg: DispatchConfig | None = None) -> torch.Tensor:
    """One residual block of a compiled plan (``core.plan.CompiledBlock``):
    the CUDA kernels on the ``cuda`` path, their plain version otherwise."""
    from repro_torch.kernels import fused_block as kfb

    args = (x, block.conv1, block.asm_mid, block.conv2, block.asm_out,
            block.proj)
    if _runtime_path(path, cfg or DispatchConfig()) == "cuda":
        return kfb.fused_block(*args)
    return kfb.fused_block_reference(*args)
