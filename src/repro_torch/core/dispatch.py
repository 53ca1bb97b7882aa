"""Operator dispatch for the JPEG-domain network.

Each op the forward needs — convolution, ASM ReLU, the block DCT/IDCT, a
fused residual block — runs along one of three paths:

* ``reference`` — plain PyTorch (the kernels' plain versions);
* ``cuda``      — the hand-written kernels of ``repro_torch.kernels``;
* ``factored``  — convolution as decode → spatial conv → encode, for layers
  whose Ξ would exceed ``MATERIALIZE_LIMIT`` elements.

The reference package's ``pallas`` path names its TPU kernels; the port
accepts ``pallas`` as another name for ``cuda`` (a config, an operator
path read from a reference plan directory, ``JPEG_DISPATCH`` and
``serve --dispatch``), so one ``--dispatch`` value means the same in both
packages.  Plans the port saves write ``pallas`` where it means ``cuda``,
so that the reference reads them too.

The global config is the reference's: ``JPEG_DISPATCH`` / ``JPEG_BANDS``
parsed on first use (:func:`get_config`), replaced by :func:`configure`,
scoped by :func:`override`; a call that passes no config uses it
(:func:`resolve_config`).

``auto`` resolves by operator size (factored above the limit), then by
device: ``cuda`` for CUDA tensors, ``reference`` for CPU ones.  A path is
resolved per operator when a plan is built; at apply time a config whose
path is ``reference`` runs the plain version of every kernel on the same
operators (factored layers stay factored, with the plain block
transforms), which is how a served batch is held against the plain walk
on the same device.

Training calls the per-step :func:`conv`, which explodes Ξ from the live
kernel on every call (differentiably) or goes factored above the limit,
and :func:`batchnorm` with batch statistics.

``bands`` keeps the first ``bands`` zigzag coefficients (paper §6);
activations stay 64 lanes wide at op boundaries, zero above the cutoff.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import NamedTuple

import torch

from repro_torch.core import asm as asmlib
from repro_torch.core import batchnorm as bnlib
from repro_torch.core import conv as convlib
from repro_torch.core import dct as dctlib

__all__ = ["PATHS", "PATH_ALIASES", "DispatchConfig", "get_config",
           "configure", "override", "resolve_config", "canonical_path",
           "choose_path", "ConvOperator", "conv", "precompute_conv",
           "apply_conv", "asm_relu", "batchnorm", "block_dct", "block_idct",
           "fused_block"]

PATHS = ("reference", "cuda", "factored")
#: other names of a path: the reference package's ``pallas`` is ``cuda``
PATH_ALIASES = {"pallas": "cuda"}


def canonical_path(path: str) -> str:
    """``pallas`` → ``cuda``; every other name unchanged."""
    return PATH_ALIASES.get(path, path)


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """``path``: 'auto' or a forced path; ``bands``: zigzag coefficients
    kept (1..64); ``materialize_limit``: Ξ elements above which a conv goes
    factored (None = ``core.conv.MATERIALIZE_LIMIT``)."""

    path: str = "auto"
    bands: int = dctlib.NFREQ
    materialize_limit: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "path", canonical_path(self.path))
        if self.path not in ("auto",) + PATHS:
            raise ValueError(f"unknown dispatch path {self.path!r}")
        if not 1 <= self.bands <= dctlib.NFREQ:
            raise ValueError(f"bands must be in [1, {dctlib.NFREQ}]")

    @property
    def limit(self) -> int:
        if self.materialize_limit is not None:
            return self.materialize_limit
        return convlib.MATERIALIZE_LIMIT


def _from_env() -> DispatchConfig:
    return DispatchConfig(
        path=os.environ.get("JPEG_DISPATCH", "auto").strip().lower() or "auto",
        bands=int(os.environ.get("JPEG_BANDS", dctlib.NFREQ)))


# Parsed on first use, so a malformed JPEG_DISPATCH/JPEG_BANDS raises the
# validating ValueError at the first dispatch call, not at import.
_CONFIG: DispatchConfig | None = None


def get_config() -> DispatchConfig:
    """The process-wide config (``JPEG_DISPATCH``/``JPEG_BANDS`` until
    :func:`configure` replaces it)."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = _from_env()
    return _CONFIG


def configure(**changes) -> DispatchConfig:
    """Replace fields of the global config for the rest of the process
    (the serve entry point's ``--dispatch``/``--bands``)."""
    global _CONFIG
    _CONFIG = dataclasses.replace(get_config(), **changes)
    return _CONFIG


@contextlib.contextmanager
def override(**changes):
    """Replace fields of the global config inside a ``with`` block."""
    global _CONFIG
    prev = get_config()
    _CONFIG = dataclasses.replace(prev, **changes)
    try:
        yield _CONFIG
    finally:
        _CONFIG = prev


def resolve_config(cfg: DispatchConfig | None) -> DispatchConfig:
    """``cfg``, or the global config when it is None."""
    return get_config() if cfg is None else cfg


def choose_path(op: str, cfg: DispatchConfig, *, device: torch.device,
                op_elems: int | None = None) -> str:
    """Resolve 'auto' to a path; a conv above the limit goes factored
    under every config (a forced ``reference`` one included, unlike the
    reference package, which would materialise Ξ of any size)."""
    too_big = op == "conv" and op_elems is not None and op_elems > cfg.limit
    if cfg.path != "auto":
        return "factored" if too_big else cfg.path
    if too_big:
        return "factored"
    return "cuda" if torch.device(device).type == "cuda" else "reference"


def _runtime_path(path: str, cfg: DispatchConfig) -> str:
    return "reference" if path == "cuda" and cfg.path == "reference" else path


def _transform_path(cfg: DispatchConfig, device: torch.device) -> str:
    """Path of the block transforms: the kernel where the config resolves
    to ``cuda``; the plain version otherwise (a forced ``factored`` config
    included: the transforms have no factored form)."""
    p = choose_path("block_dct", cfg, device=device)
    return "cuda" if p == "cuda" else "reference"


# --------------------------------------------------------------------------
# Convolution
# --------------------------------------------------------------------------


class ConvOperator(NamedTuple):
    """A precomputed layer operator with its resolved apply path.

    ``xi`` is the band-truncated Ξ with any batch-norm scale folded into its
    output-channel axis (None on the factored path, which keeps ``kernel``
    and applies ``scale`` per step); ``shift`` is the folded DC bias.
    ``bn_scale`` keeps the folded scale even where Ξ absorbed it, as the
    reference's operator does (its spatial executor and the ladder re-derive
    a layer from ``kernel``); :func:`apply_conv` never applies it.
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
    bn_scale: torch.Tensor | None = None


def conv(coef: torch.Tensor, kernel: torch.Tensor, stride: int = 1, *,
         in_scaled: bool = False, out_scaled: bool = False,
         quality: int = 50,
         cfg: DispatchConfig | None = None) -> torch.Tensor:
    """Per-step JPEG-domain convolution (training): Ξ is exploded from the
    live ``kernel`` on every call, differentiably, and applied by the
    ``jpeg_conv`` kernel or its plain version; above the materialise
    limit the conv goes factored.  Returns 64-wide coefficients, zero
    above ``cfg.bands``."""
    from repro_torch.kernels import jpeg_conv as kjc

    cfg = resolve_config(cfg)
    path = choose_path("conv", cfg, device=coef.device,
                       op_elems=convlib.operator_elems(kernel.shape, stride,
                                                       cfg.bands))
    if path == "factored":
        return convlib._jpeg_conv_factored(
            coef, kernel, stride, quality=quality, in_scaled=in_scaled,
            out_scaled=out_scaled, bands=cfg.bands,
            path=_transform_path(cfg, coef.device))
    xi = convlib.explode(kernel, stride, quality=quality,
                         in_scaled=in_scaled, out_scaled=out_scaled,
                         bands=cfg.bands)
    fn = kjc.jpeg_conv if path == "cuda" else kjc.jpeg_conv_plain
    return fn(coef, xi, stride, w_out=dctlib.NFREQ)


def precompute_conv(kernel: torch.Tensor, stride: int = 1, *,
                    in_scaled: bool = False, out_scaled: bool = False,
                    quality: int = 50, bands: int | None = None,
                    scale: torch.Tensor | None = None,
                    shift: torch.Tensor | None = None,
                    cfg: DispatchConfig | None = None) -> ConvOperator:
    """Explode a layer once, on the kernel's device, resolving its path."""
    cfg = resolve_config(cfg)
    bands = cfg.bands if bands is None else bands
    path = choose_path("conv", cfg, device=kernel.device,
                       op_elems=convlib.operator_elems(kernel.shape, stride,
                                                       bands))
    xi = None
    bn_scale = scale
    if path != "factored":
        xi = convlib.explode(kernel, stride, quality=quality,
                             in_scaled=in_scaled, out_scaled=out_scaled,
                             bands=bands)
        if scale is not None:
            xi = xi * scale.to(xi)[None, None, None, None, :, None]
            scale = None
        # explode's einsum leaves Ξ permuted; the kernels read it
        # contiguous, so copy once here rather than on every launch
        xi = xi.contiguous()
    return ConvOperator(xi, kernel, stride, bands, quality, in_scaled,
                        out_scaled, path, scale, shift, bn_scale)


def apply_conv(coef: torch.Tensor, op: ConvOperator,
               cfg: DispatchConfig | None = None) -> torch.Tensor:
    """Apply an operator along its path → 64-wide coefficients (+ shift)."""
    from repro_torch.kernels import jpeg_conv as kjc

    cfg = resolve_config(cfg)
    path = _runtime_path(op.path, cfg)
    if path == "cuda":
        return kjc.jpeg_conv(coef, op.xi, op.stride, shift=op.shift,
                             w_out=dctlib.NFREQ)
    if path == "reference":
        return kjc.jpeg_conv_plain(coef, op.xi, op.stride, shift=op.shift,
                                   w_out=dctlib.NFREQ)
    out = convlib._jpeg_conv_factored(
        coef, op.kernel, op.stride, quality=op.quality,
        in_scaled=op.in_scaled, out_scaled=op.out_scaled, bands=op.bands,
        path=_transform_path(cfg, coef.device))
    if op.scale is not None:
        out = out * op.scale[None, None, None, :, None]
    if op.shift is not None:
        out[..., 0] += op.shift
    return out


# --------------------------------------------------------------------------
# Batch norm, block DCT / IDCT
# --------------------------------------------------------------------------


def batchnorm(coef: torch.Tensor, params: bnlib.BatchNormParams,
              state: bnlib.BatchNormState, *, training: bool,
              momentum: float = 0.1, eps: float = 1e-5):
    """Coefficient-domain batch norm → ``(out, new_state)``.  It has no
    kernel: elementwise work and per-channel sums in plain PyTorch on
    every path, as the reference leaves it to XLA."""
    return bnlib.batchnorm_jpeg(coef, params, state, training=training,
                                momentum=momentum, eps=eps)


def block_dct(blocks: torch.Tensor, quality: int | None = None,
              cfg: DispatchConfig | None = None, *,
              path: str | None = None) -> torch.Tensor:
    """``(..., 8, 8)`` pixel blocks → ``(..., 64)`` zigzag coefficients
    (divided by ``quality``'s table when given).  ``path`` ("cuda" or
    "reference") is the caller's resolution; None resolves from ``cfg``
    and the tensor's device."""
    from repro_torch.kernels import block_dct as kbd

    path = path or _transform_path(resolve_config(cfg), blocks.device)
    fn = kbd.block_dct if path == "cuda" else kbd.block_dct_plain
    return fn(blocks, quality)


def block_idct(coef: torch.Tensor, quality: int | None = None,
               cfg: DispatchConfig | None = None, *,
               path: str | None = None) -> torch.Tensor:
    """``(..., 64)`` zigzag coefficients → ``(..., 8, 8)`` pixel blocks;
    ``path`` as for :func:`block_dct`."""
    from repro_torch.kernels import block_dct as kbd

    path = path or _transform_path(resolve_config(cfg), coef.device)
    fn = kbd.block_idct if path == "cuda" else kbd.block_idct_plain
    return fn(coef, quality)


# --------------------------------------------------------------------------
# ASM ReLU and the fused block
# --------------------------------------------------------------------------


def asm_relu(coef: torch.Tensor, phi: int = asmlib.EXACT_PHI,
             cfg: DispatchConfig | None = None, *,
             bands: int | None = None) -> torch.Tensor:
    """ASM ReLU on ``(..., 64)`` coefficients at ``bands`` (default
    ``cfg.bands``); lanes above the cutoff come back zero."""
    from repro_torch.kernels import asm_relu as kasm

    cfg = resolve_config(cfg)
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
    if _runtime_path(path, resolve_config(cfg)) == "cuda":
        return kfb.fused_block(*args)
    return kfb.fused_block_reference(*args)
