"""Model conversion: spatial-domain weights → a JPEG-domain network (paper
§4.6, Table 1).

One parameter tree drives both domains (``core.resnet``), so conversion is
the identity on parameters plus a verification contract: at φ = 14 (the
exact ReLU) the spatial and JPEG networks agree to float error.
:func:`convert_and_verify` holds a converted model to it on sample images,
which it encodes on the device through the block-DCT kernel (its plain
version on the CPU), as ``data.pipeline.jpeg_iterator`` does.

:func:`from_torch_layout` reads weights trained elsewhere: OIHW conv
kernels and batch norms as (γ, β, μ, σ²), relaid onto the port's tree.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import asm as asmlib
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import jpeg as jpeglib
from repro_torch.core import plan as planlib
from repro_torch.core import resnet as resnetlib

__all__ = ["ConvertedModel", "convert", "convert_and_verify",
           "from_torch_layout"]


class ConvertedModel(NamedTuple):
    """A converted network.  With a ``plan`` (the default) ``operators``
    are the plan's, batch norm fused, and ``__call__`` serves from the
    plan; feeding them to ``resnet.jpeg_apply_precomputed`` raises (batch
    norm would run twice).  ``convert(fuse_bn=False)`` keeps unfused
    operators and per-step batch norm, with ``plan=None``."""

    params: Any
    state: Any
    operators: Any
    spec: resnetlib.ResNetSpec
    phi: int
    dispatch: Any = None  # the DispatchConfig frozen at convert time
    plan: Any = None      # plan.InferencePlan, batch norm fused

    def __call__(self, coef: torch.Tensor) -> torch.Tensor:
        """``(N, bh, bw, C, 64)`` coefficients → logits."""
        if self.plan is not None:
            return planlib.apply_plan(self.plan, coef)
        return resnetlib.jpeg_apply_precomputed(
            self.params, self.state, self.operators, coef, spec=self.spec,
            phi=self.phi, dispatch=self.dispatch)


def convert(params, state, spec: resnetlib.ResNetSpec,
            phi: int = asmlib.EXACT_PHI,
            dispatch: dispatchlib.DispatchConfig | None = None, *,
            fuse_bn: bool = True, bands: Any = None,
            probe_coef: torch.Tensor | None = None,
            profile: np.ndarray | None = None,
            occupancy: np.ndarray | None = None) -> ConvertedModel:
    """Convert (trained) spatial weights for JPEG-domain inference, on the
    parameters' device.

    ``dispatch`` resolves every operator's path and band count; None
    freezes the global config now, so a later change of it cannot skew
    the model's ASM and batch norm away from its operators.  ``bands``,
    ``probe_coef``, ``profile`` and ``occupancy`` go to
    ``plan.build_plan`` (``"auto"`` autotunes per layer; a probe batch
    runs the parity sweep, a profile replaces the qtable prior).
    """
    cfg = dispatchlib.resolve_config(dispatch)
    if not fuse_bn:
        ops = resnetlib.precompute_operators(params, spec, dispatch=cfg)
        return ConvertedModel(params, state, ops, spec, phi, cfg)
    plan = planlib.build_plan(params, state, spec, phi=phi, dispatch=cfg,
                              bands=bands, probe_coef=probe_coef,
                              profile=profile, occupancy=occupancy)
    return ConvertedModel(params, state, plan.operators, spec, phi, cfg,
                          plan)


def convert_and_verify(params, state, spec: resnetlib.ResNetSpec,
                       sample_images: torch.Tensor,
                       phi: int = asmlib.EXACT_PHI, atol: float = 1e-4
                       ) -> tuple[ConvertedModel, float]:
    """Convert, then hold the spatial and JPEG logits on ``sample_images``
    (``(N, C, H, W)`` pixels on the parameters' device) to each other.

    Returns ``(model, max_abs_dev)``; raises ``ValueError`` when
    ``phi >= EXACT_PHI`` and the deviation exceeds ``atol``.  The pixels
    are encoded on the device (``dispatch.block_dct`` at the spec's
    quality, quantization-scaled) into ``(N, bh, bw, C, 64)``.
    """
    model = convert(params, state, spec, phi)
    images = torch.as_tensor(sample_images,
                             device=params["head"]["w"].device)
    with torch.inference_mode():
        logits_sp, _ = resnetlib.spatial_apply(params, state, images,
                                               training=False, spec=spec)
        coef = dispatchlib.block_dct(jpeglib.block_channels_last(images),
                                     spec.quality, model.dispatch)
        logits_jp = model(coef)
        dev = float((logits_sp - logits_jp).abs().max())
    if phi >= asmlib.EXACT_PHI and dev > atol:
        raise ValueError(f"conversion verification failed: max logit "
                         f"deviation {dev} > {atol}")
    return model, dev


def from_torch_layout(tensors: dict[str, Any], spec: resnetlib.ResNetSpec,
                      device: str | torch.device | None = None):
    """A ``{name: array}`` dict in torch's ResNet layout → ``(params,
    state)`` float32 tensors on ``device`` (default CUDA).

    Names per block: ``<block>.conv1.weight`` (OIHW), ``<block>.bn1.
    {weight, bias, running_mean, running_var}``, likewise ``conv2``/``bn2``
    and an optional ``<block>.proj.weight``; ``stem.weight``,
    ``stem_bn.*``, and ``head.weight`` ``(classes, C)`` / ``head.bias``.
    A relayout only: no arithmetic.
    """
    params: dict[str, Any] = {}
    state: dict[str, Any] = {}

    def grab_bn(src: str, dst: str) -> None:
        params[dst] = {"gamma": tensors[f"{src}.weight"],
                       "beta": tensors[f"{src}.bias"]}
        state[dst] = {"mean": tensors[f"{src}.running_mean"],
                      "var": tensors[f"{src}.running_var"]}

    params["stem"] = {"kernel": tensors["stem.weight"]}
    grab_bn("stem_bn", "stem_bn")
    for name, s, cin, w in resnetlib._stages(spec):
        entry = {"conv1": tensors[f"{name}.conv1.weight"],
                 "conv2": tensors[f"{name}.conv2.weight"]}
        if f"{name}.proj.weight" in tensors:
            entry["proj"] = tensors[f"{name}.proj.weight"]
        params[name] = entry
        grab_bn(f"{name}.bn1", f"{name}_bn1")
        grab_bn(f"{name}.bn2", f"{name}_bn2")
    params["head"] = {"w": tensors["head.weight"].T,
                      "b": tensors["head.bias"]}
    return resnetlib.params_from_numpy(params, state, device)
