"""Residual networks in the spatial and JPEG transform domains (paper §4).

A stem conv, then ``len(widths)`` stages of ``blocks_per_stage`` basic
residual blocks (every stage after the first downsamples by 2), global
average pool, linear classifier.  Parameters are nested dicts of tensors
with the reference package's keys and layouts: conv kernels
``(Cout, Cin, r, r)``, batch norm ``gamma``/``beta`` in ``params`` and
``mean``/``var`` in ``state``, head ``w`` ``(C, classes)`` and ``b``.

One parameter tree drives two equivalent apply functions:
:func:`spatial_apply`, the ordinary NCHW network (the oracle), and
:func:`jpeg_apply`, the same network on JPEG coefficients through
``core.dispatch`` — the training forward.  Inference runs the fused plan
(``core.plan``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import asm as asmlib
from repro_torch.core import batchnorm as bnlib
from repro_torch.core import conv as convlib
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import pooling as poollib

__all__ = ["ResNetSpec", "init_resnet", "params_from_numpy", "spatial_apply",
           "jpeg_apply", "_stages"]


class ResNetSpec(NamedTuple):
    in_channels: int = 3
    widths: tuple[int, ...] = (16, 32, 64)
    blocks_per_stage: int = 1
    num_classes: int = 10
    quality: int = 50  # quantization table the input coefficients use
    phi: int = asmlib.EXACT_PHI  # ASM ReLU spatial frequencies


def _stages(spec: ResNetSpec):
    """``(name, stride, cin, cout)`` of every residual block, in order."""
    cin = spec.widths[0]
    for si, w in enumerate(spec.widths):
        stride = 1 if si == 0 else 2
        for bi in range(spec.blocks_per_stage):
            s = stride if bi == 0 else 1
            yield f"s{si}b{bi}", s, cin, w
            cin = w


def init_resnet(generator: torch.Generator, spec: ResNetSpec,
                device: str | torch.device | None = None,
                dtype: torch.dtype = torch.float32):
    """Random ``(params, state)`` with the reference initialiser's
    distributions (He-normal convs, identity batch norms, head scaled by
    ``sqrt(1/C)``), drawn on the CPU from ``generator`` and then moved to
    ``device`` — the same seed gives the same weights on every device."""
    dev = resolve_device(device)
    params: dict[str, Any] = {}
    state: dict[str, Any] = {}

    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=dtype)

    def conv(cout, cin, r):
        return normal(cout, cin, r, r) * float(np.sqrt(2.0 / (cin * r * r)))

    def bn(name, c):
        params[name] = {"gamma": torch.ones(c, dtype=dtype),
                        "beta": torch.zeros(c, dtype=dtype)}
        state[name] = {"mean": torch.zeros(c, dtype=dtype),
                       "var": torch.ones(c, dtype=dtype)}

    params["stem"] = {"kernel": conv(spec.widths[0], spec.in_channels, 3)}
    bn("stem_bn", spec.widths[0])
    for name, s, cin, w in _stages(spec):
        params[name] = {"conv1": conv(w, cin, 3), "conv2": conv(w, w, 3)}
        bn(name + "_bn1", w)
        bn(name + "_bn2", w)
        if s != 1 or cin != w:
            params[name]["proj"] = conv(w, cin, 1)
    cin = spec.widths[-1]
    params["head"] = {"w": normal(cin, spec.num_classes)
                      * float(np.sqrt(1.0 / cin)),
                      "b": torch.zeros(spec.num_classes, dtype=dtype)}
    return _to(params, dev), _to(state, dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def params_from_numpy(params: Any, state: Any,
                      device: str | torch.device | None = None):
    """The reference package's ``(params, state)`` trees (nested dicts of
    arrays, converted to numpy) as the port's trees of float32 tensors."""
    dev = resolve_device(device)
    return _to(params, dev), _to(state, dev)


def _bn_args(params, state, name):
    return (bnlib.BatchNormParams(params[name]["gamma"], params[name]["beta"]),
            bnlib.BatchNormState(state[name]["mean"], state[name]["var"]))


def _state_dict(s: bnlib.BatchNormState) -> dict[str, torch.Tensor]:
    return {"mean": s.running_mean, "var": s.running_var}


def spatial_apply(params, state, x: torch.Tensor, *, training: bool,
                  spec: ResNetSpec):
    """``x``: ``(N, C, H, W)`` pixels → ``(logits, new_state)``."""
    new_state = {}

    def bn(name, h):
        h, s2 = bnlib.batchnorm_spatial(h, *_bn_args(params, state, name),
                                        training=training)
        new_state[name] = _state_dict(s2)
        return h

    h = convlib.spatial_conv(x, params["stem"]["kernel"], 1)
    h = F.relu(bn("stem_bn", h))
    for name, s, cin, w in _stages(spec):
        blk = params[name]
        short = h
        if "proj" in blk:
            short = convlib.spatial_conv(h, blk["proj"], s)
        h = convlib.spatial_conv(h, blk["conv1"], s)
        h = F.relu(bn(name + "_bn1", h))
        h = convlib.spatial_conv(h, blk["conv2"], 1)
        h = bn(name + "_bn2", h)
        h = F.relu(h + short)
    pooled = poollib.global_avg_pool_spatial(h)
    return pooled @ params["head"]["w"] + params["head"]["b"], new_state


def jpeg_apply(params, state, coef: torch.Tensor, *, training: bool,
               spec: ResNetSpec, phi: int | None = None, remat: bool = False,
               dispatch: dispatchlib.DispatchConfig | None = None):
    """``coef``: ``(N, bh, bw, C, 64)`` quantization-scaled JPEG
    coefficients → ``(logits, new_state)``.

    The stem conv folds de-quantization; every later activation is in the
    orthonormal-DCT convention.  Convs go through ``dispatch.conv``
    (exploded Ξ, or factored above the limit), ReLUs through the ASM
    ReLU, batch norms through the coefficient statistics.  ``remat``
    recomputes each residual block in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its intermediates.
    """
    phi = spec.phi if phi is None else phi
    cfg = dispatchlib.resolve_config(dispatch)
    new_state = {}

    def bn(name, h):
        h, s2 = dispatchlib.batchnorm(h, *_bn_args(params, state, name),
                                      training=training)
        new_state[name] = _state_dict(s2)
        return h

    def relu(h):
        return dispatchlib.asm_relu(h, phi, cfg=cfg)

    h = dispatchlib.conv(coef, params["stem"]["kernel"], 1, in_scaled=True,
                         quality=spec.quality, cfg=cfg)
    h = relu(bn("stem_bn", h))
    for name, s, cin, w in _stages(spec):

        def block_fn(h, name=name, s=s):
            blk = params[name]
            short = h
            if "proj" in blk:
                short = dispatchlib.conv(h, blk["proj"], s, cfg=cfg)
            h, st1 = dispatchlib.batchnorm(
                dispatchlib.conv(h, blk["conv1"], s, cfg=cfg),
                *_bn_args(params, state, name + "_bn1"), training=training)
            h = dispatchlib.conv(relu(h), blk["conv2"], 1, cfg=cfg)
            h, st2 = dispatchlib.batchnorm(
                h, *_bn_args(params, state, name + "_bn2"),
                training=training)
            return relu(poollib.residual_add(h, short)), st1, st2

        if remat:
            h, st1, st2 = checkpoint(block_fn, h, use_reentrant=False)
        else:
            h, st1, st2 = block_fn(h)
        new_state[name + "_bn1"] = _state_dict(st1)
        new_state[name + "_bn2"] = _state_dict(st2)
    pooled = poollib.global_avg_pool_jpeg(h)
    return pooled @ params["head"]["w"] + params["head"]["b"], new_state
