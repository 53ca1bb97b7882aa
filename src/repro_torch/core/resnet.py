"""The JPEG-domain residual network's parameters (paper Fig. 3, generalised).

A stem conv, then ``len(widths)`` stages of ``blocks_per_stage`` basic
residual blocks (every stage after the first downsamples by 2), global
average pool, linear classifier.  Parameters are nested dicts of tensors
with the reference package's keys and layouts: conv kernels
``(Cout, Cin, r, r)``, batch norm ``gamma``/``beta`` in ``params`` and
``mean``/``var`` in ``state``, head ``w`` ``(C, classes)`` and ``b``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import asm as asmlib

__all__ = ["ResNetSpec", "init_resnet", "params_from_numpy", "_stages"]


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
