"""Random weights of a configuration, made on the device from the seed in a
few large draws, in the layout the program and the reference both read:
``params`` (conv kernels ``(Cout, Cin, r, r)``, batch norms' ``gamma`` and
``beta``, the head's ``w`` ``(C, classes)`` and ``b``) and ``state`` (batch
norms' running ``mean`` and ``var``)."""
from __future__ import annotations

import math

import torch

from perfbench.lib.spec import subseed
from perfbench.reference.resnet import stages


def resnet(cfg: dict, seed: int, device: torch.device):
    """He-normal convs, batch norms drawn near identity (so folding them
    is not trivial), a head scaled by sqrt(1/C)."""
    widths, c0 = cfg["widths"], cfg["in_channels"]
    convs = [("stem", "kernel", widths[0], c0, 3)]
    bns = [("stem_bn", widths[0])]
    for name, s, cin, w in stages(widths, cfg["blocks_per_stage"]):
        convs += [(name, "conv1", w, cin, 3), (name, "conv2", w, w, 3)]
        if s != 1 or cin != w:
            convs.append((name, "proj", w, cin, 1))
        bns += [(name + "_bn1", w), (name + "_bn2", w)]
    cls, ch = cfg["num_classes"], widths[-1]

    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, "weights"))
    n_conv = sum(o * i * r * r for *_, o, i, r in convs)
    n_bn = sum(c for _, c in bns)
    flat = torch.randn(n_conv, generator=g, device=device)
    norm = torch.randn(3 * n_bn + ch * cls + cls, generator=g, device=device)
    var = 0.5 + torch.rand(n_bn, generator=g, device=device)

    params: dict = {}
    state: dict = {}
    at = 0
    for name, slot, o, i, r in convs:
        k = flat[at: at + o * i * r * r].reshape(o, i, r, r)
        at += o * i * r * r
        k = k * math.sqrt(2.0 / (i * r * r))
        if slot == "kernel":
            params[name] = {"kernel": k}
        else:
            params.setdefault(name, {})[slot] = k
    at = vat = 0
    for name, c in bns:
        gb = norm[at: at + 3 * c].reshape(3, c)
        at += 3 * c
        params[name] = {"gamma": 1.0 + 0.1 * gb[0], "beta": 0.1 * gb[1]}
        state[name] = {"mean": 0.1 * gb[2], "var": var[vat: vat + c]}
        vat += c
    head = norm[at:]
    params["head"] = {"w": head[: ch * cls].reshape(ch, cls)
                      * math.sqrt(1.0 / ch),
                      "b": 0.1 * head[ch * cls:]}
    return _contiguous(params), _contiguous(state)


def _contiguous(tree: dict) -> dict:
    return {k: _contiguous(v) if isinstance(v, dict) else v.contiguous()
            for k, v in tree.items()}
