"""Plain reference of the training step: the spatial network's
cross-entropy, its gradient by autograd, global-norm clipping and AdamW
with float32 master weights, written from the published update rules
(Loshchilov and Hutter, 2019) in plain PyTorch."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import resnet


def leaves(tree, prefix=""):
    """``[(path, tensor)]`` of a nested dict, depth first in key order."""
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out += leaves(v, p) if isinstance(v, dict) else [(p, v)]
    return out


def rebuild(tree, flat, prefix=""):
    """A tree shaped like ``tree`` of the leaves ``flat`` holds by path."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out[k] = rebuild(v, flat, p) if isinstance(v, dict) else flat[p]
    return out


def steps(bundle, batches, *, widths, blocks_per_stage: int, lr: float,
          b1: float, b2: float, eps: float, weight_decay: float,
          clip: float, precision: str = "fp32",
          dtype: torch.dtype = torch.float32) -> dict:
    """Run ``len(batches)`` steps from ``bundle`` (``{"params", "bn_state"}``
    trees; not modified) in ``dtype`` on ``batches`` (``(coef, labels)`` with
    ``coef`` orthonormal coefficients).  Returns the losses, the first
    step's clipped gradient and the parameters after the last step, each
    a ``{path: tensor}``."""
    master = {p: t.detach().to(dtype).clone() for p, t in leaves(bundle)}
    m = {p: torch.zeros_like(t) for p, t in master.items()}
    v = {p: torch.zeros_like(t) for p, t in master.items()}
    losses, grad1 = [], None
    for t, (coef, labels) in enumerate(batches, start=1):
        coef = coef.to(dtype)
        live = {p: x.clone().requires_grad_(True) for p, x in master.items()}
        tree = rebuild(bundle, live)
        logits = resnet.forward(tree["params"], tree["bn_state"], coef,
                                widths=widths,
                                blocks_per_stage=blocks_per_stage,
                                training=True, precision=precision)
        loss = -F.log_softmax(logits, dim=-1).gather(
            -1, labels[:, None].long()).mean()
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        g = {p: torch.zeros_like(x) if gr is None else gr
             for (p, x), gr in zip(live.items(), grads)}
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
        g = {p: x * scale for p, x in g.items()}
        if grad1 is None:
            grad1 = {p: x.detach().clone() for p, x in g.items()}
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for p in master:
                m[p] = b1 * m[p] + (1 - b1) * g[p]
                v[p] = b2 * v[p] + (1 - b2) * g[p] * g[p]
                upd = (m[p] / c1) / (torch.sqrt(v[p] / c2) + eps)
                master[p] = master[p] - lr * (upd + weight_decay * master[p])
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "params": master}


def leaf_norm_gaps(prog: dict, ref: dict, keep) -> list[float]:
    """Per leaf in ``keep``: the gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    rn = {p: float(torch.linalg.vector_norm(ref[p].double())) for p in keep}
    med = sorted(rn.values())[len(rn) // 2]
    out = []
    for p in keep:
        pn = float(torch.linalg.vector_norm(prog[p].double()))
        den = max(rn[p], med)
        out.append(abs(pn - rn[p]) / den if den > 0
                   else (math.inf if pn > 0 else 0.0))
    return out


def moved(grad: dict) -> list[str]:
    """The leaves the reference's first gradient moves: a norm of at least
    a thousandth of the median leaf's.  The others (batch norm's running
    statistics, which the loss does not read) move under AdamW by weight
    decay alone."""
    n = {p: float(torch.linalg.vector_norm(g.double()))
         for p, g in grad.items()}
    med = sorted(n.values())[len(n) // 2]
    return [p for p, v in n.items() if v >= 1e-3 * med]


def checks(losses1: tuple, grad1: tuple, change: tuple) -> dict:
    """The numbers a training run is judged by, each ``(program,
    reference)``: the first step's loss gap, and the worst moved leaf's
    gaps of the first gradient's norm and of the parameters' change after
    the steps followed."""
    keep = moved(grad1[1])
    (lp, lr) = losses1
    return {"loss1_gap": abs(lp - lr) / abs(lr),
            "grad_norm_gap_worst": max(leaf_norm_gaps(*grad1, keep)),
            "change_norm_gap": max(leaf_norm_gaps(*change, keep))}
