"""Architecture registry: one interface over the model families.

``build_model(cfg)`` returns a :class:`Model` bundle of functions; the
trainer talks only to it.  The port has the jpeg-resnet family alone: the
reference's language models wait for the LM model zoo (ROADMAP Queue 1
item 7).  A model's trainable state is the bundle ``{"params",
"bn_state"}``, as in the reference, which differentiates both.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.core import dispatch as dispatchlib

__all__ = ["Model", "build_model", "count_params", "jpeg_resnet_spec"]


class Model(NamedTuple):
    cfg: ModelConfig
    init_params: Callable[..., Any]  # (generator, device) -> bundle
    loss_fn: Callable[..., Any]      # (bundle, batch) -> (loss, metrics)
    forward: Callable[..., Any]      # (bundle, batch) -> (logits, aux)


def jpeg_resnet_spec(cfg: ModelConfig):
    """The ``ResNetSpec`` a jpeg-resnet ``ModelConfig`` describes."""
    from repro_torch.configs.jpeg_resnet import spec_of

    return spec_of(cfg)


def _jpeg_resnet_model(cfg: ModelConfig, remat: str,
                       dispatch: dispatchlib.DispatchConfig | None) -> Model:
    from repro_torch.core import resnet as R

    spec = jpeg_resnet_spec(cfg)
    use_remat = remat != "none"

    def init_params(generator: torch.Generator, device=None):
        params, state = R.init_resnet(generator, spec, device)
        return {"params": params, "bn_state": state}

    def loss(bundle, batch):
        logits, new_state = R.jpeg_apply(
            bundle["params"], bundle["bn_state"], batch["coefficients"],
            training=True, spec=spec, remat=use_remat, dispatch=dispatch)
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -logp.gather(-1, batch["labels"][:, None].long())
        value = nll.mean()
        return value, {"loss": value, "bn_state": new_state}

    def fwd(bundle, batch):
        logits, _ = R.jpeg_apply(
            bundle["params"], bundle["bn_state"], batch["coefficients"],
            training=False, spec=spec, dispatch=dispatch)
        return logits, 0.0

    return Model(cfg, init_params, loss, fwd)


def build_model(cfg: ModelConfig, remat: str = "none", *,
                dispatch: dispatchlib.DispatchConfig | None = None) -> Model:
    """The model bundle for ``cfg``; ``dispatch`` picks the op paths of its
    forward (None: ``auto``, the kernels on a CUDA device).  Configs of
    the reference's language models are refused earlier, by
    ``configs.get_config``."""
    return _jpeg_resnet_model(cfg, remat, dispatch)


def count_params(tree: Any) -> int:
    from repro_torch.tree import leaves

    return int(sum(t.numel() for t in leaves(tree)))
