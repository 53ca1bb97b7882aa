"""Architecture registry: one interface over the model families.

``build_model(cfg)`` returns a :class:`Model` bundle of functions; the
trainer and the server talk only to it.  Two kinds of model: ``jpeg_resnet``
(whose trainable state is the bundle ``{"params", "bn_state"}``, as in the
reference, which differentiates both) and the language models of every
family of the reference: dense, MoE (``granite-moe-3b-a800m``,
``mixtral-8x7b``), Mamba hybrid (``jamba-v0.1-52b``), RWKV (``rwkv6-7b``),
VLM (``internvl2-1b``, whose batches carry ``vision_embeds``) and
encoder-decoder audio (``whisper-small``, whose batches carry ``frames``).
They train (``loss_fn``, an MoE's aux term included, with the reference's
``remat`` values) and serve: ``prefill`` a prompt, then ``decode_step``
from its cache (for audio, prefill is the encoder forward).

Under mesh rules (``launch/steps.py``'s training step) ``loss_fn`` runs on
this rank's rows and parameter slices: a language model as
``models/transformer.py`` says; ``jpeg-resnet`` gathers its few cut leaves
(the head, over ``model``) whole and takes its batch norms' statistics
over every rank's rows, as the reference shards only its batch.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.core import dispatch as dispatchlib
from repro_torch.parallel.sharding import active_rules, gather_tree

__all__ = ["Model", "build_model", "input_specs", "count_params",
           "jpeg_resnet_spec", "param_shapes"]


class Model(NamedTuple):
    cfg: ModelConfig
    init_params: Callable[..., Any]  # (generator, device) -> params
    loss_fn: Callable[..., Any]      # (params, batch) -> (loss, metrics)
    forward: Callable[..., Any]      # (params, batch) -> (logits, aux)
    init_cache: Callable[..., Any] | None = None  # (batch, seq, device)
    decode_step: Callable[..., Any] | None = None  # (params, cache, batch)
    prefill: Callable[..., Any] | None = None  # (params, batch, pad_to)


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
        if active_rules() is not None:
            bundle = gather_tree(bundle)
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


def _lm_model(cfg: ModelConfig, remat: str,
              dispatch: dispatchlib.DispatchConfig | None) -> Model:
    from repro_torch.models import transformer as T

    if remat not in T.REMAT:
        raise ValueError(f"remat must be one of {T.REMAT}, got {remat!r}")
    plain = dispatch is not None and dispatch.path == "reference"

    def init_params(generator: torch.Generator, device=None):
        return T.init_params(generator, cfg, device)

    def loss(params, batch):
        return T.loss_fn(params, cfg, batch, plain=plain, remat=remat)

    def fwd(params, batch):
        return T.forward(params, cfg, batch, plain=plain)

    def init_cache(batch: int, seq: int, device=None):
        return T.init_cache(cfg, batch, seq, device)

    def dstep(params, cache, batch):
        return T.decode_step(params, cfg, cache, batch)

    def pfill(params, batch, pad_to=None):
        return T.prefill(params, cfg, batch, pad_to=pad_to, plain=plain)

    return Model(cfg, init_params, loss, fwd, init_cache, dstep, pfill)


def build_model(cfg: ModelConfig, remat: str = "none", *,
                dispatch: dispatchlib.DispatchConfig | None = None) -> Model:
    """The model bundle for ``cfg``.  ``dispatch`` picks the op paths of
    its forward (None: ``auto``, the kernels on a CUDA device); for a
    language model a ``reference`` path runs the plain attention (and
    RWKV's plain scan) on any device."""
    if cfg.family == "jpeg_resnet":
        return _jpeg_resnet_model(cfg, remat, dispatch)
    return _lm_model(cfg, remat, dispatch)


def input_specs(cfg: ModelConfig, batch: int, seq: int,
                kind: str) -> dict[str, np.ndarray]:
    """Zero host batches of one cell: ``kind`` 'train' or 'prefill' gives
    the full sequence (with labels for 'train'), 'decode' one token per
    sequence (the cache comes from ``Model.init_cache``); jpeg-resnet
    takes coefficients and labels.  As in the reference, the audio family
    takes ``seq`` frames and ``max(seq // 8, 8)`` tokens, a VLM
    ``vision_prefix_len`` patch embeddings and ``seq - vision_prefix_len``
    tokens; frames and embeddings are fp32 here (numpy has no bf16: the
    model casts them to its dtype)."""
    if cfg.family == "jpeg_resnet":
        n = cfg.image_size // 8
        return {"coefficients": np.zeros((batch, n, n, cfg.in_channels, 64),
                                         np.float32),
                "labels": np.zeros((batch,), np.int32)}
    if kind == "decode":
        return {"tokens": np.zeros((batch, 1), np.int32)}
    out = {}
    if cfg.family == "audio":
        out["frames"] = np.zeros((batch, seq, cfg.d_model), np.float32)
        seq = max(seq // 8, 8)
    elif cfg.family == "vlm":
        out["vision_embeds"] = np.zeros(
            (batch, cfg.vision_prefix_len, cfg.d_model), np.float32)
        seq -= cfg.vision_prefix_len
    out["tokens"] = np.zeros((batch, seq), np.int32)
    if kind == "train":
        out["labels"] = np.zeros((batch, seq), np.int32)
    return out


def count_params(tree: Any) -> int:
    from repro_torch.tree import leaves

    return int(sum(t.numel() for t in leaves(tree)))


def param_shapes(model: Model) -> Any:
    """The tree of ``model``'s parameters as meta tensors (full shapes and
    dtypes, nothing allocated: ``init_params`` under a fake-tensor mode),
    the counterpart of the reference's ``jax.eval_shape(init_params)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.tree import leaves, tree_map

    with FakeTensorMode():
        fake = model.init_params(torch.Generator(), "cpu")
        meta = iter([(tuple(t.shape), t.dtype) for t in leaves(fake)])

    def leaf(_):
        shape, dtype = next(meta)
        return torch.empty(shape, dtype=dtype, device="meta")

    return tree_map(leaf, fake)
