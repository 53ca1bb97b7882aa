"""The dense decoder-only LM stack: forward, prefill and decode.

A port of the dense subset of ``repro/models/transformer.py``.  Parameters
keep the reference's stacked layout: layers grouped into repetitions of a
``pattern_period`` (1 for a dense model), each parameter of position ``j``
stacked over the repetitions under ``blocks/pos{j}`` with a leading
``(n_periods, ...)`` axis; decode caches are stacked the same way, so
checkpoint leaf paths read the same in both packages.  A Python loop over
the layers takes the place of ``lax.scan``.

Full-sequence attention (forward, loss and prefill) runs
``kernels/flash_attention.py``: the kernel on the card, with its
hand-written backward when autograd asks for a gradient, and its plain
version on the CPU or with ``plain=True``.  Decode attends its single token
with a dense product over the cache, as the reference does.  ``loss_fn``
takes the reference's ``remat`` values (``none``, ``full``, ``dots``,
``outputs``) through ``torch.utils.checkpoint``.

Unlike the reference's pure functions, :func:`decode_step` writes the new
token's keys and values into the cache's tensors in place (the returned
cache shares them and carries the next index).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

__all__ = ["REMAT", "layer_kinds", "pattern_period", "padded_vocab",
           "init_params", "cast_params", "lm_params_from_numpy", "forward",
           "prefill", "loss_fn", "init_cache", "decode_step"]

#: the reference's recomputation policies (``transformer.py:_run_stack``)
REMAT = ("none", "full", "dots", "outputs")


# --------------------------------------------------------------------------
# Layer pattern
# --------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """Per-layer (mixer, ffn) kinds: attention and a dense FFN throughout
    for the dense family, the only LM family the port runs."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs dense language models "
            f"only (ROADMAP Queue 1 items 7.3-7.5)")
    return [("attn", "dense")] * cfg.n_layers


def pattern_period(cfg: ModelConfig) -> int:
    kinds = layer_kinds(cfg)
    for p in range(1, len(kinds) + 1):
        if len(kinds) % p == 0 and all(
                kinds[i] == kinds[i % p] for i in range(len(kinds))):
            return p
    return len(kinds)


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256, as in the reference; logits are
    sliced back to the true vocab and padded embedding rows are never
    gathered."""
    return -(-cfg.vocab_size // 256) * 256


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> dict:
    """Random parameters in the reference's layout and scales: every
    projection ``normal · fan_in^-0.5`` in ``cfg.dtype``, norms ones in
    fp32.  Drawn in fp32 on ``generator``'s device, then moved to
    ``device`` (default: the generator's)."""
    dtype = L.resolve_dtype(cfg.dtype)
    dev = torch.device(device) if device is not None else generator.device
    period = pattern_period(cfg)
    n = cfg.n_layers // period
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def layer():
        return {
            "ln1": ones(n, d),
            "attn": {"q_proj": normal((n, d, cfg.q_dim), d ** -0.5),
                     "k_proj": normal((n, d, cfg.kv_dim), d ** -0.5),
                     "v_proj": normal((n, d, cfg.kv_dim), d ** -0.5),
                     "o_proj": normal((n, cfg.q_dim, d), cfg.q_dim ** -0.5)},
            "ln2": ones(n, d),
            "ffn": {"w_gate": normal((n, d, f), d ** -0.5),
                    "w_in": normal((n, d, f), d ** -0.5),
                    "w_out": normal((n, f, d), f ** -0.5)},
        }

    params: dict[str, Any] = {
        "embed": normal((padded_vocab(cfg), d), d ** -0.5),
        "blocks": {f"pos{j}": layer() for j in range(period)},
        "ln_f": ones(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((d, padded_vocab(cfg)), d ** -0.5)
    return params


def cast_params(params: dict, dtype: torch.dtype,
                device: torch.device | str | None = None) -> dict:
    """``params`` with every weight in ``dtype`` and every norm (a key
    starting with ``ln``) in fp32, as the reference keeps them."""
    def cast(key: str, x: Any) -> Any:
        if isinstance(x, dict):
            return {k: cast(k, v) for k, v in x.items()}
        want = torch.float32 if key.startswith("ln") else dtype
        return x.to(device=device if device is not None else x.device,
                    dtype=want)

    return {k: cast(k, v) for k, v in params.items()}


def lm_params_from_numpy(tree: dict, *, device=None,
                         dtype: torch.dtype = torch.float32) -> dict:
    """The reference's LM parameters as numpy arrays (bf16 ones widened to
    fp32 first) → the port's tree, weights in ``dtype`` and norms in fp32,
    on ``device`` (:func:`~repro_torch.resolve_device`: the CUDA device
    unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    host = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    tree)
    return cast_params(host, dtype, dev)


def _layer(blocks: dict, j: int, i: int) -> dict:
    """Position ``j``'s parameters of repetition ``i`` (views)."""
    return tree_map(lambda x: x[i], blocks[f"pos{j}"])


# --------------------------------------------------------------------------
# Full-sequence layers
# --------------------------------------------------------------------------


def _attn_block(h, p, cfg: ModelConfig, positions, *, causal, window,
                want_cache=False, plain=False):
    b, s, _ = h.shape
    q = (h @ p["q_proj"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["k_proj"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["v_proj"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    kv_cache = None
    if want_cache:
        t = s if window is None else min(s, window)
        kv_cache = {"k": k[:, s - t:], "v": v[:, s - t:]}
    out = L.attention(q, k, v, causal=causal, window=window, plain=plain)
    return out.reshape(b, s, cfg.q_dim) @ p["o_proj"], kv_cache


def _mixer(h, p, cfg: ModelConfig, positions, *, causal, want_cache=False,
           plain=False):
    """The attention sub-block of a layer: norm, attention, projection →
    (its output, the reference's ``mixer_out``; cache or None)."""
    return _attn_block(L.rms_norm(h, p["ln1"], cfg.norm_eps), p["attn"], cfg,
                       positions, causal=causal, window=cfg.sliding_window,
                       want_cache=want_cache, plain=plain)


def _ffn(h, p, cfg: ModelConfig):
    """The FFN sub-block of a layer (its output is ``ffn_out``)."""
    f = p["ffn"]
    return L.swiglu_mlp(L.rms_norm(h, p["ln2"], cfg.norm_eps), f["w_gate"],
                        f["w_in"], f["w_out"])


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's ``dots``: keep the outputs of matrix
    products without batch dims (the reference's
    ``checkpoint_dots_with_no_batch_dims``), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(fn, *args, policy=None):
    """``fn(*args)`` recomputed in the backward (non-reentrant), keeping
    what ``policy`` saves."""
    from torch.utils import checkpoint as ckpt

    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def _apply_layer(h, p, cfg: ModelConfig, kind: tuple[str, str], positions,
                 *, causal=True, want_cache=False, plain=False,
                 remat="none"):
    """Full-sequence layer (forward / prefill) → (h, aux, cache or None).
    ``remat="outputs"`` checkpoints the attention and FFN sub-blocks each
    on its own, so their outputs are what the backward keeps."""
    if remat == "outputs":
        a = _checkpoint(lambda x: _mixer(x, p, cfg, positions, causal=causal,
                                         plain=plain)[0], h)
        h = h + a
        return h + _checkpoint(lambda x: _ffn(x, p, cfg), h), 0.0, None
    a, cache = _mixer(h, p, cfg, positions, causal=causal,
                      want_cache=want_cache, plain=plain)
    h = h + a
    return h + _ffn(h, p, cfg), 0.0, cache


def _run_stack(h, blocks, cfg: ModelConfig, kinds, period, positions, *,
               causal=True, want_cache=False, cache_len=None, plain=False,
               remat="none"):
    """All layers in order → (h, total aux, caches or None).

    ``remat`` (:data:`REMAT`) recomputes in the backward: ``full`` each
    repetition of the pattern whole, ``dots`` the same keeping the matrix
    products' outputs, ``outputs`` each sub-block keeping its output.  With
    ``want_cache`` each layer's keys and values are written into stacked
    ``(n_periods, B, T, KVH, hd)`` caches allocated at the first layer,
    ``T`` the larger of the layer's cache length and ``cache_len`` (the
    slots past it stay zero)."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    n_periods = cfg.n_layers // period
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: dict[str, dict[str, torch.Tensor]] = {}

    def body(x, i):
        """Repetition ``i`` → (x, its aux, each position's cache)."""
        aux_i, out = 0.0, []
        for j in range(period):
            x, a, c = _apply_layer(
                x, _layer(blocks, j, i), cfg, kinds[j], positions,
                causal=causal, want_cache=want_cache, plain=plain,
                remat="outputs" if remat == "outputs" else "none")
            aux_i = aux_i + a
            out.append(c)
        return x, aux_i, out

    for i in range(n_periods):
        if remat in ("full", "dots"):
            h, a = _checkpoint(lambda x, i=i: body(x, i)[:2], h,
                               policy=_dots_policy if remat == "dots"
                               else None)
            aux = aux + a
            continue
        h, a, out = body(h, i)
        aux = aux + a
        for j, c in enumerate(out if want_cache else ()):
            if i == 0:
                b, t = c["k"].shape[:2]
                shape = (n_periods, b, max(t, cache_len or 0)) \
                    + tuple(c["k"].shape[2:])
                caches[f"pos{j}"] = {
                    n: torch.zeros(shape, dtype=c[n].dtype,
                                   device=c[n].device) for n in c}
            for n, x in c.items():
                caches[f"pos{j}"][n][i, :, :x.shape[1]] = x
    return h, aux, (caches if want_cache else None)


def _embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()]


def _lm_head(params, cfg: ModelConfig, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = (h @ w).float()
    if logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(params, cfg: ModelConfig, batch: dict, *, plain: bool = False,
            remat: str = "none"):
    """Full-sequence forward of ``batch['tokens']`` (B, S) → (logits (B, S,
    V) fp32, aux), differentiable on the card and on the CPU; ``remat``
    (:data:`REMAT`) picks what the backward recomputes."""
    tokens = batch["tokens"]
    h = _embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    h, aux, _ = _run_stack(h, params["blocks"], cfg, layer_kinds(cfg),
                           pattern_period(cfg), _positions(b, s, h.device),
                           causal=True, plain=plain, remat=remat)
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, cfg, h), aux


def prefill(params, cfg: ModelConfig, batch: dict, pad_to: int | None = None,
            *, plain: bool = False):
    """Serving prefill: the prompt ``batch['tokens']`` (B, S) in one pass →
    (last-token logits (B, 1, V), cache).  The cache matches
    :func:`init_cache`'s layout and carries ``index`` = S; ``pad_to`` grows
    full-attention caches to that many slots so decode steps have room to
    write (sliding-window caches are ring buffers and are not grown)."""
    tokens = batch["tokens"]
    h = _embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    grow = pad_to if cfg.sliding_window is None else None
    h, _, caches = _run_stack(h, params["blocks"], cfg, layer_kinds(cfg),
                              pattern_period(cfg),
                              _positions(b, s, h.device), causal=True,
                              want_cache=True, cache_len=grow, plain=plain)
    h = L.rms_norm(h[:, -1:], params["ln_f"], cfg.norm_eps)
    caches["index"] = torch.tensor(s, dtype=torch.int32, device=h.device)
    return _lm_head(params, cfg, h), caches


def loss_fn(params, cfg: ModelConfig, batch: dict, *,
            aux_weight: float = 0.01, plain: bool = False,
            remat: str = "none"):
    """Next-token cross-entropy of ``forward`` against ``batch['labels']``
    (masked by ``batch['loss_mask']`` when given) → (loss, metrics), as the
    reference computes it; differentiable, with ``remat`` as in
    :func:`forward`."""
    logits, aux = forward(params, cfg, batch, plain=plain, remat=remat)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
        loss = nll.sum() / torch.clamp(mask.sum(), min=1)
    else:
        loss = nll.mean()
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: torch.device | str | None = None) -> dict:
    """Zero decode cache, stacked per pattern repetition, index 0."""
    dtype = L.resolve_dtype(cfg.dtype)
    period = pattern_period(cfg)
    n_periods = cfg.n_layers // period
    t = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
    shape = (n_periods, batch, t, cfg.n_kv_heads, cfg.head_dim)
    cache: dict[str, Any] = {
        f"pos{j}": {n: torch.zeros(shape, dtype=dtype, device=device)
                    for n in ("k", "v")} for j in range(period)}
    cache["index"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _attn_decode(h, p, cfg: ModelConfig, cache, index):
    """One-token attention, writing the token's k/v into ``cache`` in
    place.  ``h``: (B, 1, D); ``index``: 0-d int32 tensor."""
    b = h.shape[0]
    q = (h @ p["q_proj"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = (h @ p["k_proj"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["v_proj"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        pos = index.reshape(1, 1).expand(b, 1)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    t = cache["k"].shape[1]
    write_at = (index % t).reshape(1).long()  # a ring buffer for SWA
    cache["k"].index_copy_(1, write_at, k)
    cache["v"].index_copy_(1, write_at, v)
    cache_len = torch.clamp(index + 1, max=t)
    out = L.decode_attention(q, cache["k"], cache["v"], cache_len)
    return out.reshape(b, 1, cfg.q_dim) @ p["o_proj"]


def _decode_layer(h, p, cfg: ModelConfig, kind, cache, index):
    h = h + _attn_decode(L.rms_norm(h, p["ln1"], cfg.norm_eps), p["attn"],
                         cfg, cache, index)
    f = p["ffn"]
    return h + L.swiglu_mlp(L.rms_norm(h, p["ln2"], cfg.norm_eps),
                            f["w_gate"], f["w_in"], f["w_out"])


def decode_step(params, cfg: ModelConfig, cache: dict, batch: dict):
    """One token for every sequence: ``batch['tokens']`` (B, 1) → (logits
    (B, 1, V), cache).  The layer caches are written in place; the
    returned cache holds the same tensors and ``index`` + 1."""
    h = _embed_tokens(params, cfg, batch["tokens"])
    kinds = layer_kinds(cfg)
    period = pattern_period(cfg)
    index = cache["index"]
    for i in range(cfg.n_layers // period):
        for j in range(period):
            c = {n: x[i] for n, x in cache[f"pos{j}"].items()}
            h = _decode_layer(h, _layer(params["blocks"], j, i), cfg,
                              kinds[j], c, index)
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["index"] = index + 1
    return _lm_head(params, cfg, h), new_cache
