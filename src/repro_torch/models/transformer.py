"""The decoder-only LM stack: forward, prefill and decode of the dense,
MoE and Mamba-hybrid families.

A port of ``repro/models/transformer.py`` without its recurrent (RWKV),
VLM and audio branches.  Each layer has a mixer (attention or Mamba) and an
FFN (dense SwiGLU or MoE), by :func:`layer_kinds`.  Parameters keep the
reference's stacked layout: layers grouped into repetitions of a
``pattern_period`` (1 for a uniform stack, 8 for Jamba), each parameter of
position ``j`` stacked over the repetitions under ``blocks/pos{j}`` with a
leading ``(n_periods, ...)`` axis; decode caches are stacked the same way,
so checkpoint leaf paths read the same in both packages.  A Python loop
over the layers takes the place of ``lax.scan``.  The MoE layers' aux
loss is summed over the stack; ``loss_fn`` adds ``aux_weight`` times it.

Full-sequence attention (forward, loss and prefill) runs
``kernels/flash_attention.py``: the kernel on the card, with its
hand-written backward when autograd asks for a gradient, and its plain
version on the CPU or with ``plain=True``.  Decode attends its single token
with a dense product over the cache, as the reference does.  ``loss_fn``
takes the reference's ``remat`` values (``none``, ``full``, ``dots``,
``outputs``) through ``torch.utils.checkpoint``.

Unlike the reference's pure functions, :func:`decode_step` writes the new
token's keys and values, and each Mamba layer's new states, into the
cache's tensors in place (the returned cache shares them and carries the
next index).

A sliding-window cache is a ring: position ``p`` lives in slot ``p % T``.
The reference's prefill stores the prompt's last ``T`` keys from slot 0,
so after a prompt whose length is not a multiple of the window decode
overwrites a key still inside the window; the port's prefill writes each
position to its ring slot, and grows the ring to ``pad_to`` (up to the
window) after a prompt shorter than the window.
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
from repro_torch.models import mamba as M
from repro_torch.models import moe
from repro_torch.tree import tree_map

__all__ = ["REMAT", "FP32_LEAVES", "layer_kinds", "pattern_period",
           "padded_vocab", "init_params", "leaf_dtype", "cast_params",
           "lm_params_from_numpy", "forward", "prefill", "loss_fn",
           "init_cache", "decode_step"]

#: the reference's recomputation policies (``transformer.py:_run_stack``)
REMAT = ("none", "full", "dots", "outputs")
#: leaves the reference keeps in fp32 in a bf16 model, besides the norms
#: (``moe.py:43``, ``mamba.py:43-46``)
FP32_LEAVES = ("router", "a_log", "d_skip")


# --------------------------------------------------------------------------
# Layer pattern
# --------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """Per-layer (mixer, ffn) kinds, as the reference's: the mixer
    ``attn`` or ``mamba`` (a hybrid's attention where ``is_attn_layer``),
    the FFN ``moe`` where ``is_moe_layer``, else ``dense``."""
    if cfg.ssm_kind == "rwkv6":
        raise NotImplementedError(
            "the RWKV mixer waits for ROADMAP Queue 1 item 7.4")
    if cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs dense, MoE and Mamba "
            f"hybrid language models (ROADMAP Queue 1 items 7.4-7.5)")
    kinds = []
    for i in range(cfg.n_layers):
        mamba = cfg.ssm_kind == "mamba" and not cfg.is_attn_layer(i)
        kinds.append(("mamba" if mamba else "attn",
                      "moe" if cfg.is_moe_layer(i) else "dense"))
    return kinds


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
    """Random parameters in the reference's layout, scales and dtypes:
    every projection ``normal · fan_in^-0.5`` in ``cfg.dtype``, norms ones
    and :data:`FP32_LEAVES` in fp32, Mamba's constants as the reference
    sets them.  Drawn in fp32 on ``generator``'s device, then moved to
    ``device`` (default: the generator's)."""
    dtype = L.resolve_dtype(cfg.dtype)
    dev = torch.device(device) if device is not None else generator.device
    kinds = layer_kinds(cfg)
    period = pattern_period(cfg)
    n = cfg.n_layers // period
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale, dt=None):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(device=dev, dtype=dt or dtype)

    def stacked(shape, scale, dt=None):
        return normal((n,) + shape, scale, dt)

    def full(shape, value, dt=None):
        out = torch.empty((n,) + shape, dtype=dt or dtype, device=dev)
        return out.copy_(torch.as_tensor(value, dtype=torch.float32))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def layer(kind):
        mixer, ffn = kind
        p: dict[str, Any] = {"ln1": ones(n, d)}
        if mixer == "attn":
            p["attn"] = {
                "q_proj": stacked((d, cfg.q_dim), d ** -0.5),
                "k_proj": stacked((d, cfg.kv_dim), d ** -0.5),
                "v_proj": stacked((d, cfg.kv_dim), d ** -0.5),
                "o_proj": stacked((cfg.q_dim, d), cfg.q_dim ** -0.5)}
        else:
            p["mamba"] = M.init_mamba(stacked, full, cfg)
        p["ln2"] = ones(n, d)
        if ffn == "moe":
            p["moe"] = moe.init_moe(stacked, cfg)
        else:
            p["ffn"] = {"w_gate": stacked((d, f), d ** -0.5),
                        "w_in": stacked((d, f), d ** -0.5),
                        "w_out": stacked((f, d), f ** -0.5)}
        return p

    params: dict[str, Any] = {
        "embed": normal((padded_vocab(cfg), d), d ** -0.5),
        "blocks": {f"pos{j}": layer(kinds[j]) for j in range(period)},
        "ln_f": ones(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((d, padded_vocab(cfg)), d ** -0.5)
    return params


def leaf_dtype(key: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype of the leaf named ``key`` in a model of ``dtype``: fp32
    for a norm (a key starting with ``ln``) and :data:`FP32_LEAVES`."""
    return torch.float32 if key.startswith("ln") or key in FP32_LEAVES \
        else dtype


def cast_params(params: dict, dtype: torch.dtype,
                device: torch.device | str | None = None) -> dict:
    """``params`` with every leaf in :func:`leaf_dtype`'s dtype for
    ``dtype``, as the reference keeps them."""
    def cast(key: str, x: Any) -> Any:
        if isinstance(x, dict):
            return {k: cast(k, v) for k, v in x.items()}
        return x.to(device=device if device is not None else x.device,
                    dtype=leaf_dtype(key, dtype))

    return {k: cast(k, v) for k, v in params.items()}


def lm_params_from_numpy(tree: dict, *, device=None,
                         dtype: torch.dtype = torch.float32) -> dict:
    """The reference's LM parameters as numpy arrays (bf16 ones widened to
    fp32 first) → the port's tree, leaves as :func:`cast_params` casts them,
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


def _mixer(h, p, cfg: ModelConfig, mixer: str, positions, *, causal,
           want_cache=False, plain=False):
    """The mixer sub-block of a layer: norm, then attention (its output is
    the reference's ``mixer_out``) or Mamba → (output, cache or None)."""
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        c0 = M.init_mamba_cache(cfg, h.shape[0], h.dtype, h.device) \
            if want_cache else None
        return M.mamba_forward(x, p["mamba"], cfg, c0)
    return _attn_block(x, p["attn"], cfg, positions, causal=causal,
                       window=cfg.sliding_window, want_cache=want_cache,
                       plain=plain)


def _ffn(h, p, cfg: ModelConfig, ffn: str):
    """The FFN sub-block of a layer → (output, the reference's
    ``ffn_out``; aux loss, 0.0 for a dense FFN)."""
    x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if ffn == "moe":
        return moe.moe_ffn(x, p["moe"], cfg)
    f = p["ffn"]
    return L.swiglu_mlp(x, f["w_gate"], f["w_in"], f["w_out"]), 0.0


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's ``dots``: keep the outputs of matrix
    products without batch dims (the reference's
    ``checkpoint_dots_with_no_batch_dims``), recompute the rest, the MoE's
    grouped ``bmm`` products among them."""
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
    ``remat="outputs"`` checkpoints the mixer and FFN sub-blocks each on
    its own, so their outputs (and the FFN's aux) are what the backward
    keeps."""
    mixer, ffn = kind
    if remat == "outputs":
        a = _checkpoint(lambda x: _mixer(x, p, cfg, mixer, positions,
                                         causal=causal, plain=plain)[0], h)
        h = h + a
        f, aux = _checkpoint(lambda x: _ffn(x, p, cfg, ffn), h)
        return h + f, aux, None
    a, cache = _mixer(h, p, cfg, mixer, positions, causal=causal,
                      want_cache=want_cache, plain=plain)
    h = h + a
    f, aux = _ffn(h, p, cfg, ffn)
    return h + f, aux, cache


def _ring_len(cfg: ModelConfig, s: int, cache_len: int | None) -> int:
    """Slots of an attention layer's cache after a prompt of ``s`` tokens
    with room for ``cache_len``: the longer of the two, at most the
    window."""
    t = max(s, cache_len or 0)
    return t if cfg.sliding_window is None else min(t, cfg.sliding_window)


def _store_cache(caches: dict, c: dict, i: int, n_periods: int, s: int,
                 slots: int) -> None:
    """Write repetition ``i``'s cache ``c`` of one position into the
    stacked ``caches`` (allocated, zero, at the first write): attention
    keys and values at position ``p``'s ring slot ``p % slots`` (the last
    ``t`` of ``s`` positions), Mamba states whole."""
    if not caches:
        for n, x in c.items():
            shape = (x.shape[0], slots) + tuple(x.shape[2:]) \
                if n in ("k", "v") else tuple(x.shape)
            caches[n] = x.new_zeros((n_periods,) + shape)
    for n, x in c.items():
        if n in ("k", "v"):
            t = x.shape[1]
            at = torch.arange(s - t, s, device=x.device) % slots
            caches[n][i].index_copy_(1, at, x)
        else:
            caches[n][i] = x


def _run_stack(h, blocks, cfg: ModelConfig, kinds, period, positions, *,
               causal=True, want_cache=False, cache_len=None, plain=False,
               remat="none"):
    """All layers in order → (h, total aux, caches or None).

    ``remat`` (:data:`REMAT`) recomputes in the backward: ``full`` each
    repetition of the pattern whole, ``dots`` the same keeping the matrix
    products' outputs, ``outputs`` each sub-block keeping its output.  With
    ``want_cache`` each attention layer's keys and values are written into
    stacked ``(n_periods, B, T, KVH, hd)`` caches, ``T`` from
    :func:`_ring_len` (slots no position reached stay zero), and each
    Mamba layer's final states into stacked ``conv``/``ssm`` caches."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    n_periods = cfg.n_layers // period
    s = h.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: dict[str, dict[str, torch.Tensor]] = {
        f"pos{j}": {} for j in range(period)}

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
            _store_cache(caches[f"pos{j}"], c, i, n_periods, s,
                         _ring_len(cfg, s, cache_len))
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
    attention caches to that many slots so decode steps have room to write
    (a sliding-window ring to the window at most)."""
    tokens = batch["tokens"]
    h = _embed_tokens(params, cfg, tokens)
    b, s, _ = h.shape
    h, _, caches = _run_stack(h, params["blocks"], cfg, layer_kinds(cfg),
                              pattern_period(cfg),
                              _positions(b, s, h.device), causal=True,
                              want_cache=True, cache_len=pad_to, plain=plain)
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
    """Zero decode cache, stacked per pattern repetition, index 0: keys and
    values of ``min(seq, window)`` slots for an attention position, Mamba
    states for a Mamba one."""
    dtype = L.resolve_dtype(cfg.dtype)
    kinds = layer_kinds(cfg)
    period = pattern_period(cfg)
    n_periods = cfg.n_layers // period
    t = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
    kv = (n_periods, batch, t, cfg.n_kv_heads, cfg.head_dim)

    def one(mixer: str) -> dict:
        if mixer == "attn":
            return {n: torch.zeros(kv, dtype=dtype, device=device)
                    for n in ("k", "v")}
        return {n: x.new_zeros((n_periods,) + tuple(x.shape))
                for n, x in M.init_mamba_cache(cfg, batch, dtype,
                                               device).items()}

    cache: dict[str, Any] = {f"pos{j}": one(kinds[j][0])
                             for j in range(period)}
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
    """One layer for one token, its cache written in place; an MoE runs
    over the B tokens with their capacity, as the reference's does."""
    mixer, ffn = kind
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        a, new = M.mamba_decode_step(x, p["mamba"], cfg, cache)
        for n, v in new.items():
            cache[n].copy_(v)
    else:
        a = _attn_decode(x, p["attn"], cfg, cache, index)
    h = h + a
    return h + _ffn(h, p, cfg, ffn)[0]


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
