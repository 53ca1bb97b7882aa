"""The LM stack: forward, prefill and decode of every language-model family
of the reference (dense, MoE, Mamba hybrid, RWKV, VLM, encoder-decoder
audio).

A port of ``repro/models/transformer.py``.  Each layer has a mixer
(attention, Mamba or RWKV's time mix) and an FFN (dense SwiGLU, whisper's
gelu MLP, MoE, or RWKV's channel mix), by :func:`layer_kinds`; a norm is
a LayerNorm where the layer has a bias for it (the audio family), else
RMS norm.  A VLM prepends its ``vision_embeds`` to the embedded tokens and
slices them off the logits.  The audio family runs an encoder over its
``frames`` (sinusoidal positions, a non-causal stack) and its decoder
layers attend to the encoder output through ``cross`` attention, whose
keys and values each layer projects from that output; its prefill is the
encoder forward, and decode reads a ``cross`` cache (zero from
:func:`init_cache`, or :func:`cross_cache` of an encoder output).
Parameters keep the
reference's stacked layout: layers grouped into repetitions of a
``pattern_period`` (1 for a uniform stack, 8 for Jamba), each parameter of
position ``j`` stacked over the repetitions under ``blocks/pos{j}`` with a
leading ``(n_periods, ...)`` axis; decode caches are stacked the same way,
so checkpoint leaf paths read the same in both packages.  A Python loop
over the layers takes the place of ``lax.scan``.  The MoE layers' aux
loss is summed over the stack; ``loss_fn`` adds ``aux_weight`` times it.

The reference runs the encoder on ``frames`` as given, so fp32 frames in a
bf16 model promote its activations to fp32; the port casts the frames to
the model's dtype first, as the reference casts ``vision_embeds``.

Full-sequence attention (forward, loss and prefill) runs
``kernels/flash_attention.py``: the kernel on the card, with its
hand-written backward when autograd asks for a gradient, and its plain
version on the CPU or with ``plain=True``.  Decode attends its single token
with a dense product over the cache, as the reference does.  ``loss_fn``
takes the reference's ``remat`` values (``none``, ``full``, ``dots``,
``outputs``) through ``torch.utils.checkpoint``.

On a mesh (the rules ``launch/steps.py`` installs, with each leaf's spec)
``forward`` and ``loss_fn`` run on this rank's rows and parameter slices,
per leaf class: self-attention whose query and key/value head counts both
divide over ``model`` runs Megatron's split (column-parallel q/k/v,
row-parallel ``o_proj``, one all-reduce), and so does the SwiGLU FFN
(``w_gate``/``w_in`` by columns, ``w_out`` by rows); the MoE's experts
take ``models/moe.py``'s expert-parallel path; every other leaf cut over
an axis (the embedding and tied head, attention with uneven heads such as
``smollm-360m``'s 15/5, cross-attention, whisper's gelu MLP, Mamba and
RWKV weights) is gathered whole just before its layer runs and its
gradient sliced back (:func:`_mesh_layer`).  Without rules nothing of
this runs.

Unlike the reference's pure functions, :func:`decode_step` writes the new
token's keys and values, and each Mamba layer's new states, into the
cache's tensors in place, as it does each Mamba and RWKV layer's new
states (the returned cache shares them and carries the next index).

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
from repro_torch.models import rwkv as RW
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (active_rules, bind_rules,
                                           gather_tree, spec_axes)
from repro_torch.tree import tree_map

__all__ = ["REMAT", "FP32_LEAVES", "layer_kinds", "pattern_period",
           "padded_vocab", "init_params", "leaf_dtype", "cast_params",
           "lm_params_from_numpy", "forward", "prefill", "loss_fn",
           "init_cache", "cross_cache", "decode_step"]

#: the reference's recomputation policies (``transformer.py:_run_stack``)
REMAT = ("none", "full", "dots", "outputs")
#: leaves the reference keeps in fp32 in a bf16 model, besides the norms
#: (``moe.py:43``, ``mamba.py:43-46``, ``rwkv.py:55-58``)
FP32_LEAVES = ("router", "a_log", "d_skip", "decay_base", "bonus")


# --------------------------------------------------------------------------
# Layer pattern
# --------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """Per-layer (mixer, ffn) kinds of the decoder stack, as the
    reference's: RWKV's ``rwkv`` mixer with its ``rwkv_cm`` channel mix;
    else the mixer ``attn`` or ``mamba`` (a hybrid's attention where
    ``is_attn_layer``) and the FFN ``moe`` where ``is_moe_layer``, else
    ``dense``."""
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.ssm_kind == "rwkv6":
            kinds.append(("rwkv", "rwkv_cm"))
            continue
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
    (their biases zeros) and :data:`FP32_LEAVES` in fp32, Mamba's and
    RWKV's constants as the reference sets them; an encoder-decoder's
    ``encoder`` subtree beside the decoder's blocks.  Drawn in fp32 on
    ``generator``'s device, then moved to ``device`` (default: the
    generator's)."""
    dtype = L.resolve_dtype(cfg.dtype)
    dev = torch.device(device) if device is not None else generator.device
    audio = cfg.family == "audio"
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale, dt=None):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(device=dev, dtype=dt or dtype)

    def full(shape, value, dt=None):
        out = torch.empty(shape, dtype=dt or dtype, device=dev)
        return out.copy_(torch.as_tensor(value, dtype=torch.float32))

    def blocks(n_layers: int, kinds, period: int, cross: bool) -> dict:
        n = n_layers // period

        def stacked(shape, scale, dt=None):
            return normal((n,) + shape, scale, dt)

        def sfull(shape, value, dt=None):
            return full((n,) + shape, value, dt)

        def uniform(shape):
            x = torch.rand((n,) + shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
            return x.to(device=dev, dtype=dtype)

        def norm(p, name):
            p[name] = full((n, d), 1.0, torch.float32)
            if audio:  # LayerNorm biases
                p[name + "_b"] = full((n, d), 0.0, torch.float32)

        def attn():
            return {"q_proj": stacked((d, cfg.q_dim), d ** -0.5),
                    "k_proj": stacked((d, cfg.kv_dim), d ** -0.5),
                    "v_proj": stacked((d, cfg.kv_dim), d ** -0.5),
                    "o_proj": stacked((cfg.q_dim, d), cfg.q_dim ** -0.5)}

        def layer(kind):
            mixer, ffn = kind
            p: dict[str, Any] = {}
            norm(p, "ln1")
            if mixer == "attn":
                p["attn"] = attn()
            elif mixer == "mamba":
                p["mamba"] = M.init_mamba(stacked, sfull, cfg)
            else:
                p.update(RW.init_rwkv_layer(stacked, sfull, uniform, cfg))
            if cross:
                norm(p, "ln_cross")
                p["cross"] = attn()
            norm(p, "ln2")
            if ffn == "moe":
                p["moe"] = moe.init_moe(stacked, cfg)
            elif audio:  # whisper's gelu MLP with biases
                p["ffn"] = {"wi": stacked((d, f), d ** -0.5),
                            "bi": sfull((f,), 0.0),
                            "wo": stacked((f, d), f ** -0.5),
                            "bo": sfull((d,), 0.0)}
            elif ffn == "dense":
                p["ffn"] = {"w_gate": stacked((d, f), d ** -0.5),
                            "w_in": stacked((d, f), d ** -0.5),
                            "w_out": stacked((f, d), f ** -0.5)}
            return p

        return {f"pos{j}": layer(kinds[j]) for j in range(period)}

    params: dict[str, Any] = {
        "embed": normal((padded_vocab(cfg), d), d ** -0.5),
        "blocks": blocks(cfg.n_layers, layer_kinds(cfg), pattern_period(cfg),
                         cfg.cross_attention),
        "ln_f": full((d,), 1.0, torch.float32),
    }
    if audio:
        params["ln_f_b"] = full((d,), 0.0, torch.float32)
    if not cfg.tie_embeddings:
        params["head"] = normal((d, padded_vocab(cfg)), d ** -0.5)
    if cfg.encoder_decoder:
        n_enc = cfg.n_encoder_layers
        params["encoder"] = {
            "blocks": blocks(n_enc, [("attn", "dense")] * n_enc, 1, False),
            "ln_f": full((d,), 1.0, torch.float32),
            "ln_f_b": full((d,), 0.0, torch.float32)}
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


def _norm(x, w, b=None, eps: float = 1e-5):
    """LayerNorm where the layer has a bias for it, else RMS norm."""
    return L.rms_norm(x, w, eps) if b is None else L.layer_norm(x, w, b, eps)


def _attn_block(h, p, cfg: ModelConfig, positions, *, causal, window,
                want_cache=False, plain=False):
    """Self-attention → (output, cache or None).  Projections narrower
    than ``q_dim`` are this rank's whole heads of a Megatron split over
    ``model`` (:func:`_mesh_layer`): the rank attends with its heads and
    the partial outputs of ``o_proj`` are summed."""
    b, s, _ = h.shape
    split = p["q_proj"].shape[-1] != cfg.q_dim
    if split:
        h = L.model_in(h)
    hd = cfg.head_dim
    hq, hkv = p["q_proj"].shape[-1] // hd, p["k_proj"].shape[-1] // hd
    q = (h @ p["q_proj"]).reshape(b, s, hq, hd)
    k = (h @ p["k_proj"]).reshape(b, s, hkv, hd)
    v = (h @ p["v_proj"]).reshape(b, s, hkv, hd)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    kv_cache = None
    if want_cache:
        t = s if window is None else min(s, window)
        kv_cache = {"k": k[:, s - t:], "v": v[:, s - t:]}
    out = L.attention(q, k, v, causal=causal, window=window, plain=plain)
    out = out.reshape(b, s, hq * hd) @ p["o_proj"]
    return (L.model_out(out) if split else out), kv_cache


def _mixer(h, p, cfg: ModelConfig, mixer: str, positions, *, causal,
           want_cache=False, plain=False):
    """The mixer sub-block of a layer: norm, then attention (its output is
    the reference's ``mixer_out``) or Mamba → (output, cache or None)."""
    x = _norm(h, p["ln1"], p.get("ln1_b"), cfg.norm_eps)
    if mixer == "mamba":
        c0 = M.init_mamba_cache(cfg, h.shape[0], h.dtype, h.device) \
            if want_cache else None
        return M.mamba_forward(x, p["mamba"], cfg, c0)
    return _attn_block(x, p["attn"], cfg, positions, causal=causal,
                       window=cfg.sliding_window, want_cache=want_cache,
                       plain=plain)


def _cross(h, p, cfg: ModelConfig, enc_kv, plain=False):
    """The cross-attention sub-block: norm, then attention of the layer's
    queries over the encoder's keys and values ``enc_kv`` (no mask, no
    RoPE)."""
    x = _norm(h, p["ln_cross"], p.get("ln_cross_b"), cfg.norm_eps)
    b, s, _ = x.shape
    q = (x @ p["cross"]["q_proj"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    out = L.attention(q, *enc_kv, causal=False, plain=plain)
    return out.reshape(b, s, cfg.q_dim) @ p["cross"]["o_proj"]


def _ffn(h, p, cfg: ModelConfig, ffn: str):
    """The FFN sub-block of a layer → (output, the reference's
    ``ffn_out``; aux loss, 0.0 for a dense FFN)."""
    x = _norm(h, p["ln2"], p.get("ln2_b"), cfg.norm_eps)
    if ffn == "moe":
        return moe.moe_ffn(x, p["moe"], cfg)
    f = p["ffn"]
    if cfg.family == "audio":
        return L.gelu_mlp(x, f["wi"], f["bi"], f["wo"], f["bo"]), 0.0
    if f["w_gate"].shape[-1] != cfg.d_ff:  # this rank's d_ff columns
        out = L.swiglu_mlp(L.model_in(x), f["w_gate"], f["w_in"], f["w_out"])
        return L.model_out(out), 0.0
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
    what ``policy`` saves; the recomputation runs under the mesh rules of
    the forward."""
    from torch.utils import checkpoint as ckpt

    fn = bind_rules(fn)

    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def _rwkv_layer(h, p, cfg: ModelConfig, *, want_cache=False, remat="none",
                plain=False):
    """An RWKV layer: time mix (its scan's plain version with ``plain``),
    then channel mix (its second norm is RMS always, as in the reference)
    → (h, 0.0, cache or None)."""
    c0 = RW.init_rwkv_cache(cfg, h.shape[0], h.dtype, h.device) \
        if want_cache else None

    def tm(x):
        return RW.rwkv_time_mix(_norm(x, p["ln1"], p.get("ln1_b"),
                                      cfg.norm_eps), p["tm"], cfg, c0,
                                plain=plain)

    def cm(x):
        return RW.rwkv_channel_mix(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                                   p["cm"], cfg, c0)

    if remat == "outputs":
        h = h + _checkpoint(lambda x: tm(x)[0], h)
        return h + _checkpoint(lambda x: cm(x)[0], h), 0.0, None
    a, c1 = tm(h)
    h = h + a
    c, c2 = cm(h)
    return h + c, 0.0, ({**c1, **c2} if want_cache else None)


def _apply_layer(h, p, cfg: ModelConfig, kind: tuple[str, str], positions,
                 *, causal=True, enc_kv=None, want_cache=False, plain=False,
                 remat="none"):
    """Full-sequence layer (forward / prefill) → (h, aux, cache or None);
    with ``enc_kv`` a layer that has ``cross`` attention attends to those
    encoder keys and values after its mixer.  ``remat="outputs"``
    checkpoints the mixer, cross-attention and FFN sub-blocks each on its
    own, so their outputs (and the FFN's aux) are what the backward
    keeps."""
    mixer, ffn = kind
    if mixer == "rwkv":
        return _rwkv_layer(h, p, cfg, want_cache=want_cache, remat=remat,
                           plain=plain)
    cross = enc_kv is not None and "cross" in p
    if remat == "outputs":
        a = _checkpoint(lambda x: _mixer(x, p, cfg, mixer, positions,
                                         causal=causal, plain=plain)[0], h)
        h = h + a
        if cross:
            h = h + _checkpoint(lambda x: _cross(x, p, cfg, enc_kv, plain),
                                h)
        f, aux = _checkpoint(lambda x: _ffn(x, p, cfg, ffn), h)
        return h + f, aux, None
    a, cache = _mixer(h, p, cfg, mixer, positions, causal=causal,
                      want_cache=want_cache, plain=plain)
    h = h + a
    if cross:
        h = h + _cross(h, p, cfg, enc_kv, plain)
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
    ``t`` of ``s`` positions), Mamba and RWKV states whole."""
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


def _mesh_layer(p: dict, prefix: str, cfg: ModelConfig) -> dict:
    """One layer's parameters as its code uses them under mesh rules:
    every leaf cut over an axis gathered whole (``sharding.gather_tree``)
    but those the layer splits itself: self-attention's projections when
    both head counts divide over ``model`` (whole heads a rank), the
    SwiGLU FFN's when their specs cut d_ff (the Megatron split), and the
    MoE's experts (its expert-parallel path)."""
    rules = active_rules()
    m = rules.size("model")
    spec = rules.specs or {}

    def cut(name: str, dim: int) -> bool:
        s = spec.get(f"{prefix}/{name}")
        return s is not None and "model" in spec_axes(s[dim])

    out = {}
    for key, sub in p.items():
        at = f"{prefix}/{key}"
        if key == "moe":
            out[key] = sub
        elif key == "attn" and cfg.n_heads % m == 0 \
                and cfg.n_kv_heads % m == 0 \
                and all(cut(f"attn/{w}", -1) for w in
                        ("q_proj", "k_proj", "v_proj")) \
                and cut("attn/o_proj", -2):
            out[key] = sub
        elif key == "ffn" and "w_gate" in sub \
                and cut("ffn/w_gate", -1) and cut("ffn/w_in", -1) \
                and cut("ffn/w_out", -2):
            out[key] = sub
        else:
            out[key] = gather_tree(sub, at, stacked=True)
    return out


def _run_stack(h, blocks, cfg: ModelConfig, kinds, period, positions, *,
               causal=True, enc_out=None, want_cache=False, cache_len=None,
               plain=False, remat="none", n_layers=None, prefix="blocks"):
    """All ``n_layers`` layers (default ``cfg.n_layers``) in order → (h,
    total aux, caches or None).

    ``remat`` (:data:`REMAT`) recomputes in the backward: ``full`` each
    repetition of the pattern whole, ``dots`` the same keeping the matrix
    products' outputs, ``outputs`` each sub-block keeping its output.  With
    ``enc_out`` (B, T, D) each layer projects its cross-attention keys and
    values from it, inside the recomputed region (the reference's
    ``_run_stack_crossattn``).  With ``want_cache`` each attention layer's
    keys and values are written into stacked ``(n_periods, B, T, KVH,
    hd)`` caches, ``T`` from :func:`_ring_len` (slots no position reached
    stay zero), and each Mamba or RWKV layer's final states into stacked
    ``conv``/``ssm`` or ``shift_tm``/``wkv``/``shift_cm`` caches.

    Under mesh rules each layer's parameters pass :func:`_mesh_layer`
    (``prefix`` names the stack's parameters), inside the recomputed
    region, so a gathered leaf lives for its layer only."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    n_periods = (n_layers or cfg.n_layers) // period
    s = h.shape[1]
    mesh = active_rules() is not None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: dict[str, dict[str, torch.Tensor]] = {
        f"pos{j}": {} for j in range(period)}

    def body(x, i):
        """Repetition ``i`` → (x, its aux, each position's cache)."""
        aux_i, out = 0.0, []
        for j in range(period):
            p = _layer(blocks, j, i)
            if mesh:
                p = _mesh_layer(p, f"{prefix}/pos{j}", cfg)
            enc_kv = None if enc_out is None else _cross_kv(enc_out, p, cfg)
            x, a, c = _apply_layer(
                x, p, cfg, kinds[j], positions, causal=causal, enc_kv=enc_kv,
                want_cache=want_cache, plain=plain,
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


def _cross_kv(enc_out, p, cfg: ModelConfig):
    """A layer's cross-attention keys and values (B, T, KVH, hd) from the
    encoder output."""
    b, t, _ = enc_out.shape
    return tuple((enc_out @ p["cross"][w]).reshape(b, t, cfg.n_kv_heads,
                                                   cfg.head_dim)
                 for w in ("k_proj", "v_proj"))


def _embed_tokens(params, cfg: ModelConfig, tokens):
    """Embedding rows; the audio family adds sinusoidal positions."""
    e = params["embed"][tokens.long()]
    if cfg.family == "audio":
        pos = L.sinusoidal_positions(
            torch.arange(tokens.shape[1], device=e.device), cfg.d_model)
        e = e + pos[None].to(e.dtype)
    return e


def _lm_head(params, cfg: ModelConfig, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = (h @ w).float()
    if logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def _mesh_top(params: dict) -> dict:
    """``params`` with the leaves outside the layer stacks gathered."""
    out = dict(params)
    for key, sub in params.items():
        if key == "blocks":
            continue
        if key == "encoder":
            out[key] = dict(sub, **{k: gather_tree(v, f"encoder/{k}")
                                    for k, v in sub.items()
                                    if k != "blocks"})
        else:
            out[key] = gather_tree(sub, key)
    return out


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _encode(params, cfg: ModelConfig, frames, *, plain=False,
            remat="none"):
    """The audio encoder over frame embeddings ``frames`` (B, T, D), cast
    to the model's dtype: sinusoidal positions, a non-causal stack of
    ``n_encoder_layers``, a final LayerNorm → (B, T, D)."""
    enc = params["encoder"]
    b, t, _ = frames.shape
    h = frames.to(params["embed"].dtype)
    pos = L.sinusoidal_positions(torch.arange(t, device=h.device),
                                 cfg.d_model)
    h = h + pos[None].to(h.dtype)
    n = cfg.n_encoder_layers
    h, _, _ = _run_stack(h, enc["blocks"], cfg, [("attn", "dense")] * n, 1,
                         _positions(b, t, h.device), causal=False,
                         plain=plain, remat=remat, n_layers=n,
                         prefix="encoder/blocks")
    return _norm(h, enc["ln_f"], enc["ln_f_b"], cfg.norm_eps)


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    """The decoder's input (B, Sv + S, D): the tokens' embeddings, after a
    VLM's ``vision_embeds`` (B, Sv, D) cast to their dtype; and Sv."""
    h = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.family != "vlm":
        return h, 0
    vis = batch["vision_embeds"].to(h.dtype)
    return torch.cat([vis, h], dim=1), vis.shape[1]


def forward(params, cfg: ModelConfig, batch: dict, *, plain: bool = False,
            remat: str = "none"):
    """Full-sequence forward → (logits (B, S, V) fp32, aux), differentiable
    on the card and on the CPU; ``remat`` (:data:`REMAT`) picks what the
    backward recomputes.  ``batch``: ``tokens`` (B, S); a VLM's
    ``vision_embeds`` (B, Sv, D) (the logits cover the S tokens only); the
    audio family's ``frames`` (B, T, D).  Under mesh rules the leaves
    outside the layer stacks (embedding, head, final norms) are gathered
    whole first, and each layer's as :func:`_run_stack` says."""
    if active_rules() is not None:
        params = _mesh_top(params)
    h, sv = _embed_inputs(params, cfg, batch)
    b, s, _ = h.shape
    enc = _encode(params, cfg, batch["frames"], plain=plain, remat=remat) \
        if cfg.encoder_decoder else None
    h, aux, _ = _run_stack(h, params["blocks"], cfg, layer_kinds(cfg),
                           pattern_period(cfg), _positions(b, s, h.device),
                           causal=True, enc_out=enc, plain=plain,
                           remat=remat)
    h = _norm(h, params["ln_f"], params.get("ln_f_b"), cfg.norm_eps)
    return _lm_head(params, cfg, h[:, sv:]), aux


def prefill(params, cfg: ModelConfig, batch: dict, pad_to: int | None = None,
            *, plain: bool = False):
    """Serving prefill: the prompt in one pass → (last-token logits (B, 1,
    V), cache).  The cache matches :func:`init_cache`'s layout and carries
    ``index`` = the positions run (a VLM's Sv + S); ``pad_to`` grows
    attention caches to that many slots so decode steps have room to write
    (a sliding-window ring to the window at most).  For the audio family
    prefill is the encoder forward, as in the reference: → (encoder output
    (B, T, D), None); :func:`cross_cache` makes decode's ``cross`` entry
    from it."""
    if cfg.encoder_decoder:
        return _encode(params, cfg, batch["frames"], plain=plain), None
    h, _ = _embed_inputs(params, cfg, batch)
    b, s, _ = h.shape
    h, _, caches = _run_stack(h, params["blocks"], cfg, layer_kinds(cfg),
                              pattern_period(cfg),
                              _positions(b, s, h.device), causal=True,
                              want_cache=True, cache_len=pad_to, plain=plain)
    h = _norm(h[:, -1:], params["ln_f"], params.get("ln_f_b"), cfg.norm_eps)
    caches["index"] = torch.tensor(s, dtype=torch.int32, device=h.device)
    return _lm_head(params, cfg, h), caches


def loss_fn(params, cfg: ModelConfig, batch: dict, *,
            aux_weight: float = 0.01, plain: bool = False,
            remat: str = "none"):
    """Next-token cross-entropy of ``forward`` against ``batch['labels']``
    (masked by ``batch['loss_mask']`` when given) → (loss, metrics), as the
    reference computes it; differentiable, with ``remat`` as in
    :func:`forward`.  Under mesh rules ``batch`` is this rank's rows and
    the loss its share of the global batch's: the mean of the ranks'
    losses over the batch axes (as the training step takes it) is the
    masked mean over every rank's rows, the mask counted over them all."""
    logits, aux = forward(params, cfg, batch, plain=plain, remat=remat)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    rules = active_rules()
    if mask is not None and rules is not None:
        axes = rules.axes("batch")
        total = C.all_reduce(mask.sum().detach(), rules.mesh, axes)
        ranks = 1
        for ax in axes:
            ranks *= rules.mesh.size(rules.mesh.mesh_dim_names.index(ax))
        loss = (nll * mask).sum() * ranks / torch.clamp(total, min=1)
    elif mask is not None:
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
    or RWKV states for a Mamba or RWKV one; an encoder-decoder's ``cross``
    keys and values of ``encoder_context_len`` frames, zero (as the
    reference's; :func:`cross_cache` fills them from an encoder
    output)."""
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
        init = M.init_mamba_cache if mixer == "mamba" \
            else RW.init_rwkv_cache
        return {n: x.new_zeros((n_periods,) + tuple(x.shape))
                for n, x in init(cfg, batch, dtype, device).items()}

    cache: dict[str, Any] = {f"pos{j}": one(kinds[j][0])
                             for j in range(period)}
    cache["index"] = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.encoder_decoder:
        shape = (n_periods, batch, cfg.encoder_context_len, cfg.n_kv_heads,
                 cfg.head_dim)
        cache["cross"] = {"pos0": {n: torch.zeros(shape, dtype=dtype,
                                                  device=device)
                                   for n in ("k", "v")}}
    return cache


def cross_cache(params, cfg: ModelConfig, enc_out: torch.Tensor) -> dict:
    """Decode's ``cross`` entry from an encoder output (B, T, D): each
    decoder layer's ``cross`` keys and values (``k_proj``, ``v_proj``),
    stacked as :func:`init_cache` lays them out (``T`` =
    ``encoder_context_len`` there)."""
    p = params["blocks"]["pos0"]["cross"]
    n = p["k_proj"].shape[0]
    b, t, _ = enc_out.shape
    return {"pos0": {
        name: (enc_out[None] @ p[w][:, None]).reshape(
            n, b, t, cfg.n_kv_heads, cfg.head_dim)
        for name, w in (("k", "k_proj"), ("v", "v_proj"))}}


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


def _decode_layer(h, p, cfg: ModelConfig, kind, cache, index, cross=None):
    """One layer for one token, its cache written in place; an MoE runs
    over the B tokens with their capacity, as the reference's does.  A
    layer with ``cross`` attention attends to all of ``cross``'s keys and
    values."""
    mixer, ffn = kind
    x = _norm(h, p["ln1"], p.get("ln1_b"), cfg.norm_eps)
    if mixer == "rwkv":
        a, c1 = RW.rwkv_time_mix_decode(x, p["tm"], cfg, cache)
        h = h + a
        c, c2 = RW.rwkv_channel_mix_decode(
            L.rms_norm(h, p["ln2"], cfg.norm_eps), p["cm"], cfg, cache)
        for n, v in {**c1, **c2}.items():
            cache[n].copy_(v)
        return h + c
    if mixer == "mamba":
        a, new = M.mamba_decode_step(x, p["mamba"], cfg, cache)
        for n, v in new.items():
            cache[n].copy_(v)
    else:
        a = _attn_decode(x, p["attn"], cfg, cache, index)
    h = h + a
    if cross is not None and "cross" in p:
        b = h.shape[0]
        x = _norm(h, p["ln_cross"], p.get("ln_cross_b"), cfg.norm_eps)
        q = (x @ p["cross"]["q_proj"]).reshape(b, 1, cfg.n_heads,
                                               cfg.head_dim)
        ca = L.decode_attention(q, cross["k"], cross["v"],
                                cross["k"].shape[1])
        h = h + ca.reshape(b, 1, cfg.q_dim) @ p["cross"]["o_proj"]
    return h + _ffn(h, p, cfg, ffn)[0]


def decode_step(params, cfg: ModelConfig, cache: dict, batch: dict):
    """One token for every sequence: ``batch['tokens']`` (B, 1) → (logits
    (B, 1, V), cache).  The layer caches are written in place; the
    returned cache holds the same tensors and ``index`` + 1.  The audio
    family's token takes the sinusoidal position ``index`` and its layers
    attend to the cache's ``cross`` entry."""
    h = params["embed"][batch["tokens"].long()]
    index = cache["index"]
    if cfg.family == "audio":
        pe = L.sinusoidal_positions(index.reshape(1), cfg.d_model)
        h = h + pe[None].to(h.dtype)
    kinds = layer_kinds(cfg)
    period = pattern_period(cfg)
    for i in range(cfg.n_layers // period):
        cross = {n: x[i] for n, x in cache["cross"]["pos0"].items()} \
            if cfg.encoder_decoder else None
        for j in range(period):
            c = {n: x[i] for n, x in cache[f"pos{j}"].items()}
            h = _decode_layer(h, _layer(params["blocks"], j, i), cfg,
                              kinds[j], c, index, cross)
    h = _norm(h, params["ln_f"], params.get("ln_f_b"), cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["index"] = index + 1
    return _lm_head(params, cfg, h), new_cache
