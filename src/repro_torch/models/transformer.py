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
and the model axis moves activations, not weights, as the reference's
partitioner does.  The embedding, cut by vocab rows, looks up the tokens
its rows hold and sums the ranks' rows (:func:`_lookup`); the head, cut
by vocab columns, computes the rank's columns of the logits (kept cut in
the loss, :func:`_split_nll`; gathered where logits are returned,
:func:`_lm_head`).  Self- and cross-attention run on their projections'
column blocks where ``model`` divides the query heads (Megatron's split:
column-parallel q/k/v, row-parallel ``o_proj``, one all-reduce); where it
does not divide the key/value heads, each rank receives the key and
value columns its query heads read from the ranks that hold them, by one
all-to-all (:func:`_read_heads`).  The dense FFN runs Megatron's split
too (SwiGLU's ``w_gate``/``w_in``, whisper's ``wi``/``bi`` by columns,
``w_out``/``wo`` by rows); the MoE's experts take ``models/moe.py``'s
expert-parallel path; a Mamba layer runs its own ``d_inner`` slice and an
RWKV layer its own heads and channel-mix columns (:data:`_SLICED`):
``in_proj``'s product reaches the slice that needs it by one all-to-all,
the partial products of the projections cut by rows are summed, and the
RWKV channel mix gathers its hidden activation and its output columns.
One layout gathers weights on purpose: attention whose query heads
``model`` does not divide (``smollm-360m``'s 15/5 over 16) gathers its
projections whole in the forward and prefill, where gathering every
head's activations, the reference's choice, moves more bytes
(:func:`_heads_split`); so does any leaf a layer cannot split, its
gradient sliced back (:func:`_mesh_layer`).  Without rules nothing of
this runs.

``prefill`` and ``decode_step`` run the same way under the rules of
``launch/steps.py``'s prefill and decode steps, which also name the
decode cache's sequence axes (the logical ``cache_seq``): each rank holds
its rows of the cache and, of an attention layer's keys and values, every
head at its own slots (the flash-decode layout;
``sharding.cache_leaf_pspec``); Mamba's states are cut along ``d_inner``
and RWKV's ``wkv`` by head over ``model``.  Prefill writes each rank's
slots and state slices (an attention layer's key and value columns of
the cached positions gathered over ``model``).  A decode step's attention,
for every head layout, keeps its projections cut by columns and gathers
the token's query, key and value columns over ``model``, writes the new
key and value at ring slot ``index % T`` on the rank that owns that slot
only, attends with every head over the rank's own slots, and combines
the ranks' partial softmaxes over the sequence axes with one max and two
sums (:func:`layers.decode_attention_sharded`); ``o_proj``'s rows take
the rank's columns of the output.  Cross-attention attends with the
rank's own heads over the whole cross cache where ``model`` divides them.
Mamba and RWKV layers run their slices as in the forward, and the states
a prefill computes are the rank's slices, which decode steps on; no Mamba
or RWKV weight or state is gathered, but for an RWKV layer whose heads
``model`` does not divide, which gathers its states and weights, steps
them whole and keeps its slice.

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
from repro_torch.parallel.sharding import (UnevenSlotsError, active_rules,
                                           bind_rules, cache_leaf_pspec,
                                           chunk_of, gather_full,
                                           gather_tree, local_slice,
                                           spec_axes)
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


def _attn_split(p: dict, cfg: ModelConfig):
    """The cut (``layers.Split`` over ``model``) of an attention layer
    whose projections are this rank's columns (:func:`_mesh_layer` keeps
    them so), or None where they are whole."""
    if p["q_proj"].shape[-1] == cfg.q_dim:
        return None
    rules = active_rules()
    return L.Split(rules.mesh, rules.axes("model"))


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """Columns (B, S, H·hd) as heads (B, S, H, hd)."""
    return x.reshape(x.shape[0], x.shape[1], -1, hd)


def _rope(x: torch.Tensor, positions, cfg: ModelConfig) -> torch.Tensor:
    return L.apply_rope(x, positions, cfg.rope_theta) if cfg.use_rope \
        else x


def _attn_block(h, p, cfg: ModelConfig, positions, *, causal, window,
                want_cache=False, plain=False):
    """Self-attention → (output, cache or None).  Projections narrower
    than ``q_dim`` are this rank's column blocks of a split over ``model``
    (:func:`_mesh_layer`): whole query heads, and the key and value
    columns of the heads they read (:func:`_read_heads`, which moves them
    between ranks where the rank does not hold them); the rank attends
    with its heads and the partial outputs of ``o_proj`` are summed.  A
    prefill's cache holds every head: the ranks' key and value columns of
    the cached positions are gathered."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    split = _attn_split(p, cfg)
    if split is not None:
        h = split.enter(h)
    q, k, v = (h @ p[w] for w in ("q_proj", "k_proj", "v_proj"))
    t = s if window is None else min(s, window)  # the cached positions
    kv_cache = None
    if want_cache and split is not None:
        # the cache holds every head (by slot): the ranks' columns are
        # gathered, then rotated as whole heads
        kc, vc = (C.all_gather(x[:, s - t:], split.mesh, split.axes, -1)
                  for x in (k, v))
        kv_cache = {"k": _rope(_heads(kc, hd), positions[:, s - t:], cfg),
                    "v": _heads(vc, hd)}
    hq = q.shape[-1] // hd
    if split is not None:
        k, v = (_read_heads(x, cfg, hq, split) for x in (k, v))
    q = _rope(_heads(q, hd), positions, cfg)
    k, v = _rope(_heads(k, hd), positions, cfg), _heads(v, hd)
    if want_cache and split is None:
        kv_cache = {"k": k[:, s - t:], "v": v[:, s - t:]}
    out = L.attention(q, k, v, causal=causal, window=window, plain=plain)
    out = out.reshape(b, s, hq * hd) @ p["o_proj"]
    return (split.exit(out) if split is not None else out), kv_cache


def _grouped_heads(cfg: ModelConfig, hq: int, rank: int) -> tuple[int, int]:
    """The key/value heads [lo, hi) that rank ``rank``'s ``hq`` query
    heads of a split over ``model`` read: one key/value head, or a whole
    number of them (:func:`_heads_split` checks which)."""
    group = cfg.n_heads // cfg.n_kv_heads
    return rank * hq // group, ((rank + 1) * hq - 1) // group + 1


def _read_heads(x: torch.Tensor, cfg: ModelConfig, hq: int,
                split) -> torch.Tensor:
    """The key or value columns (B, S, ·) of the heads this rank's ``hq``
    query heads read (:func:`_grouped_heads`), from ``x``, the rank's
    column block of the whole (B, S, kv_dim).  Where the block is those
    columns (``model`` divides the key/value heads, Megatron's split) it
    is ``x``; else one all-to-all over ``model`` sends each rank's block
    to the ranks whose heads read it, so each rank receives just the
    columns it reads, from the ranks that hold them (the reference's
    partitioner gathers them over those ranks alone: the same bytes).  Its
    gradient goes back the same way, each block's summed over its
    readers."""
    idx, n = split.index()
    hd, w = cfg.head_dim, x.shape[-1]

    def need(r: int) -> tuple[int, int]:  # the columns rank r reads
        lo, hi = _grouped_heads(cfg, hq, r)
        return lo * hd, hi * hd

    def overlap(a: tuple[int, int], r: int) -> tuple[int, int]:
        return max(a[0], r * w), min(a[1], (r + 1) * w)

    if need(idx) == (idx * w, (idx + 1) * w):
        return x
    if len(split.axes) != 1:
        raise ValueError(f"key/value columns move over one axis, not "
                         f"{split.axes}")
    send, recv, pieces = [0] * n, [0] * n, []
    for r in range(n):
        lo, hi = overlap(need(r), idx)
        if hi > lo:
            send[r] = hi - lo
            pieces.append(x[..., lo - idx * w:hi - idx * w])
        lo, hi = overlap(need(idx), r)
        recv[r] = max(hi - lo, 0)
    # the pieces arrive in rank order, which is the columns' order
    src = torch.cat(pieces, dim=-1)
    return C.AllToAll.apply(src, split.mesh, split.axes[0], src.dim() - 1,
                            send, recv)


def _mixer(h, p, cfg: ModelConfig, mixer: str, positions, *, causal,
           want_cache=False, plain=False, split=None):
    """The mixer sub-block of a layer: norm, then attention (its output is
    the reference's ``mixer_out``) or Mamba (on a mesh, ``split``, this
    rank's ``d_inner`` slice) → (output, cache or None)."""
    x = _norm(h, p["ln1"], p.get("ln1_b"), cfg.norm_eps)
    if mixer == "mamba":
        c0 = _local_states(M.init_mamba_cache(cfg, h.shape[0], h.dtype,
                                              h.device), split) \
            if want_cache else None
        xz = None if split is None else _mamba_xz(
            x, p["mamba"]["in_proj"], cfg, split)
        return M.mamba_forward(x, p["mamba"], cfg, c0, xz=xz, split=split)
    return _attn_block(x, p["attn"], cfg, positions, causal=causal,
                       window=cfg.sliding_window, want_cache=want_cache,
                       plain=plain)


def _cross(h, p, cfg: ModelConfig, enc_kv, plain=False):
    """The cross-attention sub-block: norm, then attention of the layer's
    queries over the encoder's keys and values ``enc_kv`` (:func:`_cross_kv`;
    no mask, no RoPE), split over ``model`` as self-attention is."""
    x = _norm(h, p["ln_cross"], p.get("ln_cross_b"), cfg.norm_eps)
    cp, hd = p["cross"], cfg.head_dim
    split = _attn_split(cp, cfg)
    if split is not None:
        x = split.enter(x)
    q = x @ cp["q_proj"]
    hq = q.shape[-1] // hd
    k, v = enc_kv if split is None else (
        _read_heads(t, cfg, hq, split) for t in enc_kv)
    out = L.attention(_heads(q, hd), _heads(k, hd), _heads(v, hd),
                      causal=False, plain=plain)
    out = out.reshape(q.shape) @ cp["o_proj"]
    return split.exit(out) if split is not None else out


def _ffn(h, p, cfg: ModelConfig, ffn: str, aux_coef=None):
    """The FFN sub-block of a layer → (output, the reference's
    ``ffn_out``; aux loss, 0.0 for a dense FFN); ``aux_coef`` as
    ``moe.moe_ffn`` takes it.  A dense FFN whose weights are this rank's
    d_ff columns (``w_gate``/``w_in`` or ``wi``/``bi``) and rows
    (``w_out`` or ``wo``) runs Megatron's split, its partial outputs
    summed (whisper's output bias added once, after the sum)."""
    x = _norm(h, p["ln2"], p.get("ln2_b"), cfg.norm_eps)
    if ffn == "moe":
        return moe.moe_ffn(x, p["moe"], cfg, aux_coef)
    f = p["ffn"]
    if cfg.family == "audio":
        if f["wi"].shape[-1] != cfg.d_ff:  # this rank's d_ff columns
            out = L.gelu_mlp(L.model_in(x), f["wi"], f["bi"], f["wo"])
            return L.model_out(out) + f["bo"], 0.0
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
                plain=False, split=None):
    """An RWKV layer: time mix (its scan's plain version with ``plain``),
    then channel mix (its second norm is RMS always, as in the reference)
    → (h, 0.0, cache or None); on a mesh (``split``) over this rank's
    heads and columns, its ``wkv`` state the rank's heads."""
    c0 = _local_states(RW.init_rwkv_cache(cfg, h.shape[0], h.dtype,
                                          h.device), split) \
        if want_cache else None

    def tm(x):
        return RW.rwkv_time_mix(_norm(x, p["ln1"], p.get("ln1_b"),
                                      cfg.norm_eps), p["tm"], cfg, c0,
                                plain=plain, split=split)

    def cm(x):
        return RW.rwkv_channel_mix(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                                   p["cm"], cfg, c0, split)

    if remat == "outputs":
        h = h + _checkpoint(lambda x: tm(x)[0], h)
        return h + _checkpoint(lambda x: cm(x)[0], h), 0.0, None
    a, c1 = tm(h)
    h = h + a
    c, c2 = cm(h)
    return h + c, 0.0, ({**c1, **c2} if want_cache else None)


def _apply_layer(h, p, cfg: ModelConfig, kind: tuple[str, str], positions,
                 *, causal=True, enc_kv=None, want_cache=False, plain=False,
                 remat="none", aux_coef=None, split=None):
    """Full-sequence layer (forward / prefill) → (h, aux, cache or None);
    with ``enc_kv`` a layer that has ``cross`` attention attends to those
    encoder keys and values after its mixer.  ``remat="outputs"``
    checkpoints the mixer, cross-attention and FFN sub-blocks each on its
    own, so their outputs (and the FFN's aux) are what the backward
    keeps.  ``aux_coef``: the MoE FFN's (:func:`_ffn`).  ``split``: a
    Mamba or RWKV layer's cut on a mesh (:func:`_split_of`)."""
    mixer, ffn = kind
    if mixer == "rwkv":
        return _rwkv_layer(h, p, cfg, want_cache=want_cache, remat=remat,
                           plain=plain, split=split)
    cross = enc_kv is not None and "cross" in p
    if remat == "outputs":
        a = _checkpoint(lambda x: _mixer(x, p, cfg, mixer, positions,
                                         causal=causal, plain=plain,
                                         split=split)[0], h)
        h = h + a
        if cross:
            h = h + _checkpoint(lambda x: _cross(x, p, cfg, enc_kv, plain),
                                h)
        f, aux = _checkpoint(lambda x: _ffn(x, p, cfg, ffn, aux_coef), h)
        return h + f, aux, None
    a, cache = _mixer(h, p, cfg, mixer, positions, causal=causal,
                      want_cache=want_cache, plain=plain, split=split)
    h = h + a
    if cross:
        h = h + _cross(h, p, cfg, enc_kv, plain)
    f, aux = _ffn(h, p, cfg, ffn, aux_coef)
    return h + f, aux, cache


def _ring_len(cfg: ModelConfig, s: int, cache_len: int | None) -> int:
    """Slots of an attention layer's cache after a prompt of ``s`` tokens
    with room for ``cache_len``: the longer of the two, at most the
    window."""
    t = max(s, cache_len or 0)
    return t if cfg.sliding_window is None else min(t, cfg.sliding_window)


def _ring(x: torch.Tensor, s: int, slots: int) -> torch.Tensor:
    """Keys or values ``x`` (B, t, ...) of the last ``t`` of ``s``
    positions in a ring of ``slots``: position ``p`` at slot ``p %
    slots``, unreached slots zero."""
    at = torch.arange(s - x.shape[1], s, device=x.device) % slots
    return x.new_zeros((x.shape[0], slots) + tuple(x.shape[2:])) \
        .index_copy_(1, at, x)


def _cache_layout():
    """The installed rules when they cut the decode cache (the prefill and
    decode steps of ``launch/steps.py`` name its ``cache_seq`` axes),
    else None."""
    rules = active_rules()
    return rules if rules is not None and "cache_seq" in rules.rules \
        else None


def _leaf_spec(rules, name: str, x: torch.Tensor):
    """The cut of one layer's cache leaf ``x`` (B, ...) of this rank's
    rows: ``sharding.cache_leaf_pspec`` without its layer and batch
    cuts."""
    return cache_leaf_pspec(f"pos/{name}", (1,) + tuple(x.shape), rules,
                            None, rules.axes("cache_seq"))[1:]


def _local_cache(rules, name: str, x: torch.Tensor) -> torch.Tensor:
    """This rank's piece of one layer's whole cache leaf ``x``."""
    spec = _leaf_spec(rules, name, x)
    if name in ("k", "v"):
        _, n = chunk_of(rules.mesh, spec_axes(spec[1]))
        if x.shape[1] % n:
            raise UnevenSlotsError(
                f"a cache of {x.shape[1]} slots does not split over "
                f"{spec_axes(spec[1])} ({n} ranks)")
    return local_slice(x, spec, rules.mesh)


def _whole_states(rules, cache: dict, cfg: ModelConfig) -> dict:
    """An RWKV layer's states gathered whole from every rank's slice
    (``cache`` as it is without a cut), for a decode step whose ``wkv``
    heads ``model`` does not divide (:func:`_state_axes`)."""
    if rules is None:
        return cache
    whole = RW.init_rwkv_cache(cfg, next(iter(cache.values())).shape[0],
                               torch.float32, "meta")
    return {n: gather_full(x, _leaf_spec(rules, n, whole[n]), rules.mesh)
            for n, x in cache.items()}


def _state_axes(rules, cfg: ModelConfig, mixer: str) -> tuple[str, ...]:
    """The mesh axes a decode step's Mamba ``ssm`` (along ``d_inner``) or
    RWKV ``wkv`` (by head) is cut over, () where it is whole.  Read from
    the whole state's shape: whether ``model`` divides RWKV's heads is a
    property of the whole ``wkv``, not of a rank's slice."""
    if rules is None:
        return ()
    if mixer == "mamba":
        path, shape = "pos/ssm", (1, 1, cfg.expand * cfg.d_model,
                                  cfg.d_state)
    else:
        hs = cfg.rwkv_head_size
        path, shape = "pos/wkv", (1, 1, cfg.d_model // hs, hs, hs)
    return spec_axes(cache_leaf_pspec(path, shape, rules, None,
                                      rules.axes("cache_seq"))[2])


#: the leaves a Mamba or RWKV layer uses as this rank's slice on a mesh,
#: each by the dim it is sliced along, in the forward, prefill and decode
#: alike: Mamba's along ``d_inner``, the RWKV time mix's along the heads of
#: ``wkv`` (the projections' columns, ``output``'s rows), the channel mix's
#: by columns (``key``'s of d_ff, ``value``'s and ``receptance``'s of d).
#: A leaf the specs cut is used as it is held; a leaf held whole (the 1-D
#: ones, ``decay_w2``) gives the rank its chunk, its gradient gathered.
#: The leaves not named are used as they are held: RWKV's token-shift
#: mixing (``mu``, ``ddlerp_w*``, ``decay_w1``) and the channel mix's
#: ``mu_k``/``mu_r`` are replicated, and Mamba's ``in_proj``, cut by
#: columns of (d, 2·di) that do not line up with the ``d_inner`` slice,
#: stays its column slice and its product is moved instead
#: (:func:`_mamba_xz`).  No Mamba or RWKV weight is gathered: the
#: reference's compiled steps gather none either
#: (``tests/test_torch_dryrun.py``).
_SLICED = {
    "mamba": {"conv_w": -1, "conv_b": 0, "x_proj": 0, "dt_proj": -1,
              "dt_bias": 0, "a_log": 0, "d_skip": 0, "out_proj": 0},
    "tm": {"receptance": -1, "key": -1, "value": -1, "gate": -1,
           "decay_base": 0, "decay_w2": -1, "bonus": 0, "ln_w": 0,
           "ln_b": 0, "output": 0},
    "cm": {"key": -1, "value": -1, "receptance": -1},
}
#: the mixer of each sliced parameter group
_MIXER = {"mamba": "mamba", "tm": "rwkv", "cm": "rwkv"}
#: the states a sliced layer computes as the rank's slices
_STATES = {"mamba": ("conv", "ssm"), "rwkv": ("wkv",)}


def _split_of(cfg: ModelConfig, mixer: str, decode: bool = False):
    """The cut (``layers.Split``) of a Mamba or RWKV layer under the
    active rules, or None where it runs whole.  A decode step cuts the
    layer over its states' axes (:func:`_state_axes`); the forward and
    prefill over ``model`` where it divides ``d_inner`` (Mamba) or both
    the heads and d_ff (RWKV)."""
    rules = active_rules()
    if rules is None or mixer not in _STATES:
        return None
    if decode:
        axes = _state_axes(_cache_layout(), cfg, mixer)
    else:
        axes = rules.axes("model")
        n = chunk_of(rules.mesh, axes)[1] if axes else 1
        width = (cfg.expand * cfg.d_model,) if mixer == "mamba" else (
            cfg.d_model // cfg.rwkv_head_size, cfg.d_ff)
        if n == 1 or any(w % n for w in width):
            axes = ()
    return L.Split(rules.mesh, axes) if axes else None


def _local_states(states: dict, split) -> dict:
    """Zero initial states (``init_mamba_cache``, ``init_rwkv_cache``) as
    a layer cut by ``split`` computes them: Mamba's along ``d_inner``,
    RWKV's ``wkv`` by head."""
    if split is None:
        return states
    idx, n = split.index()
    dims = {"conv": -1, "ssm": 1, "wkv": 1}
    return {k: x.chunk(n, dims[k])[idx] if k in dims else x
            for k, x in states.items()}


def _model_part(x: torch.Tensor, spec, dim: int, split) -> torch.Tensor:
    """This rank's chunk over ``split``'s axes of a layer leaf ``x`` along
    ``dim``: ``x`` itself where ``spec`` (the layer's, or None) cuts it,
    which must be along ``dim`` over those axes (``param_pspec`` cuts
    these leaves there); else the chunk of the whole leaf (a leaf
    ``model`` does not divide, or ``DRYRUN_NO_TP``'s whole weights), its
    gradient gathered (``layers.Split.part``)."""
    cuts = [spec_axes(e) for e in spec or ()]
    if any(cuts):
        if cuts[dim] != split.axes or sum(map(bool, cuts)) != 1:
            raise ValueError(f"a leaf cut {tuple(spec)}, not along dim "
                             f"{dim} over {split.axes}")
        return x
    return split.part(x, dim)


def _slice_tree(sub: dict, prefix: str, dims: dict, split, rules) -> dict:
    """One mixer's leaves as its sliced layer uses them (:data:`_SLICED`):
    each named leaf as this rank's chunk, every other leaf as it is held
    (whole, or Mamba's ``in_proj`` by columns: :func:`_mamba_xz`)."""
    out = dict(sub)
    for name, d in dims.items():
        spec = (rules.specs or {}).get(f"{prefix}/{name}")
        spec = spec[1:] if spec is not None else None  # the stacked dim
        out[name] = _model_part(sub[name], spec, d, split)
    return out


def _mamba_xz(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
              split) -> torch.Tensor:
    """The x and z columns (B, S, 2·di/n) of this rank's ``d_inner`` slice
    from ``in_proj`` ``w``.  From the rank's column block of ``w`` (the
    specs cut it by columns of (d, 2·di)): of the 2n pieces of di/n
    columns of the whole product, block ``r`` holds pieces 2r and 2r + 1,
    and piece ``j`` is the x (j < n) or z (j ≥ n) columns of rank ``j %
    n``, so one all-to-all takes each piece where it is used (B·S·di/n
    values in and out of a rank, as the reference's collective-permutes
    move them).  From a whole ``w``, the rank's columns of its
    product."""
    idx, n = split.index()
    if w.shape[-1] == 2 * cfg.expand * cfg.d_model:
        xin, z = (x @ w).chunk(2, dim=-1)
        return torch.cat([split.part(xin, -1), split.part(z, -1)], dim=-1)
    if len(split.axes) != 1:
        raise ValueError(f"in_proj's product moves over one axis, not "
                         f"{split.axes}")
    xz = split.enter(x) @ w
    c = xz.shape[-1] // 2
    dest = [(2 * idx) % n, (2 * idx + 1) % n]
    if dest[1] < dest[0]:  # pieces in the order of their ranks
        xz = torch.cat([xz[..., c:], xz[..., :c]], dim=-1)
    send, recv = [0] * n, [0] * n
    for r in dest:
        send[r] += c
    for r in (idx // 2, (n + idx) // 2):  # its x piece, then its z piece
        recv[r] += c
    return C.AllToAll.apply(xz, split.mesh, split.axes[0], xz.dim() - 1,
                            send, recv)


def _store_cache(caches: dict, c: dict, i: int, n_periods: int, s: int,
                 slots: int, rules=None, own=()) -> None:
    """Write repetition ``i``'s cache ``c`` of one position into the
    stacked ``caches`` (allocated, zero, at the first write): attention
    keys and values at position ``p``'s ring slot ``p % slots`` (the last
    ``t`` of ``s`` positions), Mamba and RWKV states as computed; with the
    cut ``rules`` of :func:`_cache_layout`, this rank's slots and slices,
    the states named in ``own`` already the rank's slices."""
    c = {n: _ring(x, s, slots) if n in ("k", "v") else x
         for n, x in c.items()}
    if rules is not None:
        c = {n: x if n in own else _local_cache(rules, n, x)
             for n, x in c.items()}
    for n, x in c.items():
        if n not in caches:
            caches[n] = x.new_zeros((n_periods,) + tuple(x.shape))
        caches[n][i] = x


def _heads_split(cfg: ModelConfig, m: int, decode: bool) -> bool:
    """Whether an attention layer whose projections are cut over ``model``
    (``m`` ranks) runs on its column blocks: a decode step always (the
    token's columns gathered, :func:`_attn_decode`); the forward and
    prefill where ``model`` divides the query heads and each rank's query
    heads read one or a whole number of key/value heads
    (:func:`_attn_block`).  Otherwise (``smollm-360m``'s 15/5 heads and
    ``whisper-small``'s 12 over 16) the forward gathers the projections
    whole.  The reference's partitioner gathers every head's query, key
    and value columns instead, which grow with the tokens a rank holds
    while a layer's weights do not: per rank and step, in the dry-run
    (``tools/uneven_heads.py``), 61.130 against 18.097 GB at ``smollm-360m
    × train_4k``, 23.069 against 8.462 GB at ``prefill_32k``, 37.069
    against 7.021 GB at ``whisper-small × train_4k`` (ROADMAP, "Different
    on purpose")."""
    if decode:
        return True
    hq, group = cfg.n_heads // m, cfg.n_heads // max(cfg.n_kv_heads, 1)
    return cfg.n_heads % m == 0 and hq > 0 and (
        hq % group == 0 or group % hq == 0)


def _mesh_layer(p: dict, prefix: str, cfg: ModelConfig,
                decode: bool = False) -> dict:
    """One layer's parameters as its code uses them under mesh rules: the
    leaves each layer splits itself as they are held, every other leaf
    cut over an axis gathered whole (``sharding.gather_tree``).  A layer
    splits its self- and cross-attention projections (cut by columns,
    ``o_proj`` by rows) where :func:`_heads_split` says, the dense FFN's
    (SwiGLU's ``w_gate``/``w_in``, whisper's ``wi``/``bi``, by columns;
    ``w_out``/``wo`` by rows) when their specs cut d_ff (the Megatron
    split), the MoE's experts (its expert-parallel path), and a Mamba or
    RWKV layer's when it is cut (:func:`_split_of`: its slices,
    :func:`_slice_tree`), in the forward, prefill and decode (``decode``)
    alike."""
    rules = active_rules()
    spec = rules.specs or {}

    def cut(name: str, dim: int) -> bool:
        s = spec.get(f"{prefix}/{name}")
        return s is not None and "model" in spec_axes(s[dim])

    def all_cut(key: str, cols, rows) -> bool:
        return all(cut(f"{key}/{w}", -1) for w in cols) \
            and all(cut(f"{key}/{w}", -2) for w in rows)

    heads = _heads_split(cfg, rules.size("model"), decode)
    out = {}
    for key, sub in p.items():
        at = f"{prefix}/{key}"
        split = _split_of(cfg, _MIXER[key], decode) if key in _SLICED \
            else None
        if key == "moe":
            out[key] = sub
        elif split is not None:
            out[key] = _slice_tree(sub, at, _SLICED[key], split, rules)
        elif key in ("attn", "cross") and heads and all_cut(
                key, ("q_proj", "k_proj", "v_proj"), ("o_proj",)):
            out[key] = sub
        elif key == "ffn" and (
                all_cut(key, ("w_gate", "w_in"), ("w_out",)) if "w_gate"
                in sub else all_cut(key, ("wi", "bi"), ("wo",))):
            out[key] = sub
        else:
            out[key] = gather_tree(sub, at, stacked=True)
    return out


def _run_stack(h, blocks, cfg: ModelConfig, kinds, period, positions, *,
               causal=True, enc_out=None, want_cache=False, cache_len=None,
               plain=False, remat="none", n_layers=None, prefix="blocks",
               aux_coef=None):
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
    region, so a gathered leaf lives for its layer only.  ``aux_coef``
    (MoE layers, E): the ``n``-th MoE layer in order takes row ``n``
    (``moe.moe_ffn``)."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    n_periods = (n_layers or cfg.n_layers) // period
    s = h.shape[1]
    mesh = active_rules() is not None
    layout = _cache_layout() if want_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: dict[str, dict[str, torch.Tensor]] = {
        f"pos{j}": {} for j in range(period)}
    moe_at = [j for j in range(period) if kinds[j][1] == "moe"]
    own = [_own_states(layout, cfg, kinds[j][0]) for j in range(period)] \
        if layout is not None else [()] * period

    def body(x, i):
        """Repetition ``i`` → (x, its aux, each position's cache)."""
        aux_i, out = 0.0, []
        for j in range(period):
            coef = None if aux_coef is None or j not in moe_at \
                else aux_coef[i * len(moe_at) + moe_at.index(j)]
            p = _layer(blocks, j, i)
            split = None
            if mesh:
                p = _mesh_layer(p, f"{prefix}/pos{j}", cfg)
                split = _split_of(cfg, kinds[j][0])
            enc_kv = None if enc_out is None else _cross_kv(enc_out, p, cfg)
            x, a, c = _apply_layer(
                x, p, cfg, kinds[j], positions, causal=causal, enc_kv=enc_kv,
                want_cache=want_cache, plain=plain,
                remat="outputs" if remat == "outputs" else "none",
                aux_coef=coef, split=split)
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
                         _ring_len(cfg, s, cache_len), layout, own[j])
    return h, aux, (caches if want_cache else None)


def _own_states(layout, cfg: ModelConfig, mixer: str) -> tuple[str, ...]:
    """The states a prefill's ``mixer`` layer computes as this rank's
    slices of the cut cache ``layout``: those of a cut layer, whose axes
    must be the cache's."""
    split = _split_of(cfg, mixer)
    if split is None:
        return ()
    if split.axes != _state_axes(layout, cfg, mixer):
        raise ValueError(f"a {mixer} layer cut over {split.axes}, its "
                         f"cache over {_state_axes(layout, cfg, mixer)}")
    return _STATES[mixer]


def _cross_kv(enc_out, p, cfg: ModelConfig):
    """A layer's cross-attention keys and values (B, T, kv_dim) from the
    encoder output: this rank's columns where the projections are split
    (:func:`_cross`)."""
    cp = p["cross"]
    split = _attn_split(cp, cfg)
    x = enc_out if split is None else split.enter(enc_out)
    return x @ cp["k_proj"], x @ cp["v_proj"]


def _vocab_split(name: str):
    """The cut (``layers.Split`` over ``model``) of the embedding
    (``name`` ``embed``, by vocab rows) or the LM head (``head``, by vocab
    columns) where the active rules' specs cut it so, else None."""
    rules = active_rules()
    if rules is None or not rules.specs or name not in rules.specs:
        return None
    spec, vdim = rules.specs[name], 0 if name == "embed" else 1
    axes = rules.axes("model")
    if not axes or spec_axes(spec[vdim]) != axes \
            or spec_axes(spec[1 - vdim]):
        return None
    return L.Split(rules.mesh, axes)


def _lookup(params, tokens) -> torch.Tensor:
    """The embedding rows of ``tokens`` (B, S) → (B, S, D).  From a table
    cut by vocab rows over ``model`` (:func:`_vocab_split`), each rank
    looks up the tokens its rows hold, zeros for the rest, and the ranks'
    rows are summed (one all-reduce of (B, S, D), the reference's); the
    gradient reaches the rank's rows only.  Padded vocab rows are never
    looked up."""
    table, tokens = params["embed"], tokens.long()
    split = _vocab_split("embed")
    if split is None:
        return table[tokens]
    idx, _ = split.index()
    rows = table.shape[0]
    at = tokens - idx * rows
    mine = (at >= 0) & (at < rows)
    e = table[at.clamp(0, rows - 1)]
    return split.exit(torch.where(mine[..., None], e, torch.zeros_like(e)))


def _embed_tokens(params, cfg: ModelConfig, tokens):
    """Embedding rows; the audio family adds sinusoidal positions."""
    e = _lookup(params, tokens)
    if cfg.family == "audio":
        pos = L.sinusoidal_positions(
            torch.arange(tokens.shape[1], device=e.device), cfg.d_model)
        e = e + pos[None].to(e.dtype)
    return e


def _lm_head(params, cfg: ModelConfig, h):
    """Logits (B, ·, V) fp32.  From a head cut by vocab columns over
    ``model`` (:func:`_head_split`) each rank computes its columns, and
    the logits are gathered, never the table (the reference's steps leave
    them cut: ROADMAP, "Different on purpose")."""
    head = _head_split(params, cfg)
    if head is None:
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = (h @ w).float()
    else:
        w, split = head
        logits = split.join(split.enter(h) @ w, summed=False).float()
    if logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def _mesh_top(params: dict) -> dict:
    """``params`` with the leaves outside the layer stacks gathered, but
    an embedding and head cut by vocab (:func:`_vocab_split`), which the
    lookup and the head use as they are held."""
    out = dict(params)
    for key, sub in params.items():
        if key == "blocks" or key in ("embed", "head") \
                and _vocab_split(key) is not None:
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
    audio family's ``frames`` (B, T, D); from the training step, for rows
    of one microbatch spread over the ranks, ``moe_aux_coef`` (B, MoE
    layers, E), the same for every row (:func:`_run_stack`).  Under mesh
    rules the embedding and head cut by vocab are used as they are held
    (:func:`_lookup`, :func:`_lm_head`), any other leaf outside the layer
    stacks is gathered whole first, and each layer's leaves are used as
    :func:`_run_stack` says."""
    if active_rules() is not None:
        params = _mesh_top(params)
    h, aux = _final_hidden(params, cfg, batch, plain=plain, remat=remat)
    return _lm_head(params, cfg, h), aux


def _final_hidden(params, cfg: ModelConfig, batch: dict, *, plain=False,
                  remat="none"):
    """The stack and the final norm over ``batch`` (its leaves outside
    the stacks already gathered under mesh rules) → (the hidden states of
    the S tokens (B, S, D), aux)."""
    h, sv = _embed_inputs(params, cfg, batch)
    b, s, _ = h.shape
    enc = _encode(params, cfg, batch["frames"], plain=plain, remat=remat) \
        if cfg.encoder_decoder else None
    coef = batch.get("moe_aux_coef")
    h, aux, _ = _run_stack(h, params["blocks"], cfg, layer_kinds(cfg),
                           pattern_period(cfg), _positions(b, s, h.device),
                           causal=True, enc_out=enc, plain=plain,
                           remat=remat,
                           aux_coef=None if coef is None else coef[0])
    h = _norm(h, params["ln_f"], params.get("ln_f_b"), cfg.norm_eps)
    return h[:, sv:], aux


def _head_split(params, cfg: ModelConfig):
    """(this rank's vocab columns of the LM head (D, V'/n), their cut)
    where the active rules cut the head (or the tied embedding) by vocab
    over ``model`` alone, else None."""
    name = "embed" if cfg.tie_embeddings else "head"
    split = _vocab_split(name)
    if split is None:
        return None
    w = params[name]
    return (w.T if cfg.tie_embeddings else w), split


def _split_nll(h, w, split, labels, vocab: int) -> torch.Tensor:
    """Next-token losses (B, S) from this rank's vocab columns ``w`` of
    the head, as the reference's partitioner runs a vocab-cut head: each
    rank its logits' columns (the padded vocab masked), the log-sum-exp
    from the ranks' maxima and sums, the label's logit from the rank that
    holds it."""
    logits = (split.enter(h) @ w).float()
    idx, _ = split.index()
    width = logits.shape[-1]
    cols = torch.arange(idx * width, (idx + 1) * width, device=h.device)
    logits = logits.masked_fill(cols >= vocab, float("-inf"))
    top = C.all_reduce(logits.detach().amax(-1, keepdim=True), split.mesh,
                       split.axes, "max")
    total = split.exit(torch.exp(logits - top).sum(-1))
    at = labels.long() - idx * width
    mine = (at >= 0) & (at < width)
    picked = logits.gather(-1, at.clamp(0, width - 1)[..., None])[..., 0]
    picked = split.exit(torch.where(mine, picked, 0.0))
    return top[..., 0] + torch.log(total) - picked


def prefill(params, cfg: ModelConfig, batch: dict, pad_to: int | None = None,
            *, plain: bool = False):
    """Serving prefill: the prompt in one pass → (last-token logits (B, 1,
    V), cache).  The cache matches :func:`init_cache`'s layout and carries
    ``index`` = the positions run (a VLM's Sv + S); ``pad_to`` grows
    attention caches to that many slots so decode steps have room to write
    (a sliding-window ring to the window at most).  For the audio family
    prefill is the encoder forward, as in the reference: → (encoder output
    (B, T, D), None); :func:`cross_cache` makes decode's ``cross`` entry
    from it.  Under the rules of ``launch/steps.py``'s prefill step the
    cache is this rank's slots and slices (module docstring)."""
    if active_rules() is not None:
        params = _mesh_top(params)
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
    the loss its share of the step's; a head cut by vocab over ``model``
    stays cut, each rank computing its vocab columns of the logits
    (:func:`_split_nll`); and a mask comes with the training
    step's ``loss_weight`` (B,): each row's factor, its global
    microbatch's unmasked tokens counted once a step over every rank
    (``launch/steps.py``).  The loss is then the weighted sum of the rows'
    masked token losses, so that the mean of the ranks' losses over the
    batch axes is the mean of the microbatches' masked means."""
    head = _head_split(params, cfg)
    if head is None:
        logits, aux = forward(params, cfg, batch, plain=plain, remat=remat)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    else:
        h, aux = _final_hidden(_mesh_top(params), cfg, batch, plain=plain,
                               remat=remat)
        nll = _split_nll(h, *head, batch["labels"], cfg.vocab_size)
    mask = batch.get("loss_mask")
    weight = batch.get("loss_weight")
    if mask is not None and weight is not None:
        loss = (nll * mask * weight[:, None].to(nll.dtype)).sum()
    elif mask is not None:
        if active_rules() is not None:
            raise ValueError("a loss_mask on a mesh needs the training "
                             "step's loss_weight (launch/steps.py)")
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
    place.  ``h``: (B, 1, D); ``index``: 0-d int32 tensor.  Under a cut
    cache (:func:`_cache_layout`) ``cache`` holds this rank's slots of
    every head, and projections narrower than ``q_dim`` are this rank's
    heads of a Megatron split (module docstring)."""
    b, hd = h.shape[0], cfg.head_dim
    layout = _cache_layout()
    split = _attn_split(p, cfg)
    if split is not None:
        h = split.enter(h)
    q, k, v = (h @ p[w] for w in ("q_proj", "k_proj", "v_proj"))
    if split is not None:  # every head's columns, from the ranks
        q, k, v = (C.all_gather(x, split.mesh, split.axes, -1)
                   for x in (q, k, v))
    pos = index.reshape(1, 1).expand(b, 1)
    q, k, v = _rope(_heads(q, hd), pos, cfg), _rope(_heads(k, hd), pos,
                                                    cfg), _heads(v, hd)
    t = cache["k"].shape[1]
    seq = spec_axes(_leaf_spec(layout, "k", cache["k"])[1]) \
        if layout is not None else ()
    chunk, n_seq = chunk_of(layout.mesh, seq) if seq else (0, 1)
    total = t * n_seq  # the ring's slots over every rank
    if n_seq == 1:
        write_at = (index % t).reshape(1).long()  # a ring buffer for SWA
        cache["k"].index_copy_(1, write_at, k)
        cache["v"].index_copy_(1, write_at, v)
        out = L.decode_attention(q, cache["k"], cache["v"],
                                 torch.clamp(index + 1, max=t))
    else:
        # slot index % total is on the rank whose chunk holds it; every
        # other rank writes back what the slot it clamps to held
        local = (index % total - chunk * t).reshape(1).long()
        mine = (local >= 0) & (local < t)
        at = torch.clamp(local, 0, t - 1)
        for name, x in (("k", k), ("v", v)):
            keep = cache[name].index_select(1, at)
            cache[name].index_copy_(1, at, torch.where(mine, x, keep))
        out = L.decode_attention_sharded(
            q, cache["k"], cache["v"], torch.clamp(index + 1, max=total),
            chunk * t, layout.mesh, seq)
    return _rows_out(out.reshape(b, 1, -1), p, split)


def _rows_out(out: torch.Tensor, p: dict, split) -> torch.Tensor:
    """``o_proj`` of a decode step's attention output (B, 1, q_dim) of
    every head: where ``o_proj`` is this rank's rows of a split, the
    rank's columns of the output times them, summed over the ranks."""
    if split is None:
        return out @ p["o_proj"]
    idx, _ = split.index()
    w = p["o_proj"].shape[0]
    return split.exit(out[..., idx * w:(idx + 1) * w] @ p["o_proj"])


def _cross_decode(x, cp: dict, cfg: ModelConfig, cross: dict):
    """One token's cross-attention over every frame of ``cross``'s keys and
    values, ``x`` normed.  Split over ``model`` (:func:`_attn_split`) the
    rank attends with its own query heads and the key/value heads they
    read, where ``model`` divides the heads (:func:`_heads_split`), else
    with every head from the token's gathered query columns; either way
    ``o_proj``'s rows take the rank's columns and the ranks' products are
    summed."""
    b, hd, t = x.shape[0], cfg.head_dim, cross["k"].shape[1]
    split = _attn_split(cp, cfg)
    if split is not None:
        x = split.enter(x)
    q = x @ cp["q_proj"]
    k, v = cross["k"], cross["v"]
    if split is None:
        out = L.decode_attention(_heads(q, hd), k, v, t)
        return out.reshape(b, 1, -1) @ cp["o_proj"]
    idx, n = split.index()
    if not _heads_split(cfg, n, decode=False):
        q = C.all_gather(q, split.mesh, split.axes, -1)
        out = L.decode_attention(_heads(q, hd), k, v, t)
        return _rows_out(out.reshape(b, 1, -1), cp, split)
    lo, hi = _grouped_heads(cfg, q.shape[-1] // hd, idx)
    out = L.decode_attention(_heads(q, hd), k[:, :, lo:hi], v[:, :, lo:hi],
                             t)
    return split.exit(out.reshape(b, 1, -1) @ cp["o_proj"])


def _decode_layer(h, p, cfg: ModelConfig, kind, cache, index, cross=None):
    """One layer for one token, its cache written in place; an MoE runs
    over the B tokens with their capacity, as the reference's does.  A
    layer with ``cross`` attention attends to all of ``cross``'s keys and
    values.  Under the decode step's rules a Mamba or RWKV layer whose
    states are cut steps this rank's slice with its sliced leaves
    (:func:`_mesh_layer`), as the forward runs it (:func:`_split_of`);
    an RWKV layer whose heads ``model`` does not divide gathers its
    states, steps them whole and keeps its slice."""
    mixer, ffn = kind
    x = _norm(h, p["ln1"], p.get("ln1_b"), cfg.norm_eps)
    layout = _cache_layout() if mixer in _STATES else None
    split = _split_of(cfg, mixer, decode=True)

    def keep(new: dict) -> None:  # this rank's slices of the new states
        for n, v in new.items():
            cache[n].copy_(v if layout is None or split is not None
                           else _local_cache(layout, n, v))

    if mixer == "rwkv":
        states = cache if split is not None \
            else _whole_states(layout, cache, cfg)
        a, c1 = RW.rwkv_time_mix_decode(x, p["tm"], cfg, states, split)
        h = h + a
        c, c2 = RW.rwkv_channel_mix_decode(
            L.rms_norm(h, p["ln2"], cfg.norm_eps), p["cm"], cfg, states,
            split)
        keep({**c1, **c2})
        return h + c
    if mixer == "mamba":
        xz = None if split is None else _mamba_xz(
            x, p["mamba"]["in_proj"], cfg, split)
        a, new = M.mamba_decode_step(x, p["mamba"], cfg, cache, xz=xz,
                                     split=split)
        keep(new)
    else:
        a = _attn_decode(x, p["attn"], cfg, cache, index)
    h = h + a
    if cross is not None and "cross" in p:
        x = _norm(h, p["ln_cross"], p.get("ln_cross_b"), cfg.norm_eps)
        h = h + _cross_decode(x, p["cross"], cfg, cross)
    return h + _ffn(h, p, cfg, ffn)[0]


def decode_step(params, cfg: ModelConfig, cache: dict, batch: dict):
    """One token for every sequence: ``batch['tokens']`` (B, 1) → (logits
    (B, 1, V), cache).  The layer caches are written in place; the
    returned cache holds the same tensors and ``index`` + 1.  The audio
    family's token takes the sinusoidal position ``index`` and its layers
    attend to the cache's ``cross`` entry.  Under the rules of
    ``launch/steps.py``'s decode step ``cache`` is this rank's rows, slots
    and slices (module docstring)."""
    mesh = active_rules() is not None
    if mesh:
        params = _mesh_top(params)
    h = _lookup(params, batch["tokens"])
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
            p = _layer(params["blocks"], j, i)
            if mesh:
                p = _mesh_layer(p, f"blocks/pos{j}", cfg, decode=True)
            h = _decode_layer(h, p, cfg, kinds[j], c, index, cross)
    h = _norm(h, params["ln_f"], params.get("ln_f_b"), cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["index"] = index + 1
    return _lm_head(params, cfg, h), new_cache
