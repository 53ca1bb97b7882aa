"""RWKV-6 "Finch" blocks [arXiv:2404.05892]: a data-dependent decay.

A port of ``repro/models/rwkv.py``.  Time mix: a data-dependent token
shift (DDLerp with a shared low-rank projection), a per-channel decay
``w = exp(-exp(w0 + lora(x)))`` and the per-head WKV matrix recurrence

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    y_t = r_t (diag(u) k_tᵀ v_t + S_{t-1})

in fp32, then a per-head group norm and the gate.  Channel mix: a
squared-ReLU MLP with a token shift.

Prefill and training run the recurrence in chunks of ``CHUNK`` steps, the
last one ragged, so every length runs and no chunk's decay exponent
passes ``CHUNK · MAX_NEG_LOGW`` = 64 (fp32 overflows past 88).  The
reference cuts ``S // CHUNK`` chunks of ``S // n`` steps: its reshape
fails at any S ≥ 64 that ``n`` does not divide, and below 64 its one
chunk is S steps long, so clamped decays overflow at S = 45-63.  All work
that does not read the carried state runs batched over the chunks, one op
each: the intra-chunk scores under their strict lower mask, the bonus
diagonal, each chunk's decay and its ``k·v`` sum.  Only the n-step state
recurrence ``S_i = D_i S_{i-1} + U_i`` is a loop; then every chunk's
carry-in term is one batched product.  The backward recomputes that work
(non-reentrant ``torch.utils.checkpoint``, as ``jax.checkpoint(body)``
does in the reference), so training keeps O(S) a layer.  The scan is
torch ops: the reference writes it in jnp, with no Pallas kernel.  Its
plain version, :func:`_wkv_plain`, runs the one-step recurrence token by
token (``plain=True``: a ``reference`` dispatch path).

Decode is the single-token recurrence over the shift states and S.

On a mesh (a ``layers.Split`` over ``model``) a rank computes, in the
forward, prefill and decode alike, its own heads of the time mix (its
columns of ``receptance``, ``key``, ``value``, ``gate`` and
``decay_w2``, its rows of ``output``, whose partial products are summed)
and its own ``d_ff`` columns of the channel mix, whose hidden activation
is gathered before ``value``'s column slice and whose output columns are
gathered, as the reference's compiled step moves them; the token-shift
mixes run whole on every rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils import checkpoint as ckpt

from repro_torch.configs import ModelConfig

__all__ = ["LORA_R", "CHUNK", "MAX_NEG_LOGW", "init_rwkv_layer",
           "rwkv_time_mix", "rwkv_channel_mix", "init_rwkv_cache",
           "rwkv_time_mix_decode", "rwkv_channel_mix_decode"]

LORA_R = 32
CHUNK = 32
#: per-step log-decay clamp: the chunk's factorisation exp(cum_t − cum_j)
#: is evaluated as exp(cum_t)·exp(−cum_j), so |log w| ≤ MAX_NEG_LOGW keeps
#: a chunk's exponents within fp32 (32 · 2 = 64 < 88)
MAX_NEG_LOGW = 2.0


def init_rwkv_layer(normal, full, uniform, cfg: ModelConfig) -> dict:
    """One RWKV layer's parameters in the reference's layout, scales and
    dtypes (``rwkv.py:38-69``): ``normal(shape, scale, dtype=None)`` draws
    a weight in the model's dtype, ``full(shape, value, dtype=None)``
    fills one, ``uniform(shape)`` draws from [0, 1); ``decay_base``,
    ``bonus`` and the group norm's ``ln_w``/``ln_b`` are fp32."""
    d, f = cfg.d_model, cfg.d_ff
    hs = cfg.rwkv_head_size
    nh = d // hs
    s = d ** -0.5
    f32 = torch.float32
    return {
        "tm": {
            "mu_base": uniform((d,)),
            "mu": uniform((5, d)),
            "ddlerp_w1": normal((d, 5 * LORA_R), s),
            "ddlerp_w2": normal((5, LORA_R, d), LORA_R ** -0.5),
            "receptance": normal((d, d), s),
            "key": normal((d, d), s),
            "value": normal((d, d), s),
            "gate": normal((d, d), s),
            "output": normal((d, d), s),
            "decay_base": full((d,), -6.0, f32),
            "decay_w1": normal((d, 64), s),
            "decay_w2": normal((64, d), 64 ** -0.5),
            "bonus": normal((nh, hs), 0.1, f32),
            "ln_w": full((d,), 1.0, f32),  # the per-head group norm
            "ln_b": full((d,), 0.0, f32),
        },
        "cm": {
            "mu_k": uniform((d,)),
            "mu_r": uniform((d,)),
            "key": normal((d, f), s),
            "value": normal((f, d), f ** -0.5),
            "receptance": normal((d, d), s),
        },
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Shift right by one along the sequence; ``prev`` (B, 1, D) fills
    position 0 (zeros without it)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(x: torch.Tensor, xx: torch.Tensor, p: dict) -> torch.Tensor:
    """Finch's data-dependent lerp → the five mixed inputs (5, B, S, D):
    w, k, v, r, g."""
    dx = xx - x
    base = x + dx * p["mu_base"]
    b, s, _ = x.shape
    lora = torch.tanh(base @ p["ddlerp_w1"]).reshape(b, s, 5, LORA_R)
    dyn = torch.einsum("bsfr,frd->fbsd", lora, p["ddlerp_w2"])
    return x[None] + dx[None] * (p["mu"][:, None, None, :] + dyn)


def _wkv_chunks(r, k, v, w, u, s0, chunk: int):
    """The chunked recurrence (see the module docstring) over (B, S, H, hs)
    fp32 (or fp64) tensors → (y (B, S, H, hs), the last state (B, H, hs,
    hs))."""
    b, s, h, hs = r.shape
    c = min(chunk, s)
    n = -(-s // c)
    pad = n * c - s
    if pad:  # the ragged last chunk: k = v = 0 and w = 1 change no state
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    rc, kc, vc, wc = (x.reshape(b, n, c, h, hs) for x in (r, k, v, w))
    logw = torch.log(wc)  # within (−MAX_NEG_LOGW, 0]: clamped at source
    cum = torch.cumsum(logw, dim=2)  # log of w_1 ⋯ w_t within the chunk
    rdec = rc * torch.exp(cum - logw)  # r_t · w_1 ⋯ w_{t-1}
    # intra-chunk: score[t, j] = Σ_k r_t k_j w_{j+1} ⋯ w_{t-1}, j < t
    att = torch.einsum("bnthk,bnjhk->bnhtj", rdec, kc * torch.exp(-cum))
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    att = torch.where(tri, att, 0.0)
    y_intra = torch.einsum("bnhtj,bnjhv->bnthv", att, vc)
    # the bonus diagonal: (r_t · (u ⊙ k_t)) v_t
    diag = torch.einsum("bnthk,bnthk->bnth", rc, kc * u)[..., None] * vc
    # each chunk's state map: S_out = D S_in + U
    last = cum[:, :, -1:]
    dec = torch.exp(last[:, :, 0])[..., None]  # (B, n, H, hs, 1)
    upd = torch.einsum("bnjhk,bnjhv->bnhkv", kc * torch.exp(last - cum), vc)
    states, st = [], s0
    for i in range(n):
        states.append(st)
        st = dec[:, i] * st + upd[:, i]
    s_in = torch.stack(states, dim=1)  # the state entering each chunk
    y_in = torch.einsum("bnthk,bnhkv->bnthv", rdec, s_in)
    y = y_in + y_intra + diag
    return y.reshape(b, n * c, h, hs)[:, :s], st


def _wkv_chunked(r, k, v, w, u, s0, chunk: int = CHUNK):
    """WKV recurrence over (B, S, H, hs) fp32 (or fp64) tensors from the state
    ``s0`` (B, H, hs, hs) → (y, the last state); under autograd the chunk
    work is recomputed in the backward."""
    args = (r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return ckpt.checkpoint(_wkv_chunks, *args, chunk,
                               use_reentrant=False)
    return _wkv_chunks(*args, chunk)


def _wkv_step(r, k, v, w, u, s0):
    """One token of the recurrence: (B, 1, H, hs) tensors → (y, S)."""
    kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]  # (B, H, hs, hs)
    y = torch.einsum("bhk,bhkv->bhv", r[:, 0], u[..., None] * kv + s0)
    return y[:, None], w[:, 0, :, :, None] * s0 + kv


def _wkv_steps(r, k, v, w, u, s0):
    ys, st = [], s0
    for t in range(r.shape[1]):
        y, st = _wkv_step(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                          w[:, t:t + 1], u, st)
        ys.append(y)
    return torch.cat(ys, dim=1), st


def _wkv_plain(r, k, v, w, u, s0, chunk: int = CHUNK):
    """Plain version of :func:`_wkv_chunked`: the one-step recurrence token
    by token; under autograd each ``chunk`` of steps is recomputed in the
    backward, so it keeps one chunk's states at a time."""
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (r, k, v, w, u, s0))
    ys, st = [], s0
    for c0 in range(0, r.shape[1], chunk):
        args = tuple(x[:, c0:c0 + chunk] for x in (r, k, v, w)) + (u, st)
        y, st = ckpt.checkpoint(_wkv_steps, *args, use_reentrant=False) \
            if grad else _wkv_steps(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), st


def _group_norm_heads(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      nh: int, eps: float = 64e-5) -> torch.Tensor:
    b, s, d = x.shape
    xh = x.reshape(b, s, nh, d // nh)
    mu = xh.mean(-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return xh.reshape(b, s, d) * w + bias


def _time_mix(x, p, cfg: ModelConfig, cache, wkv, split=None):
    """The time mix around ``wkv`` (the chunked scan or one step); the
    decays and the recurrence in fp32, or wider for a wider model.  The
    heads are those of ``p``'s projections: on a mesh (``split``) this
    rank's, the mixed inputs of the projections entering the rank's part
    and the output projection's partial products summed."""
    b, s, _ = x.shape
    hs = cfg.rwkv_head_size
    d = p["receptance"].shape[-1]  # this rank's heads' width
    nh = d // hs
    acc = torch.promote_types(x.dtype, torch.float32)
    xx = _token_shift(x, None if cache is None else cache["shift_tm"])
    mixed = _ddlerp(x, xx, p)
    lora = torch.tanh(mixed[0] @ p["decay_w1"])
    if split is not None:
        mixed, lora = split.enter(mixed[1:]), split.enter(lora)
    else:
        mixed = mixed[1:]
    xk, xv, xr, xg = mixed
    r = (xr @ p["receptance"]).reshape(b, s, nh, hs)
    k = (xk @ p["key"]).reshape(b, s, nh, hs)
    v = (xv @ p["value"]).reshape(b, s, nh, hs)
    g = F.silu(xg @ p["gate"])
    decay = p["decay_base"] + lora @ p["decay_w2"]
    w = torch.exp(-torch.exp(decay.to(acc))).reshape(b, s, nh, hs)
    w = torch.clamp(w, min=math.exp(-MAX_NEG_LOGW))  # numerical guard
    s0 = x.new_zeros((b, nh, hs, hs), dtype=acc) if cache is None \
        else cache["wkv"]
    with record_function("rwkv_wkv"):
        y, s_last = wkv(r.to(acc), k.to(acc), v.to(acc), w,
                        p["bonus"].to(acc), s0)
    y = _group_norm_heads(y.reshape(b, s, d), p["ln_w"], p["ln_b"], nh)
    out = (y.to(x.dtype) * g) @ p["output"]
    if split is not None:
        out = split.exit(out)
    new_cache = None if cache is None else {"shift_tm": x[:, -1:],
                                            "wkv": s_last}
    return out, new_cache


def rwkv_time_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  cache: dict | None = None, *, plain: bool = False,
                  split=None):
    """(B, S, D) → (B, S, D) over the chunked scan (its plain version with
    ``plain``); with ``cache`` (``shift_tm``, ``wkv``) it starts from that
    state and returns the new one, else None.  On a mesh (``split``)
    ``p`` and ``wkv`` are this rank's heads (:func:`_time_mix`)."""
    return _time_mix(x, p, cfg, cache, _wkv_plain if plain else _wkv_chunked,
                     split)


def rwkv_channel_mix(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     cache: dict | None = None, split=None):
    """(B, S, D) → (B, S, D); with ``cache`` (``shift_cm``) it shifts in
    that token and returns the new one, else None.  On a mesh (``split``)
    ``p`` holds this rank's columns of ``key`` (of d_ff), ``value`` and
    ``receptance`` (of d): the hidden activation's columns are gathered
    whole for ``value``'s slice (its gradient reduce-scattered), and the
    output's columns gathered, as the reference's compiled step does."""
    xx = _token_shift(x, None if cache is None else cache["shift_cm"])
    xk = x + (xx - x) * p["mu_k"]
    xr = x + (xx - x) * p["mu_r"]
    if split is not None:
        xk, xr = split.enter(torch.stack([xk, xr]))
    k = torch.square(F.relu(xk @ p["key"]))
    if split is not None:
        k = split.join(k, summed=True)
    out = torch.sigmoid(xr @ p["receptance"]) * (k @ p["value"])
    if split is not None:
        out = split.join(out, summed=False)
    return out, (None if cache is None else {"shift_cm": x[:, -1:]})


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device=None) -> dict:
    """Zero decode states: the two token shifts in ``dtype``, the WKV
    state in fp32."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    return {
        "shift_tm": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32,
                           device=device),
    }


def rwkv_time_mix_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                         cache: dict, split=None):
    """One token (B, 1, D) of the time mix by the single-step recurrence
    → (output, new ``shift_tm`` and ``wkv``); on a mesh over this rank's
    heads of ``wkv`` (:func:`_time_mix`)."""
    return _time_mix(x, p, cfg, cache, _wkv_step, split)


def rwkv_channel_mix_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                            cache: dict, split=None):
    return rwkv_channel_mix(x, p, cfg, cache, split)
