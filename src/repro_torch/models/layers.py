"""Transformer layers of the language models: RMS and layer norm, RoPE and
sinusoidal positions, GQA attention (full-sequence and single-token
decode), the SwiGLU and gelu MLPs.

A port of ``repro/models/layers.py`` with its conventions: activations
``(B, S, D)``, heads ``(B, S, H, head_dim)``, KV caches ``(B, T, KVH,
head_dim)``, ``H = KVH · G``; norm and softmax statistics in fp32 whatever
the activation dtype.  Full-sequence attention is
``kernels/flash_attention.py``: the hand-written kernel on a CUDA tensor,
its plain version on a CPU one or when the caller asks for it
(``plain=True``).

Under mesh rules (``parallel/sharding.py``; the steps of
``launch/steps.py`` install them) a layer sees this rank's slices of its
weights, and what crosses ranks is activations.  Where a weight arrives
cut over ``model`` the layer runs the Megatron split: :func:`model_in`
enters the region (identity forward, the gradient summed over
``model``), each rank computes its heads or its d_ff columns (the gelu
MLP's output bias left for after the sum), and :func:`model_out` sums the
partial outputs.  Attention, the vocab-cut embedding and head, and the
Mamba and RWKV layers run their splits through a :class:`Split`
(``models/transformer.py``).  The reference's
``shard(...)`` hints have no counterpart: a rank's activations are
already its own rows.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as kfa

__all__ = ["resolve_dtype", "rms_norm", "layer_norm", "apply_rope",
           "sinusoidal_positions", "attention", "decode_attention",
           "decode_attention_sharded",
           "swiglu_mlp", "gelu_mlp", "model_in", "model_out"]


def resolve_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(S,) → (S, dim) fp32 sinusoidal embeddings (whisper-style): sines
    of ``dim // 2`` frequencies, then their cosines."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embeddings.  ``x``: (B, S, H, hd); ``positions``: (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, plain: bool = False) -> torch.Tensor:
    """Full-sequence attention: ``q`` (B, S, H, hd), ``k``/``v`` (B, T,
    KVH, hd); ``q_offset`` is the position of q[0] relative to k[0].  The
    flash-attention kernel on a CUDA tensor (its plain version with
    ``plain=True``), the plain version on a CPU tensor."""
    fn = kfa.attention_plain if plain else kfa.flash_attention
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a padded cache: ``q`` (B, 1, H, hd),
    caches (B, T, KVH, hd), ``cache_len`` the number of valid entries (the
    new token's k/v already written; a ring-buffer cache has every slot
    valid).  A dense product over the cache, as in the reference."""
    b, _, h, hd = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd) * (hd ** -0.5)
    scores = kfa.gqa_scores(qg, k_cache)  # (B, KVH, G, 1, T)
    valid = torch.arange(t, device=q.device) < cache_len
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnd->bsngd", probs, v_cache)
    return out.reshape(b, 1, h, hd)


def decode_attention_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len: torch.Tensor,
                             offset: int, mesh, axes) -> torch.Tensor:
    """:func:`decode_attention` over a cache cut by slot over the mesh
    ``axes``: ``k_cache``/``v_cache`` are this rank's slots (B, T', KVH,
    hd), global slots ``offset`` onward, and slots ``< cache_len`` are
    valid.  Each rank scores its slots; the largest score is taken over
    ``axes`` (one max), then each rank's sum of exponentials and its
    unnormalised P·V are summed over them (two sums), and the output is
    their quotient, in q's dtype (the flash-decode combine)."""
    from repro_torch.parallel import collectives as C

    b, _, h, hd = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd) * (hd ** -0.5)
    scores = kfa.gqa_scores(qg, k_cache)  # (B, KVH, G, 1, T')
    valid = torch.arange(t, device=q.device) + offset < cache_len
    scores = torch.where(valid, scores, -1e30)
    m = C.all_reduce(scores.amax(dim=-1, keepdim=True), mesh, axes, "max")
    p = torch.exp(scores - m)
    den = C.all_reduce(p.sum(dim=-1, keepdim=True), mesh, axes)
    num = C.all_reduce(torch.einsum("bngst,btnd->bsngd", p,
                                    v_cache.float()), mesh, axes)
    out = num / den.permute(0, 3, 1, 2, 4)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ w_gate) * (x @ w_in)) @ w_out."""
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor,
             b_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gelu(x @ w_in + b_in) @ w_out + b_out, gelu's tanh approximation
    (``jax.nn.gelu``'s default); without ``b_out`` where a split layer
    adds it after the ranks' sum."""
    out = F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out
    return out if b_out is None else out + b_out


def model_in(x: torch.Tensor) -> torch.Tensor:
    """Enter a region split over the ``model`` axis: ``x`` as it is, its
    gradient summed over the axis (each rank's part of the region adds
    its share)."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import active_rules

    rules = active_rules()
    return C.CopyTo.apply(x, rules.mesh, rules.axes("model"))


def model_out(x: torch.Tensor) -> torch.Tensor:
    """Leave a region split over the ``model`` axis: the ranks' partial
    results summed (the gradient passes as it is)."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import active_rules

    rules = active_rules()
    return C.ReduceFrom.apply(x, rules.mesh, rules.axes("model"))


class Split(NamedTuple):
    """A layer's work cut over the mesh axes ``axes``, each rank computing
    its part (an attention layer's column blocks, the embedding's vocab
    rows and the head's vocab columns, a Mamba layer's ``d_inner`` slice,
    an RWKV layer's heads and channel-mix columns), with the autograd
    forms of
    ``parallel/collectives.py`` at its edges, so the forward and its
    gradient both hold."""
    mesh: Any
    axes: tuple[str, ...]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, whole on every rank, as the region's input: its gradient
        summed over the ranks' parts."""
        from repro_torch.parallel import collectives as C

        return C.CopyTo.apply(x, self.mesh, self.axes)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' partial products summed: the region's output, whole
        on every rank."""
        from repro_torch.parallel import collectives as C

        return C.ReduceFrom.apply(x, self.mesh, self.axes)

    def join(self, x: torch.Tensor, summed: bool) -> torch.Tensor:
        """The ranks' column slices ``x`` joined along the last dim.  The
        gradient of the whole is reduce-scattered when ``summed`` (each
        rank's use of it gives a partial gradient), else each rank keeps
        its own columns of it (every rank's gradient is the same)."""
        from repro_torch.parallel import collectives as C

        return C.GatherParam.apply(
            x, self.mesh, ((x.dim() - 1, self.axes),),
            frozenset(self.axes) if summed else frozenset())

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of ``x``, whole on every rank;
        the gradient gathered (``collectives.OwnChunk``)."""
        from repro_torch.parallel import collectives as C

        return C.OwnChunk.apply(x, self.mesh, self.axes, dim)

    def index(self) -> tuple[int, int]:
        """(this rank's part, the number of parts)."""
        from repro_torch.parallel.sharding import chunk_of

        return chunk_of(self.mesh, self.axes)
