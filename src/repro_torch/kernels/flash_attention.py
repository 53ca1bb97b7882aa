"""Flash attention with GQA and causal / sliding-window masks — CUDA kernel.

Replaces ``repro/kernels/flash_attention.py:flash_attention_pallas``, and
on the card it is the model's full-sequence attention too: the reference's
language models call ``repro/models/layers.py:attention``, a pure-JAX
online-softmax twin of the Pallas kernel, which never reaches the kernel.
:func:`attention_plain` is a port of that twin (dense masked scores for
small problems, query chunks each scanning only the KV chunks their masks
reach for large ones); :func:`flash_attention` launches
``csrc/flash_attention.cu`` on a CUDA tensor.

Layout: q ``(B, S, H, hd)``, k and v ``(B, T, KVH, hd)``; query head ``h``
reads KV head ``h // (H // KVH)``; query row ``i`` sits at position ``i +
q_offset``.  Bound: the score and P·V products, 4·hd operations per
unmasked (query, key) pair.  bf16 runs them on the tensor cores
(``mma.sync``, FlashAttention-2 style, probabilities rounded to bf16 like
the plain version's); fp32, the parity path, as fp32 FFMA.  Both kernels
skip key tiles the masks remove whole.  They are inference-only: there is
no backward yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "DENSE_ATTN_ELEMS", "KV_CHUNK", "MAX_Q_CHUNKS",
           "HEAD_DIMS", "attention_plain", "flash_attention", "gqa_scores"]

#: kernel launches made by :func:`flash_attention`
LAUNCHES = 0

DENSE_ATTN_ELEMS = 2048 * 2048  # dense plain path for S·T up to this
KV_CHUNK = 1024
MAX_Q_CHUNKS = 32  # bound on the plain path's query chunks
#: head dims the kernel is built for
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gqa_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, S, KVH, G, hd) × k (B, T, KVH, hd) → (B, KVH, G, S, T) fp32
    scores: both cast to fp32 first, so bf16 products are exact and summed
    in fp32 (the reference's ``preferred_element_type``)."""
    return torch.einsum("bsngd,btnd->bngst", qg.float(), k.float())


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int | None, t: int | None = None) -> torch.Tensor:
    """(S, T') validity of each (query, key) pair; ``t`` masks padding."""
    mask = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                      device=qpos.device)
    if t is not None:
        mask &= kpos[None, :] < t
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`, a port of the
    reference's ``layers.attention``: q is scaled in its own dtype, scores
    and softmax statistics are fp32, probabilities are cast to q's dtype
    before the P·V product.  ``DENSE_ATTN_ELEMS`` and ``KV_CHUNK`` are
    read at call time."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd) * (hd ** -0.5)
    if s * t <= DENSE_ATTN_ELEMS:
        scores = gqa_scores(qg, k)  # (B, KVH, G, S, T)
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = _mask(qpos, kpos, causal, window)
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bngst,btnd->bsngd", probs, v)
        return out.reshape(b, s, h, hd)

    qc = max(KV_CHUNK, s // MAX_Q_CHUNKS)
    n_q = -(-s // qc)
    outs = []
    for i in range(n_q):
        q_i = qg[:, i * qc: (i + 1) * qc]
        sc = q_i.shape[1]
        lo_pos = i * qc + q_offset
        hi_pos = lo_pos + sc - 1
        lo = 0
        if window is not None:
            lo = max(0, (lo_pos - window + 1) // KV_CHUNK)
        hi = -(-min(hi_pos + 1, t) // KV_CHUNK) if causal \
            else -(-t // KV_CHUNK)
        hi = max(min(hi, -(-t // KV_CHUNK)), lo + 1)
        k_i = k[:, lo * KV_CHUNK: hi * KV_CHUNK]
        v_i = v[:, lo * KV_CHUNK: hi * KV_CHUNK]
        o = _attention_kv_chunked(
            q_i, k_i, v_i, causal=causal, window=window,
            q_offset=lo_pos - lo * KV_CHUNK)
        outs.append(o.reshape(b, sc, h, hd))
    return torch.cat(outs, dim=1)


def _attention_kv_chunked(qg, k, v, *, causal, window, q_offset,
                          chunk: int = KV_CHUNK):
    """Online-softmax loop over KV chunks (the flash-attention recurrence);
    as in the reference, ``chunk`` defaults to the import-time
    ``KV_CHUNK`` and the accumulator keeps q's dtype."""
    b, s, kvh, g, hd = qg.shape
    t = k.shape[1]
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = torch.arange(s, device=qg.device) + q_offset
    m = torch.full((b, kvh, g, s), -1e30, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((b, kvh, g, s), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, kvh, g, s, hd), dtype=qg.dtype, device=qg.device)
    for ci in range(n_chunks):
        kci = k[:, ci * chunk: (ci + 1) * chunk]
        vci = v[:, ci * chunk: (ci + 1) * chunk]
        scores = gqa_scores(qg, kci)  # (B, KVH, G, S, chunk)
        kpos = ci * chunk + torch.arange(chunk, device=qg.device)
        mask = _mask(qpos, kpos, causal, window, t)
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bngst,btnd->bngsd", p.to(qg.dtype), vci)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)  # (B, S, KVH, G, hd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: expected q (B, S, H, hd) and "
                         f"k, v (B, T, KVH, hd) with KVH dividing H; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim "
                         f"{' or '.join(map(str, HEAD_DIMS))}, got "
                         f"{q.shape[3]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k and v must share a dtype; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, "
                         f"got {window}")
    if max(q.shape[1], k.shape[1], abs(q_offset)) >= 2 ** 30 \
            or q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} or "
                         f"q_offset {q_offset} is out of the kernel's range")
    _build.check_device(q, k, v, dtypes=tuple(_DTYPES))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q ``(B, S, H, hd)`` over k, v ``(B, T, KVH, hd)`` →
    ``(B, S, H, hd)`` in q's dtype.  A CPU tensor takes
    :func:`attention_plain`; a CUDA tensor launches the kernel (fp32 or
    bf16, head_dim 64 or 128, contiguous) or raises — also when autograd
    would need a gradient, which the kernel does not have."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: LM training waits for "
            "ROADMAP Queue 1 item 7.1 (run under torch.no_grad or "
            "torch.inference_mode)")
    _check(q, k, v, window, q_offset)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _build.library().jk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t,
        h, kvh, hd, int(causal), 0 if window is None else int(window),
        int(q_offset), float(hd ** -0.5), _DTYPES[q.dtype],
        _build.stream_of(q))
    _build.launch_check(err, "flash_attention")
    LAUNCHES += 1
    return out
