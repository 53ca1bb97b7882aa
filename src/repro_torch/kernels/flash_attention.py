"""Flash attention with GQA and causal / sliding-window masks — CUDA kernel,
forward and backward.

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
skip key tiles the masks remove whole.

The gradient: the reference differentiates ``layers.attention`` with
XLA's autodiff.  On the card full-sequence attention is the kernel, so
the port writes the FlashAttention-2 backward by hand (the same ``.cu``):
the forward saves each row's log-sum-exp (and in bf16 what rounding O to
bf16 dropped, so that D sees O to ~2^-17: with D taken from the rounded O
alone, a row's common error shifts every dS of a near-uniform row, and
the gradients of q and k exceeded 1.5× the bf16 plain path's error at
whisper's shapes), and three launches recompute the probabilities from
it (D = rowsum(dO ∘ O), then dK/dV, then dQ; no
atomics, so two calls give the same bits): bf16 runs all five products on
the tensor cores (``mma.sync``, P and dS as bf16 hi + lo pairs, so the
gradients stay within the bf16 plain backward's error), fp32 as fp32
FFMA.  :func:`attention_backward_plain` is their plain version,
:func:`attention_lse_plain` the forward's with its log-sum-exp.
A row with no valid key comes out 0 and has zero gradients (its lse is
−inf).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.introspect import opcount
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "BWD_LAUNCHES", "DENSE_ATTN_ELEMS", "KV_CHUNK",
           "MAX_Q_CHUNKS", "HEAD_DIMS", "attention_plain",
           "attention_lse_plain", "attention_backward_plain",
           "flash_attention", "flash_attention_lse",
           "flash_attention_backward", "gqa_scores"]

#: forward kernel launches made by :func:`flash_attention`
LAUNCHES = 0
#: backward launches made by :func:`flash_attention_backward` (one
#: ``jk_flash_attention_bwd`` call: the preprocess, dK/dV and dQ kernels,
#: one each)
BWD_LAUNCHES = 0

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


def _masked_scores(qg: torch.Tensor, k: torch.Tensor, qpos: torch.Tensor,
                   causal: bool, window: int | None) -> torch.Tensor:
    """fp32 scores (B, KVH, G, S', T) of scaled query rows ``qg`` at
    positions ``qpos``, masked pairs −inf."""
    kpos = torch.arange(k.shape[1], device=k.device)
    mask = _mask(qpos, kpos, causal, window)
    return gqa_scores(qg, k).masked_fill(~mask, float("-inf"))


def _row_chunks(s: int, t: int) -> int:
    """Query rows a chunk of the plain backward: all of them while S·T is
    within ``DENSE_ATTN_ELEMS`` (read at call time), else as many as keep
    one chunk's scores within it."""
    return max(1, s) if s * t <= DENSE_ATTN_ELEMS \
        else max(1, DENSE_ATTN_ELEMS // t)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_plain`'s output and each row's log-sum-exp of its
    scaled, masked scores (fp32 ``(B, H, S)``; −inf for a row with no
    valid key), the pair the kernel's forward saves for the backward."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd) * (hd ** -0.5)
    rows = _row_chunks(s, t)
    lse = []
    for r0 in range(0, s, rows):
        qpos = torch.arange(r0, min(s, r0 + rows), device=q.device) \
            + q_offset
        sc = _masked_scores(qg[:, r0: r0 + rows], k, qpos, causal, window)
        lse.append(torch.logsumexp(sc, dim=-1))  # (B, KVH, G, S')
    lse = torch.cat(lse, dim=-1) if lse else \
        torch.empty((b, kvh, g, 0), device=q.device)
    out = attention_plain(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    return out, lse.reshape(b, h, s)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             q_offset: int = 0,
                             out_lo: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of the backward kernels: ``(dq, dk, dv)`` in q's dtype
    from the forward's ``out`` (plus ``out_lo``, what rounding it dropped,
    when given) and ``lse`` (``(B, H, S)`` fp32), by the
    explicit formulas in fp32 — P = exp(S·scale − lse) on unmasked pairs,
    dV = Pᵀ dO, dP = dO Vᵀ, D = rowsum(dO ∘ O), dS = P ∘ (dP − D), dQ =
    scale · dS K, dK = scale · dSᵀ Q (Q scaled in its dtype, as
    :func:`attention_plain` scales it), dK and dV summed over the G query
    heads of a group.  Query rows go in chunks whose scores stay within
    ``DENSE_ATTN_ELEMS`` (read at call time)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, s, kvh, g, hd) * scale  # in q's dtype, as forward
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, s, kvh, g, hd)
    o = out.float() if out_lo is None else out.float() + out_lo.float()
    delta = (dof * o.reshape(b, s, kvh, g, hd)).sum(-1)
    lse = lse.float().reshape(b, kvh, g, s)
    dq = torch.zeros((b, s, kvh, g, hd), device=q.device)
    dk = torch.zeros((b, t, kvh, hd), device=q.device)
    dv = torch.zeros((b, t, kvh, hd), device=q.device)
    rows = _row_chunks(s, t)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        qpos = torch.arange(r0, r1, device=q.device) + q_offset
        sc = _masked_scores(qg[:, r0:r1], k, qpos, causal, window)
        # exp(−inf) = 0 on masked pairs, also where lse is −inf
        p = torch.exp(sc - lse[..., r0:r1, None].masked_fill(
            torch.isinf(lse[..., r0:r1, None]), 0.0))
        do = dof[:, r0:r1]
        dv += torch.einsum("bngst,bsngd->btnd", p, do)
        dp = torch.einsum("bsngd,btnd->bngst", do, vf)
        ds = p * (dp - delta[:, r0:r1].permute(0, 2, 3, 1)[..., None])
        dq[:, r0:r1] = scale * torch.einsum("bngst,btnd->bsngd", ds, kf)
        dk += torch.einsum("bngst,bsngd->btnd", ds, qg[:, r0:r1].float())
    return (dq.reshape(b, s, h, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


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


def _forward(q, k, v, causal, window, q_offset, lse=None,
             out_lo=None) -> torch.Tensor:
    """One launch of the forward kernel; fills ``lse`` and (bf16)
    ``out_lo`` when given."""
    global LAUNCHES
    _check(q, k, v, window, q_offset)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _build.library().jk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if out_lo is None else out_lo.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, t, h, kvh, hd,
        int(causal), 0 if window is None else int(window), int(q_offset),
        float(hd ** -0.5), _DTYPES[q.dtype], _build.stream_of(q))
    _build.launch_check(err, "flash_attention")
    LAUNCHES += 1
    if opcount.counting():
        opcount.add_kernel_work(*opcount.attention_work(
            b, h, hd, opcount.attention_pairs(s, t, causal, window,
                                              q_offset),
            q.element_size(), q.numel(), k.numel(),
            0 if lse is None else lse.numel()))
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor | None]:
    """:func:`flash_attention`'s output and what the backward needs: each
    row's log-sum-exp (fp32 ``(B, H, S)``) and ``out_lo``, in bf16 what
    rounding the output to bf16 dropped (the backward's D then sees the
    output to ~2^-17; None in fp32).  One forward launch that also writes
    both on a CUDA tensor; :func:`attention_lse_plain` (and no ``out_lo``)
    on a CPU one."""
    if q.device.type == "cpu":
        return (*attention_lse_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset), None)
    b, s, h, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lo = torch.empty_like(q) if q.dtype == torch.bfloat16 else None
    return _forward(q, k, v, causal, window, q_offset, lse, lo), lse, lo


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             q_offset: int = 0,
                             out_lo: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` in q's dtype from the forward's ``out`` (and, in
    bf16, its ``out_lo``, which :func:`flash_attention_lse` returns and a
    bf16 CUDA call requires) and ``lse`` and the output's gradient
    ``dout`` (contiguous, q's dtype and shape): one
    ``jk_flash_attention_bwd`` call on a CUDA tensor (the preprocess,
    dK/dV and dQ kernels), :func:`attention_backward_plain` on a CPU
    one."""
    global BWD_LAUNCHES
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, out, dout, lse,
                                        out_lo=out_lo, **kw)
    _check(q, k, v, window, q_offset)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    is16 = q.dtype == torch.bfloat16
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, h, s) or (out_lo is None) == is16 or (
                is16 and (out_lo.shape != q.shape
                          or out_lo.dtype != torch.bfloat16)):
        raise ValueError(f"flash_attention_backward: out, dout (and in "
                         f"bf16 only, out_lo) must have q's shape "
                         f"{tuple(q.shape)} and lse {(b, h, s)}; got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}, out_lo "
                         f"{None if out_lo is None else tuple(out_lo.shape)}")
    _build.check_device(q, out, dout, *(() if out_lo is None else (out_lo,)),
                        dtypes=(q.dtype,))
    _build.check_device(lse, dtypes=(torch.float32,))
    if lse.device != q.device or any(x.data_ptr() % 16 for x in (out, dout)):
        raise ValueError("flash_attention_backward: lse must lie on q's "
                         "device and out, dout be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty_like(lse)
    err = _build.library().jk_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if out_lo is None else out_lo.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, t, h, kvh, hd, int(causal),
        0 if window is None else int(window), int(q_offset),
        float(hd ** -0.5), _DTYPES[q.dtype], _build.stream_of(q))
    _build.launch_check(err, "flash_attention backward")
    BWD_LAUNCHES += 1
    if opcount.counting():
        opcount.add_kernel_work(*opcount.attention_bwd_work(
            b, h, hd, opcount.attention_pairs(s, t, causal, window,
                                              q_offset),
            q.element_size(), q.numel(), k.numel(), lse.numel()))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel with its hand-written backward: the forward saves q, k,
    v, the output, each row's log-sum-exp and (bf16) the output's rounding
    residual; the backward launches the backward kernels and returns
    gradients in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse, lo = flash_attention_lse(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse, lo)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lo = ctx.saved_tensors
        # the o_proj matmul's backward may hand a strided gradient
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.to(q.dtype).contiguous(), lse, out_lo=lo,
            **ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q ``(B, S, H, hd)`` over k, v ``(B, T, KVH, hd)`` →
    ``(B, S, H, hd)`` in q's dtype.  A CPU tensor takes
    :func:`attention_plain` (autograd differentiates it); a CUDA tensor
    launches the kernel (fp32 or bf16, head_dim 64 or 128, contiguous) or
    raises, and when autograd needs a gradient of q, k or v it goes
    through the kernel's hand-written backward."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)
