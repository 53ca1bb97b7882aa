"""The attention backward's plain version against the reference, on the CPU.

``attention_backward_plain`` (the explicit formulas the backward kernels
compute, fed by ``attention_lse_plain``) is held against ``jax.vjp`` of the
reference's ``repro/models/layers.py:attention`` and against autograd
through the port's ``attention_plain``, on the same numpy inputs: dense
and chunked paths (``DENSE_ATTN_ELEMS`` and ``KV_CHUNK`` lowered in both
packages at call time), MHA, GQA and MQA, causal or not, windows, S != T
with a query offset, lengths that are no tile multiple.  Tolerance: 2e-5
of the largest |gradient| (fp32 sums of a few hundred terms in another
order; measured ~1e-6).  ``attention_lse_plain`` is held against a float64
log-sum-exp at 1e-5.  A row with no valid key is where the port differs
on purpose: its lse is −inf and its gradients are 0 (the reference's
softmax over −1e30 scores spreads such a row evenly).  The kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda_kernels.py``.

The bf16 backward kernels' arithmetic is modelled here in torch
(:func:`_tensor_core_model`) and held to the card's bf16 gate: its error
against the fp32 plain backward at most ``BF16_FACTOR`` × the bf16 plain
backward's.  The model decided the kernels' rounding before any chip run:
P and dS rounded once to bf16, as FlashAttention-2 rounds them, put dV
(P) and dQ and dK (dS) up to 1.7× and 2.8× over the plain error on these
cases, so both enter their products as bf16 hi + lo pairs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.layers as RL
from repro_torch.kernels import flash_attention as kfa

GRAD_RTOL = 2e-5
LSE_ATOL = 1e-5

CASES = [  # b, s, t, h, kvh, hd, causal, window, q_offset
    (2, 96, 96, 4, 4, 32, True, None, 0),      # MHA
    (2, 130, 130, 6, 2, 16, True, None, 0),    # GQA, ragged
    (1, 97, 97, 4, 1, 20, True, 40, 0),        # MQA, window
    (2, 70, 70, 4, 2, 32, False, None, 0),     # not causal
    (1, 50, 123, 6, 3, 16, False, None, 0),    # S != T
    (1, 60, 150, 4, 2, 16, True, None, 90),    # a continued prompt
    (1, 60, 150, 4, 2, 16, True, 33, 90),      # ... with a window
    (1, 64, 64, 2, 2, 32, False, 16, 0),       # window, not causal
]
IDS = ["mha", "gqa-ragged", "mqa-window", "not-causal", "s!=t",
       "q-offset", "q-offset-window", "window-not-causal"]


def _inputs(seed, b, s, t, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in (
        (b, s, h, hd), (b, t, kvh, hd), (b, t, kvh, hd), (b, s, h, hd)))


@pytest.fixture(params=["dense", "chunked"])
def path(request, monkeypatch):
    """Both packages' dense path, or their chunked one (the plain backward
    then goes in query chunks too)."""
    if request.param == "chunked":
        for mod in (RL, kfa):
            monkeypatch.setattr(mod, "DENSE_ATTN_ELEMS", 32 * 32)
            monkeypatch.setattr(mod, "KV_CHUNK", 32)
    return request.param


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = GRAD_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset", CASES,
                         ids=IDS)
def test_backward_plain_matches_jax_vjp_and_autograd(
        path, b, s, t, h, kvh, hd, causal, window, q_offset):
    q, k, v, do = _inputs(s + t + h, b, s, t, h, kvh, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = kfa.attention_lse_plain(tq, tk, tv, **kw)
    assert torch.isfinite(lse).all()
    got = kfa.attention_backward_plain(tq, tk, tv, out, tdo, lse, **kw)

    ref_out, vjp = jax.vjp(lambda a, bb, c: RL.attention(a, bb, c, **kw),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-4)
    for name, g, want in zip("qkv", got, vjp(jnp.asarray(do))):
        _close(g.numpy(), want, f"d{name} vs jax.vjp")

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    kfa.attention_plain(*leaves, **kw).backward(tdo)
    for name, g, leaf in zip("qkv", got, leaves):
        _close(g.numpy(), leaf.grad.numpy(), f"d{name} vs autograd")


def _lse_oracle(q, k, causal, window, q_offset):
    """float64 log-sum-exp of each row's scaled, masked scores, −inf for a
    row with no valid key; (B, H, S)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), h // kvh, axis=2)
    sc = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kk) * hd ** -0.5
    qpos = np.arange(s)[:, None] + q_offset
    kpos = np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    sc = np.where(mask, sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = m[..., 0] + np.log(np.exp(sc - np.where(np.isinf(m), 0, m))
                                 .sum(-1))
    return lse


@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset",
                         CASES + [(1, 40, 40, 2, 1, 16, True, None, -30)],
                         ids=IDS + ["rows-without-keys"])
def test_lse_plain_matches_logsumexp(path, b, s, t, h, kvh, hd, causal,
                                     window, q_offset):
    q, k, v, _ = _inputs(7, b, s, t, h, kvh, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = kfa.attention_lse_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v)), **kw)
    want = _lse_oracle(q, k, causal, window, q_offset)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    got = lse.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=LSE_ATOL, rtol=0)
    np.testing.assert_array_equal(
        out.numpy(), kfa.attention_plain(*(torch.from_numpy(x)
                                           for x in (q, k, v)), **kw).numpy())


def test_rows_without_keys_have_zero_gradients():
    """Causal queries at positions −30 … 9: rows at negative positions see
    no key.  Their lse is −inf and, as the kernel gives them, their output
    gradient adds nothing anywhere; the other rows' gradients match
    autograd through the plain forward restricted to them."""
    q, k, v, do = _inputs(3, 1, 40, 40, 2, 1, 16)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    kw = dict(causal=True, q_offset=-30)
    out, lse = kfa.attention_lse_plain(tq, tk, tv, **kw)
    empty = torch.isinf(lse[0, 0])
    assert int(empty.sum()) == 30
    dq, dk, dv = kfa.attention_backward_plain(tq, tk, tv, out, tdo, lse,
                                              **kw)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert torch.equal(dq[:, :30], torch.zeros_like(dq[:, :30]))
    keep = tdo.clone()
    keep[:, :30] = 0
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    kfa.attention_plain(*leaves, **kw).backward(keep)
    for g, leaf in zip((dq[:, 30:], dk, dv),
                       (leaves[0].grad[:, 30:], leaves[1].grad,
                        leaves[2].grad)):
        _close(g.numpy(), leaf.numpy(), "rows with keys")


# ------------------------------------- the bf16 tensor-core kernels' model

BF16_FACTOR = 1.5
LOG2E = 1.4426950408889634

#: small versions of the card's cases: b, s, t, h, kvh, hd, causal,
#: window, q_offset
MODEL_CASES = [
    (2, 200, 200, 4, 4, 64, True, None, 0),     # G 1, ragged tiles
    (1, 256, 256, 3, 1, 64, True, None, 0),     # G 3
    (2, 191, 191, 8, 1, 64, True, None, 0),     # G 8
    (1, 512, 512, 2, 1, 128, True, None, 0),    # hd 128
    (1, 191, 191, 3, 3, 128, True, 70, 0),      # window 70
    (1, 130, 300, 8, 2, 128, False, None, 0),   # not causal, S != T
    (1, 127, 512, 8, 1, 64, True, None, 385),   # q_offset past 6 key tiles
    (1, 65, 3, 2, 1, 64, False, None, 0),       # three keys
]
MODEL_IDS = ["g1", "g3", "g8", "hd128", "window70", "s!=t", "q-offset",
             "three-keys"]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    """x as the kernels feed it to the tensor cores: a bf16 hi + lo pair,
    each rounded to nearest even."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _tensor_core_model(q, k, v, do, causal, window, q_offset, tile=64,
                       residual=True):
    """The bf16 kernels' arithmetic on bf16 ``q, k, v, do``: the forward
    (products exact in fp32, P = exp(s·scale − row max) rounded to bf16
    before P·V, O rounded once, and what the rounding dropped kept as a
    second bf16 tensor) and the backward (D from O as that hi + lo pair,
    or from the bf16 O alone with ``residual=False``, and dO;
    P = 2^(s·scale·log2 e − lse·log2 e) on valid pairs; dS = P ∘ (dP −
    D); P and dS as hi + lo pairs; fp32 sums over ``tile``-row query tiles,
    head by head, for dK and dV and over ``tile``-key tiles for dQ, as the
    kernels walk them; each gradient rounded to bf16 once)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = q.float().reshape(b, s, kvh, g, hd)
    dog = do.float().reshape(b, s, kvh, g, hd)
    kf, vf = k.float(), v.float()
    sc = torch.einsum("bsngd,btnd->bngst", qg, kf)
    qpos = torch.arange(s) + q_offset
    valid = kfa._mask(qpos, torch.arange(t), causal, window)
    scm = torch.where(valid, sc * scale, float("-inf"))
    lse = torch.logsumexp(scm, -1)
    seen = torch.isfinite(lse)
    mx = torch.where(seen, scm.amax(-1), 0.0)
    pu = torch.exp(scm - mx[..., None])
    den = torch.clamp(pu.sum(-1), min=1e-30).permute(0, 3, 1, 2)[..., None]
    o32 = torch.einsum("bngst,btnd->bsngd", _bf16(pu), vf) / den
    out = _hi_lo(o32) if residual else _bf16(o32)
    delta = (dog * out).sum(-1).permute(0, 2, 3, 1)
    l2 = torch.where(seen, lse * LOG2E, float("inf"))
    p = torch.where(valid, torch.exp2(sc * (scale * LOG2E) - l2[..., None]),
                    0.0)
    dp = torch.einsum("bsngd,btnd->bngst", dog, vf)
    ds = _hi_lo(p * (dp - delta[..., None]))
    p = _hi_lo(p)
    dk = torch.zeros((b, t, kvh, hd))
    dv = torch.zeros((b, t, kvh, hd))
    for gi in range(g):
        for r0 in range(0, s, tile):
            rows = slice(r0, r0 + tile)
            dv += torch.einsum("bnst,bsnd->btnd", p[:, :, gi, rows],
                               dog[:, rows, :, gi])
            dk += torch.einsum("bnst,bsnd->btnd", ds[:, :, gi, rows],
                               qg[:, rows, :, gi])
    dq = torch.zeros((b, s, kvh, g, hd))
    for k0 in range(0, t, tile):
        keys = slice(k0, k0 + tile)
        dq += torch.einsum("bngst,btnd->bsngd", ds[..., keys], kf[:, keys])
    return (_bf16(scale * dq.reshape(b, s, h, hd)), _bf16(scale * dk),
            _bf16(dv))


@pytest.mark.parametrize("residual", [False, True])
def test_output_residual_keeps_shared_values_within_the_bf16_gate(
        residual):
    """Values that share a common part (v = 3 + 0.1 · noise, as a layer's
    values often do): then dP − D = dO·(v_j − O) is small against D =
    dO·O, and D taken from the bf16-rounded O shifts a whole row's dS =
    P ∘ (dP − D) by O's rounding.  The model's gradients of q and k then
    miss the LM gate (BF16_FACTOR × the error of autograd through the
    bf16 plain forward, against fp32); with O's rounding residual in D
    (the kernels since whisper-small's gradient missed that gate) every
    gradient is within it."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(11, 2, 256, 256, 4,
                                                         4, 64))
    q, k, v, do = (a.to(torch.bfloat16) for a in (q, k, 3 + 0.1 * v, do))
    kw = dict(causal=True, window=None, q_offset=0)
    f32 = [a.float() for a in (q, k, v, do)]
    o32, l32 = kfa.attention_lse_plain(*f32[:3], **kw)
    exact = kfa.attention_backward_plain(*f32[:3], o32, f32[3], l32, **kw)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    plain = torch.autograd.grad(kfa.attention_plain(*leaves, **kw), leaves,
                                do)
    model = _tensor_core_model(q, k, v, do, residual=residual, **kw)
    ratios = [float((got - want).abs().max())
              / float((p.float() - want).abs().max())
              for got, p, want in zip(model, plain, exact)]
    if residual:
        assert max(ratios) <= BF16_FACTOR, ratios
    else:
        assert max(ratios[:2]) > BF16_FACTOR, ratios


@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset",
                         MODEL_CASES, ids=MODEL_IDS)
def test_tensor_core_rounding_within_the_bf16_gate(b, s, t, h, kvh, hd,
                                                   causal, window,
                                                   q_offset):
    """The model's dq, dk and dv against the fp32 plain backward on fp32
    copies of the bf16 inputs: each max error at most BF16_FACTOR × that
    of the plain backward run from the bf16 inputs and their bf16 plain
    forward (the card's gate, ``_hold_backward_against_plain``)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(s + t + h, b, s, t, h, kvh, hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    f32 = [x.float() for x in (q, k, v, do)]
    o32, l32 = kfa.attention_lse_plain(*f32[:3], **kw)
    exact = kfa.attention_backward_plain(*f32[:3], o32, f32[3], l32, **kw)
    o16, l16 = kfa.attention_lse_plain(q, k, v, **kw)
    plain = kfa.attention_backward_plain(q, k, v, o16, do, l16, **kw)
    model = _tensor_core_model(q, k, v, do, **kw)
    for name, got, p, want in zip("qkv", model, plain, exact):
        err = float((got - want).abs().max())
        tol = BF16_FACTOR * float((p.float() - want).abs().max())
        assert err <= tol, (f"d{name}", err, tol)
