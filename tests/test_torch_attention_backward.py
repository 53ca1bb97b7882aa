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
