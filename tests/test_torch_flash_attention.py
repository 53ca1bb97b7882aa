"""The port's attention against the reference: ``kernels/flash_attention.py``
(plain version on the CPU, the hand-written kernel on the card).

On the CPU the plain version is held against the reference's Pallas
kernel (``kernels.ops.flash_attention``, in interpret mode as
``tests/test_kernels.py`` runs it), its dense oracle
``ref.flash_attention_ref`` and the models' ``layers.attention`` on the
same numpy inputs, over the reference's own sweep (MHA, GQA, MQA with a
length that is no tile multiple, crossed with causal, non-causal and a
window of 64) at its tolerances: 2e-4 in fp32, 5e-2 for bf16.  The
chunked plain path is reached by lowering ``DENSE_ATTN_ELEMS`` and
``KV_CHUNK`` in both packages at test time.  The kernel itself is held
against the plain version on the card by
``tests/test_torch_cuda_kernels.py``, which imports no JAX.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.models.layers as RL
from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import layers as TL

SWEEP = [(128, 128, 4, 4, 32),   # MHA
         (256, 256, 8, 2, 64),   # GQA
         (96, 96, 4, 1, 32)]     # MQA, no tile multiple
MASKS = [(True, None), (False, None), (True, 64)]


def _qkv(rng, b, s, t, h, kvh, hd):
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, kvh, hd)).astype(np.float32),
            rng.normal(size=(b, t, kvh, hd)).astype(np.float32))


def _port(q, k, v, **kw):
    return TL.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        **kw).numpy()


@pytest.mark.parametrize("s,t,h,kvh,hd", SWEEP)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_pallas_and_dense_oracle(rng, s, t, h, kvh, hd,
                                               causal, window):
    q, k, v = _qkv(rng, 2, s, t, h, kvh, hd)
    got = _port(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(
        got, ops.flash_attention(jq, jk, jv, causal=causal, window=window),
        atol=2e-4)
    np.testing.assert_allclose(
        got, ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                     window=window), atol=2e-4)
    np.testing.assert_allclose(
        got, RL.attention(jq, jk, jv, causal=causal, window=window),
        atol=2e-4)


def test_plain_bf16_matches_pallas(rng):
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(rng, 1, 128, 128, 4,
                                                     2, 32))
    got = TL.attention(*(torch.from_numpy(np.asarray(x, np.float32))
                         .to(torch.bfloat16) for x in (q, k, v)),
                       causal=True)
    assert got.dtype == torch.bfloat16
    want = ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2)


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages take the query-chunked online-softmax path at these
    sizes (read at call time, as the reference reads its own)."""
    for mod in (RL, kfa):
        monkeypatch.setattr(mod, "DENSE_ATTN_ELEMS", 64 * 64)
        monkeypatch.setattr(mod, "KV_CHUNK", 64)


@pytest.mark.parametrize("s,t,h,kvh,hd", SWEEP)
@pytest.mark.parametrize("causal,window", MASKS)
def test_chunked_plain_path_matches_reference(rng, small_chunks, s, t, h,
                                              kvh, hd, causal, window):
    q, k, v = _qkv(rng, 2, s, t, h, kvh, hd)
    got = _port(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(
        got, RL.attention(jq, jk, jv, causal=causal, window=window),
        atol=2e-4)
    np.testing.assert_allclose(
        got, ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                     window=window), atol=2e-4)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48)])
def test_q_offset_matches_model_attention(rng, request, chunked, causal,
                                          window):
    """Queries at positions 40.. over 40 + 150 keys (a continued prompt)."""
    if chunked:
        request.getfixturevalue("small_chunks")
    q, _, _ = _qkv(rng, 2, 150, 150, 6, 2, 32)
    _, k, v = _qkv(rng, 2, 190, 190, 6, 2, 32)
    got = _port(q, k, v, causal=causal, window=window, q_offset=40)
    want = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, q_offset=40)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_cpu_call_never_launches(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 64, 64, 4, 2, 64))
    before = kfa.LAUNCHES
    kfa.flash_attention(q, k, v)
    TL.attention(q, k, v, window=16)
    assert kfa.LAUNCHES == before


def test_plain_flag_takes_the_plain_version(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 70, 70, 4, 2, 64))
    np.testing.assert_array_equal(
        TL.attention(q, k, v, plain=True).numpy(),
        kfa.attention_plain(q, k, v).numpy())
