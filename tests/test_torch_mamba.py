"""The port's Mamba mixer against the reference, on the CPU.

``jamba-v0.1-52b``'s reduced config in fp32: its first Mamba layer's
parameters from the reference's ``init_params`` (PRNGKey 0), inputs drawn
from a seed with numpy.  ``_causal_conv``, ``_selective_scan`` and
``mamba_forward`` (with and without an incoming cache) are held to the
reference at 1e-5 of the largest |value| at every length the reference
runs; at S = 257, where the reference's reshape fails, the port's chunked
scan is held to its own step-by-step recurrence (``mamba_decode_step``)
at the same bound.  A prefill cache followed by decode steps equals
``forward`` over the whole sequence; there the MoE layers get a capacity
of T (capacity_factor = E / k), since a decode step routes its B tokens
with their own capacity and the forward its B·S tokens with theirs.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as RC
from repro.models import mamba as RMB
from repro.models import transformer as RT
from repro_torch.configs import reduced_config
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T

ARCH = "jamba-v0.1-52b"
RTOL = 1e-5
LENGTHS = [1, 3, 127, 128, 200, 256, 300]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def layer():
    """(reference config, reference Mamba params, port config, port
    params)."""
    rcfg, cfg = RC.reduced_config(ARCH), reduced_config(ARCH)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    pos = next(f"pos{j}" for j, k in enumerate(T.layer_kinds(cfg))
               if k[0] == "mamba")
    rm = jax.tree.map(lambda a: a[0], rp["blocks"][pos]["mamba"])
    pm = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in rm.items()}
    return rcfg, rm, cfg, pm


def _draw(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("s", LENGTHS)
def test_causal_conv_matches_reference(layer, s):
    _, rm, cfg, pm = layer
    di = cfg.expand * cfg.d_model
    x, init = _draw(s, 2, s, di), _draw(s + 1, 2, cfg.d_conv - 1, di)
    for state in (None, init):
        want = RMB._causal_conv(jnp.asarray(x), rm["conv_w"], rm["conv_b"],
                                None if state is None else jnp.asarray(state))
        got = M._causal_conv(torch.from_numpy(x), pm["conv_w"], pm["conv_b"],
                             None if state is None
                             else torch.from_numpy(state))
        assert _rel(got.numpy(), want) < RTOL


def _scan_inputs(cfg, s, seed=0):
    di, ds = cfg.expand * cfg.d_model, cfg.d_state
    delta = np.log1p(np.exp(_draw(seed, 2, s, di) - 3))  # softplus, ~0.05
    a = -np.exp(np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32),
                               (di, 1))))
    return (delta.astype(np.float32), a.astype(np.float32),
            _draw(seed + 1, 2, s, ds), _draw(seed + 2, 2, s, di),
            _draw(seed + 3, 2, s, ds), _draw(seed + 4, 2, di, ds))


@pytest.mark.parametrize("s", LENGTHS)
def test_selective_scan_matches_reference(layer, s):
    cfg = layer[2]
    args = _scan_inputs(cfg, s)
    y_want, h_want = RMB._selective_scan(*map(jnp.asarray, args))
    y, h = M._selective_scan(*map(torch.from_numpy, args))
    assert y.shape == (2, s, cfg.expand * cfg.d_model)
    assert _rel(y.numpy(), y_want) < RTOL
    assert _rel(h.numpy(), h_want) < RTOL


def test_reference_scan_fails_at_257_and_the_ports_runs(layer):
    """S = 257: the reference cuts 2 chunks of 128 and cannot reshape 257
    steps into them; the port's last chunk is ragged.  Its scan equals the
    plain recurrence h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t B_t."""
    cfg = layer[2]
    args = _scan_inputs(cfg, 257)
    with pytest.raises(TypeError, match="reshape"):
        RMB._selective_scan(*map(jnp.asarray, args))
    delta, a, b, xbar, c, h = map(torch.from_numpy, args)
    y, h_last = M._selective_scan(delta, a, b, xbar, c, h)
    ys = []
    for t in range(257):
        h = torch.exp(delta[:, t, :, None] * a) * h \
            + xbar[:, t, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    assert _rel(y.numpy(), torch.stack(ys, 1).numpy()) < RTOL
    assert _rel(h_last.numpy(), h.numpy()) < RTOL


@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_forward_matches_reference(layer, s):
    """Without a cache, and from a nonzero incoming cache (conv and SSM
    states), the cache it leaves included (the s < d_conv - 1 branch at
    s = 1)."""
    rcfg, rm, cfg, pm = layer
    x = _draw(s, 2, s, cfg.d_model)
    want, _ = RMB.mamba_forward(jnp.asarray(x), rm, rcfg)
    got, none = M.mamba_forward(torch.from_numpy(x), pm, cfg)
    assert none is None and _rel(got.numpy(), want) < RTOL
    di = cfg.expand * cfg.d_model
    conv = _draw(s + 7, 2, cfg.d_conv - 1, di)
    ssm = _draw(s + 8, 2, di, cfg.d_state) * 0.1
    want, wc = RMB.mamba_forward(jnp.asarray(x), rm, rcfg,
                                 {"conv": jnp.asarray(conv),
                                  "ssm": jnp.asarray(ssm)})
    got, c = M.mamba_forward(torch.from_numpy(x), pm, cfg,
                             {"conv": torch.from_numpy(conv),
                              "ssm": torch.from_numpy(ssm)})
    assert _rel(got.numpy(), want) < RTOL
    for n in ("conv", "ssm"):
        assert c[n].shape == wc[n].shape
        assert _rel(c[n].numpy(), wc[n]) < RTOL, n


@pytest.mark.parametrize("s", [1, 257])
def test_mamba_forward_equals_its_decode_steps(layer, s):
    """The full-sequence mixer against ``mamba_decode_step`` token by token
    from a zero cache: every output and the final states (S = 257 is a
    length the reference cannot run)."""
    _, _, cfg, pm = layer
    x = torch.from_numpy(_draw(s, 2, s, cfg.d_model))
    cache = M.init_mamba_cache(cfg, 2, torch.float32)
    got, c = M.mamba_forward(x, pm, cfg, cache)
    outs = []
    for t in range(s):
        o, cache = M.mamba_decode_step(x[:, t:t + 1], pm, cfg, cache)
        outs.append(o)
    assert _rel(got.numpy(), torch.cat(outs, 1).numpy()) < RTOL
    for n in ("conv", "ssm"):
        assert _rel(c[n].numpy(), cache[n].numpy()) < RTOL, n


def test_mamba_decode_step_matches_reference(layer):
    rcfg, rm, cfg, pm = layer
    di = cfg.expand * cfg.d_model
    x = _draw(5, 2, 1, cfg.d_model)
    conv = _draw(6, 2, cfg.d_conv - 1, di)
    ssm = _draw(7, 2, di, cfg.d_state) * 0.1
    want, wc = RMB.mamba_decode_step(jnp.asarray(x), rm, rcfg,
                                     {"conv": jnp.asarray(conv),
                                      "ssm": jnp.asarray(ssm)})
    got, c = M.mamba_decode_step(torch.from_numpy(x), pm, cfg,
                                 {"conv": torch.from_numpy(conv),
                                  "ssm": torch.from_numpy(ssm)})
    assert _rel(got.numpy(), want) < RTOL
    for n in ("conv", "ssm"):
        assert _rel(c[n].numpy(), wc[n]) < RTOL, n


def _no_drop(cfg):
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)


@pytest.mark.parametrize("s", [2, 12, 131])
def test_prefill_cache_then_decode_equals_forward(s):
    """jamba's reduced stack (Mamba and attention layers): prefill s tokens,
    then two decode steps; each step's logits equal ``forward`` over the whole
    sequence at that position.  s = 2 is shorter than d_conv - 1, s = 131
    spans two scan chunks."""
    rcfg, cfg = (_no_drop(c) for c in (RC.reduced_config(ARCH),
                                       reduced_config(ARCH)))
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = T.lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s + 3)).astype(np.int32))
    full, _ = T.forward(params, cfg, {"tokens": toks})
    last, cache = T.prefill(params, cfg, {"tokens": toks[:, :s]},
                            pad_to=s + 3)
    outs = [last[:, 0]]
    for t in range(s, s + 2):
        lg, cache = T.decode_step(params, cfg, cache,
                                  {"tokens": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1).detach().numpy()
    assert _rel(got, full[:, s - 1:s + 2].detach().numpy()) < RTOL
    assert int(cache["index"]) == s + 2


def test_decode_from_empty_cache_matches_forward():
    cfg = _no_drop(reduced_config(ARCH))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(1))
    full, _ = T.forward(params, cfg, {"tokens": toks})
    cache = T.init_cache(cfg, 2, 10)
    outs = []
    for t in range(10):
        lg, cache = T.decode_step(params, cfg, cache,
                                  {"tokens": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    assert _rel(torch.stack(outs, 1).detach().numpy(),
                full.detach().numpy()) < RTOL
