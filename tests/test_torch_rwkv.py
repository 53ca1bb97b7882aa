"""The port's RWKV-6 layers and ``rwkv6-7b`` against the reference, on the
CPU.

``rwkv6-7b``'s reduced config in fp32.  Parameters: the reference's
``init_params`` (PRNGKey 0) for the layout and scales, every leaf then
moved by a numpy draw from a seed (so the group norm's gain and bias, the
mixes and the decays are off their init values), loaded into both packages
(``lm_params_from_numpy`` for the port); inputs drawn with numpy.  Bounds:
1e-5 of the largest |value| for activations, logits and cache leaves, and
for each gradient leaf against ``jax.grad`` of the reference's
``loss_fn``.

The scan: ``_wkv_chunked`` equals the reference's at every length the
reference runs right.  Where it does not, the port is held to a float64
step-by-step recurrence written here: at S = 45 and 63 with decays at
their clamp (the reference's one chunk of S steps overflows fp32 and its
output is non-finite) and at S = 65, 100 and 257 (the reference's reshape
raises).
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as RC
from repro.models import rwkv as RRW
from repro.models import transformer as RT
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths

ARCH = "rwkv6-7b"
RTOL = 1e-5
B, S = 2, 40


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def numpy_params(rcfg, seed: int = 0) -> dict:
    """The reference's init as numpy arrays, each leaf moved by 0.1 × its
    spread (1 for a constant leaf) times a standard normal draw."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a.astype(jnp.float32))
        return (a + 0.1 * (a.std() or 1.0)
                * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree.map(move, RT.init_params(jax.random.PRNGKey(0), rcfg))


@pytest.fixture(scope="module")
def model():
    """(reference config, reference params, port config, port params,
    tokens (B, S + 4))."""
    rcfg, cfg = RC.reduced_config(ARCH), reduced_config(ARCH)
    tree = numpy_params(rcfg)
    rp = jax.tree.map(jnp.asarray, tree)
    params = T.lm_params_from_numpy(tree, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    return rcfg, rp, cfg, params, toks


def _layer(model):
    """The first layer's parameters in both packages."""
    _, rp, _, params, _ = model
    ref = jax.tree.map(lambda a: a[0], rp["blocks"]["pos0"])
    port = {k: {n: v[0] for n, v in sub.items()} if isinstance(sub, dict)
            else sub[0] for k, sub in params["blocks"]["pos0"].items()}
    return ref, port


def _draw(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("s", [1, 17, 40])
def test_time_and_channel_mix_match_reference(model, s):
    """Without a cache, and from nonzero shift and WKV states (the states
    they leave included)."""
    rcfg, _, cfg, _, _ = model
    ref, port = _layer(model)
    d, hs = cfg.d_model, cfg.rwkv_head_size
    x = _draw(s, B, s, d)
    cache = {"shift_tm": _draw(s + 1, B, 1, d),
             "shift_cm": _draw(s + 2, B, 1, d),
             "wkv": _draw(s + 3, B, d // hs, hs, hs, scale=0.1)}
    for c in (None, cache):
        jc = None if c is None else {k: jnp.asarray(v) for k, v in c.items()}
        tc = None if c is None else {k: torch.from_numpy(v)
                                     for k, v in c.items()}
        for name, rfn, pfn, p in (
                ("tm", RRW.rwkv_time_mix, RW.rwkv_time_mix, "tm"),
                ("cm", RRW.rwkv_channel_mix, RW.rwkv_channel_mix, "cm")):
            want, wc = rfn(jnp.asarray(x), ref[p], rcfg, jc)
            got, gc = pfn(torch.from_numpy(x), port[p], cfg, tc)
            assert got.shape == (B, s, d)
            assert _rel(got.numpy(), want) < RTOL, (name, c is None)
            assert (gc is None) == (wc is None)
            for k in wc or {}:
                assert _rel(gc[k].numpy(), wc[k]) < RTOL, (name, k)


def test_decode_wrappers_equal_one_step_of_the_mixes(model):
    """The single-step recurrence of decode against the reference's time
    and channel mix run on one token from the same states."""
    rcfg, _, cfg, _, _ = model
    ref, port = _layer(model)
    d, hs = cfg.d_model, cfg.rwkv_head_size
    x = _draw(7, B, 1, d)
    cache = {"shift_tm": _draw(8, B, 1, d), "shift_cm": _draw(9, B, 1, d),
             "wkv": _draw(10, B, d // hs, hs, hs, scale=0.1)}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v) for k, v in cache.items()}
    want, wc = RRW.rwkv_time_mix_decode(jnp.asarray(x), ref["tm"], rcfg, jc)
    got, gc = RW.rwkv_time_mix_decode(torch.from_numpy(x), port["tm"], cfg,
                                      tc)
    assert _rel(got.numpy(), want) < RTOL
    for k in ("shift_tm", "wkv"):
        assert _rel(gc[k].numpy(), wc[k]) < RTOL, k
    want, wc = RRW.rwkv_channel_mix_decode(jnp.asarray(x), ref["cm"], rcfg,
                                           jc)
    got, gc = RW.rwkv_channel_mix_decode(torch.from_numpy(x), port["cm"],
                                         cfg, tc)
    assert _rel(got.numpy(), want) < RTOL
    assert _rel(gc["shift_cm"].numpy(), wc["shift_cm"]) < RTOL


def _scan_inputs(s, clamped=False, seed=0):
    """r, k, v, w (B, S, H, hs), u (H, hs), s0 (B, H, hs, hs): 4 heads of
    16; decays near 0.95, or all at the clamp exp(-MAX_NEG_LOGW)."""
    h, hs = 4, 16
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, s, h, hs)).astype(np.float32)
               for _ in range(3))
    if clamped:
        w = np.full((B, s, h, hs), math.exp(-RW.MAX_NEG_LOGW), np.float32)
    else:
        w = np.exp(-np.exp(rng.standard_normal((B, s, h, hs)) - 3)).astype(
            np.float32)
    u = (rng.standard_normal((h, hs)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, h, hs, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _recurrence(r, k, v, w, u, s0):
    """S_t = diag(w_t) S_{t-1} + k_tᵀ v_t, y_t = r_t (diag(u) k_tᵀ v_t +
    S_{t-1}), step by step in float64."""
    r, k, v, w = (torch.from_numpy(x).double() for x in (r, k, v, w))
    u, st = torch.from_numpy(u).double(), torch.from_numpy(s0).double()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               u[..., None] * kv + st))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, 1).numpy(), st.numpy()


@pytest.mark.parametrize("s", [1, 17, 32, 44, 64, 128])
def test_wkv_chunked_matches_reference(s):
    args = _scan_inputs(s)
    y_want, s_want = RRW._wkv_chunked(*map(jnp.asarray, args))
    y, st = RW._wkv_chunked(*map(torch.from_numpy, args))
    assert y.shape == (B, s, 4, 16) and st.shape == (B, 4, 16, 16)
    assert _rel(y.numpy(), y_want) < RTOL
    assert _rel(st.numpy(), s_want) < RTOL


@pytest.mark.parametrize("s", [45, 63])
def test_clamped_decays_overflow_the_reference_and_not_the_port(s):
    """Decays at the clamp: the reference's single chunk of S steps puts
    exp(2·S) > fp32's range into its factorisation; the port's chunks of
    at most 32 steps stay within it and equal the recurrence."""
    args = _scan_inputs(s, clamped=True)
    y_ref, _ = RRW._wkv_chunked(*map(jnp.asarray, args))
    assert not np.isfinite(np.asarray(y_ref)).all()
    y, st = RW._wkv_chunked(*map(torch.from_numpy, args))
    y_want, s_want = _recurrence(*args)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert _rel(y.numpy(), y_want) < RTOL
    assert _rel(st.numpy(), s_want) < RTOL


@pytest.mark.parametrize("s", [65, 100, 257])
def test_reference_reshape_fails_and_the_port_runs(s):
    args = _scan_inputs(s, seed=s)
    with pytest.raises(TypeError, match="reshape"):
        RRW._wkv_chunked(*map(jnp.asarray, args))
    y, st = RW._wkv_chunked(*map(torch.from_numpy, args))
    y_want, s_want = _recurrence(*args)
    assert _rel(y.numpy(), y_want) < RTOL
    assert _rel(st.numpy(), s_want) < RTOL


@pytest.mark.parametrize("s,clamped", [(1, False), (45, True),
                                       (100, False)])
def test_plain_scan_equals_the_chunked_scan(s, clamped):
    """``_wkv_plain`` (the step recurrence, recomputed a chunk at a time in
    the backward) against ``_wkv_chunked``: outputs, final states and the
    gradients of every input within 1e-5 of the largest |value|."""
    args = [torch.from_numpy(a).requires_grad_()
            for a in _scan_inputs(s, clamped=clamped, seed=s)]
    dy = torch.from_numpy(_draw(s + 9, B, s, 4, 16))
    outs = []
    for fn in (RW._wkv_chunked, RW._wkv_plain):
        y, st = fn(*args)
        grads = torch.autograd.grad((y * dy).sum() + st.sum(), args)
        outs.append((y.detach(), st.detach()) + grads)
    for got, want in zip(outs[1], outs[0]):
        assert torch.isfinite(got).all()
        assert _rel(got.numpy(), want.numpy()) < RTOL


def test_reference_path_runs_the_plain_scan(model):
    """A ``reference`` dispatch runs RWKV's plain scan: its logits and loss
    gradients equal the default path's within 1e-5."""
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.models.registry import build_model

    _, _, cfg, params, toks = model
    tb = {"tokens": torch.from_numpy(toks[:, :S]),
          "labels": torch.from_numpy(toks[:, 1:S + 1])}
    calls = []
    real = RW._wkv_steps
    fast = build_model(cfg)
    plain = build_model(cfg, dispatch=DispatchConfig(path="reference"))
    loss, g = value_and_grad(lambda p, b: fast.loss_fn(p, b)[0], params, tb)
    try:
        RW._wkv_steps = lambda *a: calls.append(1) or real(*a)
        loss_p, g_p = value_and_grad(lambda p, b: plain.loss_fn(p, b)[0],
                                     params, tb)
    finally:
        RW._wkv_steps = real
    assert calls and abs(float(loss_p) - float(loss)) < RTOL * float(loss)
    for (path, a), (_, b) in zip(leaves_with_paths(g_p),
                                 leaves_with_paths(g)):
        assert _rel(a.numpy(), b.numpy()) < RTOL, path


def test_forward_prefill_and_decode_match_reference(model):
    """Forward logits and loss; prefill's logits and every cache leaf
    (shift_tm, wkv, shift_cm per layer, the index); three decode steps
    from that cache, logits and leaves, against the reference's."""
    rcfg, rp, cfg, params, toks = model
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _ = RT.forward(rp, rcfg, jb, training=False)
    got, _ = T.forward(params, cfg, tb)
    assert got.shape == (B, S, cfg.vocab_size)
    assert _rel(got.numpy(), want) < RTOL
    ref_loss, _ = RT.loss_fn(rp, rcfg, jb)
    loss, _ = T.loss_fn(params, cfg, tb)
    assert abs(float(loss) - float(ref_loss)) < RTOL * abs(float(ref_loss))

    ref_logits, ref_cache = RT.prefill(rp, rcfg, {"tokens": jb["tokens"]})
    logits, cache = T.prefill(params, cfg, {"tokens": tb["tokens"]})
    for step in range(4):
        assert _rel(logits.numpy(), ref_logits) < RTOL, step
        flat = jax.tree_util.tree_flatten_with_path(ref_cache)[0]
        got_leaves = leaves_with_paths(cache)
        assert [p for p, _ in got_leaves] == [
            "/".join(str(k) for k in path) for path, _ in flat]
        for (path, leaf), (_, ref_leaf) in zip(got_leaves, flat):
            assert tuple(leaf.shape) == ref_leaf.shape, (step, path)
            assert str(leaf.dtype).removeprefix("torch.") \
                == str(ref_leaf.dtype), (step, path)
            if path == "['index']":
                assert int(leaf) == int(ref_leaf) == S + step
            else:
                assert _rel(leaf.numpy(), ref_leaf) < RTOL, (step, path)
        if step == 3:
            break
        t = toks[:, S + step:S + step + 1]
        ref_logits, ref_cache = RT.decode_step(rp, rcfg, ref_cache,
                                               {"tokens": jnp.asarray(t)})
        logits, cache = T.decode_step(params, cfg, cache,
                                      {"tokens": torch.from_numpy(t)})


@pytest.mark.parametrize("s", [40, 65])
def test_decode_equals_forward(model, s):
    """A prompt of ``s`` tokens, then decode steps fed the next tokens:
    each step's logits equal ``forward``'s over the whole sequence at that
    position (65 + 3 = 68 steps: a length the reference cannot run)."""
    _, _, cfg, params, _ = model
    toks = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (B, s + 3)).astype(np.int32))
    full, _ = T.forward(params, cfg, {"tokens": toks})
    last, cache = T.prefill(params, cfg, {"tokens": toks[:, :s]})
    steps = [last]
    for t in range(s, s + 3):
        step, cache = T.decode_step(params, cfg, cache,
                                    {"tokens": toks[:, t:t + 1]})
        steps.append(step)
    got = torch.cat(steps, 1)
    assert _rel(got.numpy(), full[:, s - 1:].numpy()) < RTOL


def _port_grads(cfg, params, tb, remat="none"):
    return value_and_grad(
        lambda p, b: T.loss_fn(p, cfg, b, remat=remat)[0], params, tb)


@pytest.fixture(scope="module")
def grads(model):
    rcfg, rp, cfg, params, toks = model
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.grad(lambda p: RT.loss_fn(p, rcfg, jb)[0])(rp)
    loss, got = _port_grads(cfg, params, tb)
    return cfg, params, tb, want, loss, got


def test_loss_gradients_match_jax_grad(grads):
    _, _, _, want, loss, got = grads
    assert torch.isfinite(loss)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = leaves_with_paths(got)
    assert [p for p, _ in got_leaves] == [
        "/".join(str(k) for k in path) for path, _ in flat]
    for (path, g), (_, w) in zip(got_leaves, flat):
        assert _rel(g.numpy(), w) < RTOL, path


@pytest.mark.parametrize("remat", ["full", "dots", "outputs"])
def test_every_remat_gives_the_gradients_of_none(grads, remat):
    cfg, params, tb, _, loss, got = grads
    loss_r, got_r = _port_grads(cfg, params, tb, remat)
    assert float(loss_r) == float(loss)
    for (path, a), (_, b) in zip(leaves_with_paths(got_r),
                                 leaves_with_paths(got)):
        assert torch.equal(a, b), path


def test_scan_backward_recomputes_the_chunk_work(monkeypatch):
    """Under autograd the chunk work runs twice (the forward, then its
    recomputation in the backward); without a gradient once."""
    calls = []
    real = RW._wkv_chunks
    monkeypatch.setattr(RW, "_wkv_chunks",
                        lambda *a: calls.append(1) or real(*a))
    args = [torch.from_numpy(a) for a in _scan_inputs(70)]
    with torch.no_grad():
        RW._wkv_chunked(*args)
    assert len(calls) == 1
    args[0].requires_grad_(True)
    y, st = RW._wkv_chunked(*args)
    (y.sum() + st.sum()).backward()
    assert len(calls) == 3 and torch.isfinite(args[0].grad).all()


def test_layout_kinds_and_dtypes_match_reference(monkeypatch):
    """Every layer an ``rwkv`` mixer with its channel mix; the full
    config's layer (cut to one layer and a small vocab; on the meta
    device: shapes only) has the reference's leaf paths, shapes and
    dtypes, and a bf16 cast keeps the decays, bonus and group norm in
    fp32."""
    assert T.layer_kinds(get_config(ARCH)) == [("rwkv", "rwkv_cm")] * 32
    assert T.pattern_period(get_config(ARCH)) == 1
    c, rc = (dataclasses.replace(x, n_layers=1, vocab_size=256)
             for x in (get_config(ARCH), RC.get_config(ARCH)))
    want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rc))
    with monkeypatch.context() as m:
        for name in ("randn", "rand"):
            m.setattr(torch, name, lambda shape, **kw: torch.empty(
                shape, dtype=kw["dtype"], device="meta"))
        got = T.init_params(torch.Generator(), c, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = leaves_with_paths(got)
    assert [p for p, _ in got_leaves] == [
        "/".join(str(k) for k in path) for path, _ in flat]
    for (path, leaf), (_, ref_leaf) in zip(got_leaves, flat):
        assert tuple(leaf.shape) == ref_leaf.shape, path
        assert str(leaf.dtype).removeprefix("torch.") \
            == str(ref_leaf.dtype), path
    small = T.init_params(torch.Generator().manual_seed(0),
                          reduced_config(ARCH))
    tm = small["blocks"]["pos0"]["tm"]
    assert torch.equal(tm["decay_base"], torch.full_like(tm["decay_base"],
                                                         -6.0))
    assert float(tm["mu"].min()) >= 0 and float(tm["mu"].max()) < 1
    p16 = T.cast_params(small, torch.bfloat16)["blocks"]["pos0"]
    assert {k: p16["tm"][k].dtype for k in ("decay_base", "bonus", "ln_w",
                                            "ln_b", "key")} == {
        "decay_base": torch.float32, "bonus": torch.float32,
        "ln_w": torch.float32, "ln_b": torch.float32,
        "key": torch.bfloat16}


#: the bf16 drift gate: the port's bf16 logits may drift from its fp32
#: ones by at most this factor of the reference's drift (and at least its
#: inverse), as the card's gates hold bf16 paths (chip_smoke.BF16_FACTOR)
BF16_FACTOR = 1.5


@pytest.mark.parametrize("layers", [4, 32])
def test_bf16_drift_matches_the_reference(layers):
    """RWKV with random weights amplifies bf16 rounding with depth: at d 256
    (heads of 64, as the full config's) and 32 layers both packages'
    bf16 logits differ from their fp32 ones by about their own norm, at 4
    layers by ~8 %.  Same weights (the fp32 draw cast leaf by leaf to the
    dtypes the reference's bf16 init gives), same tokens: the port's
    relative-norm drift, on the chunked and on the plain scan, lies within
    a factor BF16_FACTOR of the reference's."""
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.models.registry import build_model

    kw = dict(n_layers=layers, d_model=256, d_ff=896, rwkv_head_size=64)
    rc32 = dataclasses.replace(RC.reduced_config(ARCH), **kw)
    rc16 = dataclasses.replace(rc32, dtype="bfloat16")
    c32 = dataclasses.replace(reduced_config(ARCH), **kw)
    c16 = dataclasses.replace(c32, dtype="bfloat16")
    tree = numpy_params(rc32)
    dtypes = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                   rc16))
    r16 = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype), tree,
                       dtypes)
    p32 = T.lm_params_from_numpy(tree, device="cpu")
    p16 = T.cast_params(p32, torch.bfloat16)
    toks = np.random.default_rng(2).integers(0, c32.vocab_size, (B, 32))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}

    def drift(got, want):
        got, want = (np.asarray(x, np.float64) for x in (got, want))
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    ref = drift(RT.forward(r16, rc16, jb, training=False)[0]
                .astype(jnp.float32),
                RT.forward(jax.tree.map(jnp.asarray, tree), rc32, jb,
                           training=False)[0])
    want = T.forward(p32, c32, tb)[0].numpy()
    port = {"chunked": T.forward(p16, c16, tb)[0].float().numpy(),
            "plain": build_model(c16, dispatch=DispatchConfig(
                path="reference")).forward(p16, tb)[0].float().numpy()}
    assert ref > (0.5 if layers == 32 else 0.01)  # the drift is there
    for name, got in port.items():
        assert np.isfinite(got).all(), name
        assert ref / BF16_FACTOR <= drift(got, want) <= BF16_FACTOR * ref, \
            (name, drift(got, want), ref)
