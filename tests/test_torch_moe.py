"""The port's MoE FFN and the MoE and hybrid LMs against the reference, on
the CPU.

Reduced configs of ``granite-moe-3b-a800m``, ``mixtral-8x7b`` and
``jamba-v0.1-52b`` in fp32 get the reference's ``init_params``
(PRNGKey 0), carried to numpy and from there into the port with
``lm_params_from_numpy``; inputs are numpy draws from a seed.  Tolerances,
relative to the largest |value|: 1e-5 for outputs, aux losses, caches and
each gradient leaf (fp32 sums in another order: the reference
scatter-adds a token's k expert outputs, the port sums them in slot
order).  Every ``remat`` gives the gradients of ``"none"`` exactly (the
recomputation repeats the same CPU ops).

Also the parity traps of the routing (tied router probabilities, an
overflowing expert, the capacity at T = 1, 4 and 8192), the init layout at
full widths, a reference bf16 checkpoint restored into the port, and the
sliding-window ring the port repairs (decode after a prompt longer than the
window, or shorter, equals ``forward``).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import base as RC
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS as ARCHS_ALL, get_config, \
    reduced_config
from repro_torch.data.pipeline import token_iterator
from repro_torch.launch import serve, train
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.models import transformer as T
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths

ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b", "jamba-v0.1-52b"]
RTOL = 1e-5
S = 12


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _prompt_len(cfg) -> int:
    """A prompt the reference's prefill gets right: a multiple of the
    window for a windowed config."""
    return cfg.sliding_window or S


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference config, reference params, port config, port
    params, tokens (2, prompt + 3))."""
    arch = request.param
    rcfg, cfg = RC.reduced_config(arch), reduced_config(arch)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = T.lm_params_from_numpy(_host(rp), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, _prompt_len(cfg) + 3)).astype(np.int32)
    return arch, rcfg, rp, cfg, params, toks


def _moe_position(cfg) -> str:
    kinds = T.layer_kinds(cfg)
    return f"pos{next(j for j, k in enumerate(kinds) if k[1] == 'moe')}"


# ------------------------------------------------------------- the FFN


def _ffn_pair(pair, router=None):
    """moe_ffn of both packages on the same (2, S, d) input and the first
    MoE layer's weights (``router`` replaces its router)."""
    _, rcfg, rp, cfg, params, _ = pair
    pos = _moe_position(cfg)
    rparams = jax.tree.map(lambda a: a[0], rp["blocks"][pos]["moe"])
    if router is not None:
        rparams = dict(rparams, router=jnp.asarray(router))
    p = {k: torch.from_numpy(np.array(v, np.float32))
         for k, v in rparams.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want, want_aux = RM.moe_ffn(jnp.asarray(x), rparams, rcfg)
    got, aux = moe.moe_ffn(torch.from_numpy(x), p, cfg)
    return cfg, p, x, (got, aux), (want, want_aux)


def test_moe_ffn_matches_reference(pair):
    _, _, _, (got, aux), (want, want_aux) = _ffn_pair(pair)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < RTOL
    assert abs(float(aux) - float(want_aux)) < RTOL * abs(float(want_aux))


def test_tied_router_probabilities_pick_the_lower_expert(pair):
    """A zero router ties every expert: jax.lax.top_k takes the lowest
    indices, and so must the port (torch.topk promises no order)."""
    cfg = pair[3]
    zero = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    cfg, p, x, (got, aux), (want, want_aux) = _ffn_pair(pair, router=zero)
    assert _rel(got.numpy(), want) < RTOL
    assert abs(float(aux) - float(want_aux)) < RTOL * abs(float(want_aux))
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model)
                          @ p["router"], -1)
    top_w, *_ = moe._routing(probs, cfg, moe.capacity(probs.shape[0], cfg))
    torch.testing.assert_close(
        top_w, torch.full_like(top_w, 1 / cfg.experts_per_token))


def test_overflowing_expert_drops_pairs_as_the_reference_does(pair):
    """A router biased to expert 0: every token ranks it first, more pairs
    than its capacity reach it, and the overflow goes to the sink."""
    cfg = pair[3]
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 0] = 1.0
    cfg, p, x, (got, aux), (want, want_aux) = _ffn_pair(pair, router=router)
    t = 2 * S
    cap = moe.capacity(t, cfg)
    xf = torch.from_numpy(x).reshape(t, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], -1)
    _, tok_of_slot, slot_of_pair, _, counts = moe._routing(probs, cfg, cap)
    assert int(counts.max()) > cap
    dropped = int((slot_of_pair == cfg.n_experts * cap).sum())
    assert dropped == int((counts - cap).clamp(min=0).sum()) > 0
    assert _rel(got.numpy(), want) < RTOL
    assert abs(float(aux) - float(want_aux)) < RTOL * abs(float(want_aux))


@pytest.mark.parametrize("t,want", [(1, 1), (4, 1), (8192, 2048)])
def test_capacity_at_granites_prefill_and_decode(t, want):
    """granite-moe-3b-a800m (E 40, k 8, cf 1.25): the reference's own
    expression, clamped to [1, T]."""
    rcfg, cfg = RC.get_config("granite-moe-3b-a800m"), \
        get_config("granite-moe-3b-a800m")
    e, k, cf = rcfg.n_experts, rcfg.experts_per_token, rcfg.capacity_factor
    ref = max(min(int(-(-t * k * cf // e)), t), 1)
    assert moe.capacity(t, cfg) == ref == want


def test_moe_gradients_use_no_scatter_add(pair, monkeypatch):
    """The dispatch and combine backward gather: no index_add_,
    scatter_add_ or accumulating index_put_ runs."""
    cfg, p, x, _, _ = _ffn_pair(pair)
    seen = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            if "index_add" in name or "scatter_add" in name or (
                    "index_put" in name and (kwargs.get("accumulate") or (
                        len(args) > 3 and args[3]))):
                if args[0].is_floating_point():
                    seen.append(name)
            return func(*args, **kwargs)

    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in p.items()}
    with Spy():
        out, aux = moe.moe_ffn(xt, pt, cfg)
        (out.square().sum() + aux).backward()
    assert seen == []
    assert torch.isfinite(xt.grad).all()


# ------------------------------------------------------- the whole model


def test_forward_loss_and_aux_match_reference(pair):
    _, rcfg, rp, cfg, params, toks = pair
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    want, want_aux = RT.forward(rp, rcfg, {"tokens": jnp.asarray(
        batch["tokens"])}, training=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, aux = T.forward(params, cfg, tb)
    assert got.shape == (2, S, cfg.vocab_size) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < RTOL
    assert float(want_aux) > 0
    assert abs(float(aux) - float(want_aux)) < RTOL * float(want_aux)
    ref_loss, ref_m = RT.loss_fn(rp, rcfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    loss, metrics = T.loss_fn(params, cfg, tb)
    assert abs(float(loss) - float(ref_loss)) < RTOL * abs(float(ref_loss))
    for k in ("loss", "aux"):
        assert abs(float(metrics[k]) - float(ref_m[k])) \
            < RTOL * abs(float(ref_m[k])), k
    assert float(loss) == pytest.approx(
        float(metrics["loss"]) + 0.01 * float(metrics["aux"]), rel=1e-6)


def test_prefill_and_decode_match_reference(pair):
    """Prefill with room to grow (a windowed config at a multiple of its
    window, where the reference's ring is right), then three decode steps:
    logits and every cache leaf against the reference's."""
    _, rcfg, rp, cfg, params, toks = pair
    s = _prompt_len(cfg)
    ref_logits, ref_cache = RT.prefill(rp, rcfg,
                                       {"tokens": jnp.asarray(toks[:, :s])},
                                       pad_to=s + 4)
    logits, cache = T.prefill(params, cfg,
                              {"tokens": torch.from_numpy(toks[:, :s])},
                              pad_to=s + 4)

    def check(step):
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert _rel(logits.numpy(), ref_logits) < RTOL, step
        want = dict(jax.tree_util.tree_flatten_with_path(ref_cache)[0])
        got = leaves_with_paths(cache)
        assert [p for p, _ in got] == ["/".join(str(k) for k in path)
                                       for path in want], step
        for (path, leaf), ref_leaf in zip(got, want.values()):
            assert tuple(leaf.shape) == ref_leaf.shape, (step, path)
            assert str(leaf.dtype).removeprefix("torch.") \
                == str(ref_leaf.dtype), (step, path)
            if path == "['index']":
                assert int(leaf) == int(ref_leaf), step
            else:
                assert _rel(leaf.numpy(), ref_leaf) < RTOL, (step, path)

    check("prefill")
    for t in range(s, s + 3):
        ref_logits, ref_cache = RT.decode_step(
            rp, rcfg, ref_cache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        logits, cache = T.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(
                toks[:, t:t + 1])})
        check(f"decode {t}")


@pytest.fixture(scope="module")
def grads(pair):
    """``loss_fn``'s value and gradient in the reference (``jax.grad``) and
    in the port, on a batch with a loss mask."""
    _, rcfg, rp, cfg, params, toks = pair
    mask = np.ones((2, S), np.float32)
    mask[1, S // 2:] = 0
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1],
             "loss_mask": mask}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: RT.loss_fn(p, rcfg, jb)[0])(rp)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    return cfg, params, tb, (float(want_loss), want)


def _port_grads(cfg, params, tb, remat="none"):
    return value_and_grad(lambda p, b: T.loss_fn(p, cfg, b, remat=remat)[0],
                          params, tb)


def test_loss_gradients_match_jax_grad(grads):
    cfg, params, tb, (want_loss, want) = grads
    loss, got = _port_grads(cfg, params, tb)
    assert abs(float(loss) - want_loss) <= RTOL * abs(want_loss)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = leaves_with_paths(got)
    assert [p for p, _ in got] == ["/".join(str(k) for k in path)
                                   for path, _ in flat]
    for (path, g), (_, w) in zip(got, flat):
        w = np.asarray(w, np.float64)
        if not np.abs(w).max():  # padded embedding rows, a tied zero
            assert not g.abs().max(), path
            continue
        assert _rel(g.numpy(), w) <= RTOL, (path, _rel(g.numpy(), w))


@pytest.mark.parametrize("remat", ["full", "dots", "outputs"])
def test_every_remat_gives_the_loss_aux_and_gradients_of_none(grads, remat):
    cfg, params, tb, _ = grads
    loss, want = _port_grads(cfg, params, tb)
    got_loss, got = _port_grads(cfg, params, tb, remat)
    assert float(got_loss) == float(loss)
    _, m = T.loss_fn(params, cfg, tb, remat=remat)
    _, m0 = T.loss_fn(params, cfg, tb)
    assert float(m["aux"]) == float(m0["aux"]) > 0
    for (path, g), (_, w) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        assert torch.equal(g, w), path


# ------------------------------------------------------ layout and dtypes


def test_init_layout_and_dtypes_match_reference_at_full_width(monkeypatch):
    """Each arch at its full widths cut to one period of its pattern and a
    vocab of 256, in bf16: the port's ``init_params`` (on the meta device:
    shapes only) against ``jax.eval_shape`` of the reference's, leaf paths,
    shapes and dtypes (norms, router, a_log and d_skip fp32)."""
    real = torch.randn
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.empty(
        shape, dtype=kw["dtype"], device="meta"))
    for arch in ARCHS:
        rc, c = RC.get_config(arch), get_config(arch)
        period = T.pattern_period(c)
        rc, c = (dataclasses.replace(x, n_layers=period, vocab_size=256)
                 for x in (rc, c))
        want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                     rc))
        got = T.init_params(torch.Generator(), c, device="meta")
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in leaves_with_paths(got)] == [
            "/".join(str(k) for k in path) for path, _ in flat], arch
        fp32 = set()
        for (path, leaf), (_, ref_leaf) in zip(leaves_with_paths(got), flat):
            assert tuple(leaf.shape) == ref_leaf.shape, (arch, path)
            assert str(leaf.dtype).removeprefix("torch.") \
                == str(ref_leaf.dtype), (arch, path)
            if leaf.dtype == torch.float32:
                fp32.add(path.split("/")[-1])
        want_fp32 = {"['ln1']", "['ln2']", "['ln_f']", "['router']"}
        if arch == "jamba-v0.1-52b":
            want_fp32 |= {"['a_log']", "['d_skip']"}
        assert fp32 == want_fp32, arch
    monkeypatch.setattr(torch, "randn", real)
    c = reduced_config("jamba-v0.1-52b")
    got = T.init_params(torch.Generator().manual_seed(0), c)
    m = got["blocks"]["pos0"]["mamba"]
    torch.testing.assert_close(
        m["a_log"][0], torch.arange(1, c.d_state + 1).float().log().expand(
            c.expand * c.d_model, c.d_state))
    assert torch.equal(m["dt_bias"], torch.full_like(m["dt_bias"], -4.6))
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_params_keeps_the_references_fp32_leaves(arch):
    cfg = reduced_config(arch)
    p16 = T.cast_params(T.init_params(torch.Generator().manual_seed(0), cfg),
                        torch.bfloat16)
    for path, leaf in leaves_with_paths(p16):
        name = path.split("/")[-1].strip("[]'")
        want = torch.float32 if name.startswith("ln") \
            or name in T.FP32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, path


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_bf16_checkpoint_restores_into_the_port(arch, tmp_path):
    rcfg = dataclasses.replace(RC.reduced_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(arch), dtype="bfloat16")
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    RefCheckpointManager(str(tmp_path)).save(5, rp)
    template = T.init_params(torch.Generator().manual_seed(1), cfg)
    back, _ = CheckpointManager(str(tmp_path)).restore(5, template)
    flat = jax.tree_util.tree_flatten_with_path(rp)[0]
    got = leaves_with_paths(back)
    assert len(got) == len(flat)
    for (path, leaf), (_, want) in zip(got, flat):
        assert str(leaf.dtype).removeprefix("torch.") == str(want.dtype), path
        np.testing.assert_array_equal(
            leaf.float().numpy(), np.asarray(want.astype(jnp.float32)),
            err_msg=path)


@pytest.mark.parametrize("arch", RC.list_archs())
def test_every_reference_arch_is_configured_and_builds(arch):
    """Each arch the reference registers: the port's full and reduced
    configs carry the reference's value in every field the port has (all
    but the fields it does not read), granite's ``source`` excepted (Queue
    3); ``build_model`` builds both; a language model's reduced init has
    the reference's leaf paths and shapes."""
    assert arch in ARCHS_ALL
    for mine, ref in ((get_config(arch), RC.get_config(arch)),
                      (reduced_config(arch), RC.reduced_config(arch))):
        for f in dataclasses.fields(mine):
            if not (f.name == "source" and arch == "granite-moe-3b-a800m"):
                assert getattr(mine, f.name) == getattr(ref, f.name), \
                    (arch, f.name)
        assert build_model(mine).cfg == mine
    cfg = reduced_config(arch)
    model = build_model(cfg)
    if cfg.family == "jpeg_resnet":
        assert model.decode_step is None
        return
    got = model.init_params(torch.Generator().manual_seed(0), "cpu")
    want = jax.eval_shape(lambda: RT.init_params(
        jax.random.PRNGKey(0), RC.reduced_config(arch)))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(p, tuple(x.shape)) for p, x in leaves_with_paths(got)] == [
        ("/".join(str(k) for k in path), x.shape) for path, x in flat]


def test_jamba_pattern_and_granite_source():
    assert T.pattern_period(get_config("jamba-v0.1-52b")) == 8
    assert T.pattern_period(reduced_config("jamba-v0.1-52b")) == 2
    kinds = T.layer_kinds(get_config("jamba-v0.1-52b"))[:8]
    assert [m for m, _ in kinds] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in kinds] == ["dense", "moe"] * 4
    assert "granite-3.0-3b-a800m" in get_config("granite-moe-3b-a800m").source


# ------------------------------------------------ the sliding-window ring


def _windowed(dense: bool):
    """mixtral's reduced config (window 64) made dense, or kept MoE with a
    capacity of T (capacity_factor = E / k) so that neither the forward
    over B·S tokens nor a decode step over B drops a pair."""
    rcfg = RC.reduced_config("mixtral-8x7b")
    change = {"n_experts": 0} if dense else {
        "capacity_factor": rcfg.n_experts / rcfg.experts_per_token}
    rcfg = dataclasses.replace(rcfg, **change)
    cfg = dataclasses.replace(reduced_config("mixtral-8x7b"), **change)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rp, cfg, T.lm_params_from_numpy(_host(rp), device="cpu")


@pytest.fixture(scope="module", params=["dense", "moe"])
def windowed(request):
    return _windowed(request.param == "dense")


@pytest.mark.parametrize("s", [40, 64, 80, 128])
def test_decode_after_a_prompt_equals_forward_with_a_window(windowed, s):
    """Prefill s tokens (window 64), then 4 decode steps: every decoded
    position's logits equal ``forward``'s over the whole sequence.  At s
    = 80 the reference's ring evicts a key still inside the window; at s =
    40 its cache has 40 slots and the first decode step overwrites
    position 0."""
    _, _, cfg, params = windowed
    n = 4
    toks = torch.from_numpy(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s + n)).astype(np.int32))
    full, _ = T.forward(params, cfg, {"tokens": toks})
    last, cache = T.prefill(params, cfg, {"tokens": toks[:, :s]},
                            pad_to=s + n)
    assert cache["pos0"]["k"].shape[2] == min(cfg.sliding_window, s + n)
    outs = [last[:, 0]]
    for t in range(s, s + n - 1):
        lg, cache = T.decode_step(params, cfg, cache,
                                  {"tokens": toks[:, t:t + 1]})
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1).detach().numpy()
    assert _rel(got, full[:, s - 1:s + n - 1].detach().numpy()) < RTOL


@pytest.mark.parametrize("s", [64, 128])
def test_windowed_decode_equals_the_references_where_it_is_right(windowed, s):
    rcfg, rp, cfg, params = windowed
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s + 3)).astype(np.int32)
    want, rc = RT.prefill(rp, rcfg, {"tokens": jnp.asarray(toks[:, :s])})
    got, c = T.prefill(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :s])}, pad_to=s + 3)
    assert _rel(got.numpy(), want) < RTOL
    for t in range(s, s + 3):
        want, rc = RT.decode_step(rp, rcfg, rc,
                                  {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, c = T.decode_step(params, cfg, c, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])})
        assert _rel(got.numpy(), want) < RTOL, t


# ------------------------------------------------------ the entry points


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_run_each_arch(arch, tmp_path):
    """``serve --arch`` completes its requests; ``train.py --arch`` takes
    steps whose first loss is ``loss_fn``'s, aux term included, on the
    trainer's own initial parameters and first batch."""
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "5"])
    assert out["completed"] == 3 and out["decode_tokens"] > 0
    result = train.train_loop(train.parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
         "--no-resume"]))
    losses = [v for _, v in result["losses"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = reduced_config(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = train.to_model_batch(cfg, next(token_iterator(
        0, 2, 16, cfg.vocab_size)), "cpu")
    total, metrics = T.loss_fn(params, cfg, batch)
    assert float(metrics["aux"]) > 0
    assert losses[0] == pytest.approx(float(total), rel=1e-6)
