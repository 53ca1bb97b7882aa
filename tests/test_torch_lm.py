"""The port's dense language models against the reference, on the CPU.

Each dense arch's reduced config (fp32) gets the reference's
``init_params`` (PRNGKey 0), carried to numpy and from there into the port
with ``lm_params_from_numpy``; both packages then run the same tokens:
forward logits and loss, prefill logits and every cache leaf, and decode
steps continuing from the prefill cache, at 1e-5 of the largest |value|;
decode from ``init_cache`` against forward at 3e-4 (the reference's own
bound in ``test_models_smoke.py``).  Also: padded vocab rows never reach
the logits, the server reports what the reference's does, and bf16 trees
survive the port's checkpoints (and the reference's) bit for bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import base as RC
from repro.launch import serve as ref_serve
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import resnet
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths

DENSE = ["smollm-360m", "granite-3-2b", "starcoder2-3b", "mistral-nemo-12b"]
RTOL = 1e-5
S = 12


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(arch, reference config, reference params, port config, port
    params, tokens (2, S + 3))."""
    arch = request.param
    rcfg, cfg = RC.reduced_config(arch), reduced_config(arch)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = T.lm_params_from_numpy(_host(rp), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S + 3)).astype(np.int32)
    return arch, rcfg, rp, cfg, params, toks


def test_forward_and_loss_match_reference(pair):
    _, rcfg, rp, cfg, params, toks = pair
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    want, _ = RT.forward(rp, rcfg, {"tokens": jnp.asarray(batch["tokens"])},
                         training=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, aux = T.forward(params, cfg, tb)
    assert got.shape == (2, S, cfg.vocab_size) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < RTOL
    ref_loss, ref_m = RT.loss_fn(rp, rcfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    loss, metrics = T.loss_fn(params, cfg, tb)
    assert abs(float(loss) - float(ref_loss)) < RTOL * abs(float(ref_loss))
    assert abs(float(metrics["loss"]) - float(ref_m["loss"])) \
        < RTOL * abs(float(ref_m["loss"]))
    mask = np.ones((2, S), np.float32)
    mask[:, S // 2:] = 0
    ref_masked, _ = RT.loss_fn(rp, rcfg, {"tokens": jnp.asarray(toks[:, :S]),
                                          "labels": jnp.asarray(
                                              toks[:, 1:S + 1]),
                                          "loss_mask": jnp.asarray(mask)})
    masked, _ = T.loss_fn(params, cfg, dict(tb, loss_mask=torch.from_numpy(
        mask)))
    assert abs(float(masked) - float(ref_masked)) \
        < RTOL * abs(float(ref_masked))


def test_prefill_and_decode_match_reference(pair):
    """Prefill with room to grow, then three decode steps from its cache:
    logits and every cache leaf against the reference's."""
    _, rcfg, rp, cfg, params, toks = pair
    ref_logits, ref_cache = RT.prefill(rp, rcfg,
                                       {"tokens": jnp.asarray(toks[:, :S])},
                                       pad_to=S + 4)
    logits, cache = T.prefill(params, cfg,
                              {"tokens": torch.from_numpy(toks[:, :S])},
                              pad_to=S + 4)

    def check(step):
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert _rel(logits.numpy(), ref_logits) < RTOL, step
        want = dict(jax.tree_util.tree_flatten_with_path(ref_cache)[0])
        got = leaves_with_paths(cache)
        assert [p for p, _ in got] == ["/".join(str(k) for k in path)
                                       for path in want], step
        for (path, leaf), ref_leaf in zip(got, want.values()):
            assert tuple(leaf.shape) == ref_leaf.shape, (step, path)
            if path == "['index']":
                assert int(leaf) == int(ref_leaf), step
            else:
                assert _rel(leaf.numpy(), ref_leaf) < RTOL, (step, path)

    check("prefill")
    for t in range(S, S + 3):
        ref_logits, ref_cache = RT.decode_step(
            rp, rcfg, ref_cache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        logits, cache = T.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(
                toks[:, t:t + 1])})
        check(f"decode {t}")


def test_decode_from_empty_cache_matches_forward(pair):
    _, _, _, cfg, params, toks = pair
    full, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :10])})
    model = registry.build_model(cfg)
    cache = model.init_cache(2, 10)
    outs = []
    for t in range(10):
        lg, cache = model.decode_step(params, cache, {
            "tokens": torch.from_numpy(toks[:, t:t + 1])})
        outs.append(lg[:, 0])
    assert _rel(torch.stack(outs, 1).numpy(), full.numpy()) < 3e-4
    assert int(cache["index"]) == 10


def test_padded_vocab_rows_never_reach_logits(pair):
    _, _, _, cfg, params, toks = pair
    cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size - 12)
    assert T.padded_vocab(cfg) > cfg.vocab_size
    toks = torch.from_numpy(toks % cfg.vocab_size)
    want, _ = T.forward(params, cfg, {"tokens": toks})
    poisoned = dict(params, embed=params["embed"].clone())
    poisoned["embed"][cfg.vocab_size:] = float("nan")
    if "head" in params:
        poisoned["head"] = params["head"].clone()
        poisoned["head"][:, cfg.vocab_size:] = float("nan")
    got, _ = T.forward(poisoned, cfg, {"tokens": toks})
    assert got.shape[-1] == cfg.vocab_size
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    last, cache = T.prefill(poisoned, cfg, {"tokens": toks[:, :S]})
    assert torch.isfinite(last).all()
    step, _ = T.decode_step(poisoned, cfg, cache, {"tokens": toks[:, S:S + 1]})
    assert torch.isfinite(step).all() and step.shape[-1] == cfg.vocab_size


def test_init_params_layout_matches_reference(pair):
    """The port's own init: same leaf paths, shapes and dtypes as the
    reference's (the reduced config, and smollm-360m's full widths and
    bf16 cut to one layer and a small vocab), norms ones, projections at
    fan_in^-0.5."""
    arch, rcfg, rp, cfg, _, _ = pair
    cases = [(cfg, rcfg)]
    if arch == "smollm-360m":
        cases.append(tuple(dataclasses.replace(c, n_layers=1, vocab_size=256)
                           for c in (get_config(arch), RC.get_config(arch))))
    for c, rc in cases:
        want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                     rc))
        got = T.init_params(torch.Generator().manual_seed(0), c)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in leaves_with_paths(got)] == [
            "/".join(str(k) for k in path) for path, _ in flat]
        for (path, leaf), (_, ref_leaf) in zip(leaves_with_paths(got), flat):
            assert tuple(leaf.shape) == ref_leaf.shape, path
            assert str(leaf.dtype).removeprefix("torch.") \
                == str(ref_leaf.dtype), path
    got = T.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(got["ln_f"], torch.ones(cfg.d_model))
    q = got["blocks"]["pos0"]["attn"]["q_proj"]
    assert abs(float(q.std()) * cfg.d_model ** 0.5 - 1) < 0.1


def test_input_specs_match_reference():
    for arch in DENSE + ["jpeg-resnet"]:
        rcfg, cfg = RC.reduced_config(arch), reduced_config(arch)
        for kind in ("train", "prefill", "decode"):
            want = RR.input_specs(rcfg, RC.ShapeConfig("x", 24, 3, kind),
                                  dryrun=False)
            got = registry.input_specs(cfg, 3, 24, kind)
            assert sorted(got) == sorted(want), (arch, kind)
            for k in got:
                assert got[k].shape == want[k].shape, (arch, kind, k)
                assert got[k].dtype == want[k].dtype, (arch, kind, k)


def test_model_bundle_families():
    lm = registry.build_model(reduced_config("smollm-360m"))
    assert lm.prefill is not None and lm.decode_step is not None \
        and lm.init_cache is not None
    jr = registry.build_model(reduced_config("jpeg-resnet"))
    assert jr.prefill is None and jr.decode_step is None \
        and jr.init_cache is None
    # remat="full" builds and differentiates (the gradients themselves are
    # held against "none" and the reference in test_torch_lm_train.py)
    cfg = reduced_config("smollm-360m")
    full = registry.build_model(cfg, remat="full")
    params = full.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    loss, grads = value_and_grad(
        lambda p, b: full.loss_fn(p, b)[0], params,
        {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for _, g in leaves_with_paths(grads))
    assert float(grads["blocks"]["pos0"]["attn"]["q_proj"].abs().sum()) > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "starcoder2-3b"])
def test_serve_lm_reports_what_the_reference_reports(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--batch", "3", "--requests", "7",
            "--max-new", "9", "--seed", "3", "--ctx", "64"]
    got = serve.serve_lm(serve.parse_args(argv + ["--device", "cpu"]))
    ref_args = dict(vars(serve.parse_args(argv)), device=None)
    want = ref_serve.serve_lm(type("Args", (), ref_args))
    assert sorted(got) == sorted(want)
    assert got["decode_tokens"] == want["decode_tokens"]
    assert got["completed"] == want["completed"] == 7
    assert got["arch"] == want["arch"]
    assert '"decode_tokens"' in capsys.readouterr().out


def test_serve_main_branches_on_arch(capsys):
    out = serve.main(["--arch", "granite-3-2b", "--reduced", "--device",
                      "cpu", "--requests", "2", "--max-new", "4"])
    assert out["completed"] == 2 and out["decode_tokens"] > 0


def _bf16_tree(arch="smollm-360m"):
    rcfg = dataclasses.replace(RC.reduced_config(arch), dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(arch), dtype="bfloat16")
    return rcfg, cfg, RT.init_params(jax.random.PRNGKey(0), rcfg)


@pytest.mark.parametrize("load", [
    lambda device: T.lm_params_from_numpy({"ln_f": np.ones(4)},
                                          device=device),
    lambda device: resnet.params_from_numpy({"w": np.ones(4)}, {},
                                            device=device),
], ids=["lm_params_from_numpy", "params_from_numpy"])
def test_params_from_numpy_default_to_cuda(load, monkeypatch):
    """Both loaders resolve a missing device to CUDA, as every entry point
    does: without CUDA they raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load("cuda")
    out = load("cpu")
    leaf = out["ln_f"] if isinstance(out, dict) else out[0]["w"]
    assert leaf.device.type == "cpu" and leaf.dtype == torch.float32


def test_bf16_tree_round_trips_bit_identically(tmp_path):
    _, cfg, rp = _bf16_tree()
    params = T.lm_params_from_numpy(_host(rp), device="cpu",
                                    dtype=torch.bfloat16)
    assert params["embed"].dtype == torch.bfloat16
    assert params["ln_f"].dtype == torch.float32
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params, extra={"arch": cfg.name})
    template = T.init_params(torch.Generator().manual_seed(1), cfg)
    back, extra = mgr.restore(3, template)
    assert extra == {"arch": cfg.name}
    for (path, a), (_, b) in zip(leaves_with_paths(params),
                                 leaves_with_paths(back)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), path
    step, arrays, _ = mgr.restore_tree()
    assert step == 3
    emb = arrays["['embed']"]
    assert emb.dtype == np.float32
    np.testing.assert_array_equal(emb, params["embed"].float().numpy())


def test_reference_bf16_checkpoint_restores_into_the_port(tmp_path):
    _, cfg, rp = _bf16_tree()
    RefCheckpointManager(str(tmp_path)).save(5, rp)
    template = T.init_params(torch.Generator().manual_seed(1), cfg)
    back, _ = CheckpointManager(str(tmp_path)).restore(5, template)
    flat = jax.tree_util.tree_flatten_with_path(rp)[0]
    for (path, got), (_, want) in zip(leaves_with_paths(back), flat):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            err_msg=path)
