"""The port's dense-LM training against the reference, on the CPU.

Reduced configs in fp32, every parameter drawn by the reference
(``init_params`` at PRNGKey 0) and carried to the port through numpy, the
same token batches in both packages.  Tolerances, with their reasons:

* token batches bit for bit (the same numpy draws);
* ``loss_fn``'s value 1e-5 relative and each parameter's gradient 1e-4 of
  its largest |entry| (fp32 sums in another order through two layers;
  measured below 1e-5);
* every ``remat`` value gives the gradients of ``"none"`` exactly: the
  recomputation repeats the same CPU ops;
* three ``train_loop`` steps: losses 1e-4 relative (AdamW divides by √v,
  so rounding-level gradient differences move a weight by up to ``lr``);
* a resume repeats a straight run bit for bit, and a checkpoint the
  reference's trainer wrote resumes in the port to the reference's own
  next loss within 1e-5 relative (the same state, one forward).
"""
import os
import shutil
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as RC
from repro.data import synthetic as ref_synthetic
from repro.data import token_iterator as ref_token_iterator
from repro.launch import train as ref_train
from repro.models import registry as RR
from repro.models import transformer as RT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.data import synthetic
from repro_torch.data.pipeline import token_iterator
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer, value_and_grad
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

ARCHS = ["smollm-360m", "granite-3-2b", "starcoder2-3b"]
LOSS_RTOL, GRAD_RTOL, STEP_RTOL = 1e-5, 1e-4, 1e-4
SEQ, BATCH = 32, 4


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("seed,index,batch,seq,vocab", [
    (0, 0, 4, 32, 512), (3, 17, 2, 65, 49152), (1, 2, 1, 1, 5)])
def test_token_batches_match_reference_bit_for_bit(seed, index, batch, seq,
                                                   vocab):
    want = ref_synthetic.token_batch(seed, index, batch, seq, vocab)
    got = synthetic.token_batch(seed, index, batch, seq, vocab)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert synthetic.unigram_entropy(vocab) \
        == ref_synthetic.unigram_entropy(vocab)


def test_token_iterator_matches_reference_and_round_trips():
    ref, it = ref_token_iterator(5, 3, 40, 512), token_iterator(5, 3, 40, 512)
    for _ in range(3):
        want, got = next(ref), next(it)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].shape == (3, 40)
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
    state = it.state_dict()
    assert state == ref.state_dict() == {"seed": 5, "step": 3}
    again = token_iterator(0, 3, 40, 512)
    again.load_state_dict(state)
    np.testing.assert_array_equal(next(again)["tokens"],
                                  next(it)["tokens"])


# --------------------------------------------------------- loss gradients


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """(arch, reference config, reference params, port config, port
    params, a numpy batch with a loss mask)."""
    arch = request.param
    rcfg, cfg = RC.reduced_config(arch), reduced_config(arch)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = T.lm_params_from_numpy(_host(rp), device="cpu")
    toks = synthetic.token_batch(2, 0, 2, 24, cfg.vocab_size)["tokens"]
    mask = np.ones((2, 24), np.float32)
    mask[1, 16:] = 0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": mask}
    return arch, rcfg, rp, cfg, params, batch


def _port_value_and_grad(params, cfg, batch, remat="none"):
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    return value_and_grad(lambda p, b: T.loss_fn(p, cfg, b, remat=remat)[0],
                          params, tb)


def test_loss_and_gradients_match_jax_value_and_grad(lm):
    _, rcfg, rp, cfg, params, batch = lm
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: RT.loss_fn(p, rcfg, jb)[0])(rp)
    loss, grads = _port_value_and_grad(params, cfg, batch)
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_RTOL * abs(float(want_loss))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = leaves_with_paths(grads)
    assert [p for p, _ in got] == ["/".join(str(k) for k in path)
                                   for path, _ in flat]
    for (path, g), (_, w) in zip(got, flat):
        w = np.asarray(w, np.float64)
        err = float(np.abs(g.double().numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), (path, err)


@pytest.mark.parametrize("remat", ["full", "dots", "outputs"])
def test_every_remat_gives_the_gradients_of_none(lm, remat):
    _, _, _, cfg, params, batch = lm
    loss, want = _port_value_and_grad(params, cfg, batch)
    got_loss, got = _port_value_and_grad(params, cfg, batch, remat)
    assert float(got_loss) == float(loss)
    for (path, g), (_, w) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        assert torch.equal(g, w), path


def test_registry_passes_remat_and_refuses_unknown_values(lm):
    _, _, _, cfg, params, batch = lm
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    for remat in T.REMAT:
        loss, _ = registry.build_model(cfg, remat=remat).loss_fn(params, tb)
        assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="remat"):
        registry.build_model(cfg, remat="everything")


# ---------------------------------------------------------------- trainer


def _args(ckpt_dir, steps=3, *extra):
    return train.parse_args(
        ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
         "--steps", str(steps), "--batch", str(BATCH), "--seq", str(SEQ),
         "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir",
         str(ckpt_dir), *extra])


@pytest.fixture
def reference_init(monkeypatch):
    """The port's trainer starting from the reference trainer's initial
    parameters (``init_params(PRNGKey(seed))``), carried through numpy."""
    real = train.build_model

    def build(cfg, *a, **kw):
        model = real(cfg, *a, **kw)
        rp = RR.build_model(RC.reduced_config("smollm-360m")).init_params(
            jax.random.PRNGKey(0))
        return model._replace(init_params=lambda gen, dev: (
            T.lm_params_from_numpy(_host(rp), device=dev)))

    monkeypatch.setattr(train, "build_model", build)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference trainer: three straight steps."""
    d = tmp_path_factory.mktemp("ref_lm") / "ck"
    return ref_train.train_loop(_args(d, 3, "--no-resume"))


def _losses(result):
    return [v for _, v in result["losses"]]


def test_three_steps_match_the_reference_trainer(reference_init,
                                                 reference_run, tmp_path):
    got = train.train_loop(_args(tmp_path / "ck", 3, "--metrics-out",
                                 str(tmp_path / "m.json")))
    want = _losses(reference_run)
    assert len(_losses(got)) == len(want) == 3
    np.testing.assert_allclose(_losses(got), want, rtol=STEP_RTOL, atol=0)
    assert set(reference_run) <= set(got)
    assert got["plan_dir"] is None and got["steps_run"] == 3
    assert CheckpointManager(str(tmp_path / "ck")).steps() == [2, 3]
    assert (tmp_path / "m.json").exists()


def test_resume_repeats_a_straight_run_bit_for_bit(tmp_path, capsys):
    d = tmp_path / "ck"
    straight = train.train_loop(_args(d, 3))
    _, final, _ = CheckpointManager(str(d)).restore_tree(3)
    shutil.rmtree(d / "step_3")
    resumed = train.train_loop(_args(d, 3))
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["steps_run"] == 1
    assert _losses(resumed) == _losses(straight)[2:]
    _, again, _ = CheckpointManager(str(d)).restore_tree(3)
    assert set(again) == set(final)
    for path, arr in final.items():
        np.testing.assert_array_equal(again[path], arr, err_msg=path)


def test_sigterm_checkpoints_and_exits_zero(tmp_path, monkeypatch, capsys):
    real = train.build_iterator

    def build(*a, **kw):
        it = real(*a, **kw)
        fn = it.fn

        def fetch(s, i):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return fn(s, i)

        it.fn = fetch
        return it

    monkeypatch.setattr(train, "build_iterator", build)
    d = tmp_path / "ck"
    with pytest.raises(SystemExit) as stop:
        train.train_loop(_args(d, 50, "--ckpt-every", "100"))
    assert stop.value.code == 0
    assert "checkpoint-and-exit" in capsys.readouterr().out
    mgr = CheckpointManager(str(d))
    assert mgr.steps() == [1]
    _, _, extra = mgr.restore_tree(1)
    assert extra["data_state"] == {"seed": 0, "step": 2}


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """The reference trainer writes ``{"params", "opt"}`` and the data
    state at step 2; the port restores every leaf (AdamW's ``m``, ``v``,
    ``master`` and its step among them) and takes step 2 to the loss the
    reference's own resume takes it to."""
    d = tmp_path / "ck"
    ref_train.train_loop(_args(d, 2, "--no-resume"))
    shutil.copytree(d, tmp_path / "ref_ck")
    want = ref_train.train_loop(_args(tmp_path / "ref_ck", 3))
    capsys.readouterr()
    got = train.train_loop(_args(d, 3))
    assert "resumed from step 2" in capsys.readouterr().out
    assert got["steps_run"] == 1 and want["steps_run"] == 1
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=LOSS_RTOL,
                               atol=0)
    cfg = reduced_config("smollm-360m")
    model = registry.build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    template = {"params": params, "opt": make_optimizer("adamw").init(params)}
    back, _ = CheckpointManager(str(tmp_path / "ref_ck")).restore(2, template)
    _, arrays, _ = CheckpointManager(str(tmp_path / "ref_ck")).restore_tree(2)
    assert int(back["opt"].step) == 2
    assert {p for p, _ in leaves_with_paths(back)} == set(arrays)
    for path, leaf in leaves_with_paths(back):
        np.testing.assert_array_equal(leaf.numpy(), arrays[path],
                                      err_msg=path)
