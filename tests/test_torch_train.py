"""The port's training path on the CPU (the kernels' plain versions) against
the reference package, at the parity size: widths (4, 8), one block per
stage, 16 px images, batch 3, every parameter drawn by numpy (non-trivial
batch norms included) and handed to both packages.

Tolerances, with their reasons:
* forward logits 1e-4 relative to the largest logit, running statistics
  1e-5: fp32 sums in another order through a dozen layers;
* the loss 1e-5 relative and each gradient tensor 1e-4 relative norm: the
  same, with ASM masks that may flip on pre-activations within rounding of
  zero;
* three optimizer steps: losses 1e-4 relative, and parameters within
  ``6·lr`` (AdamW divides by √v, so a gradient near zero moves a weight by
  up to ``lr`` whatever its sign; two steps of that, twice over);
* the trainer's own behaviour (resume, exported plan) bit for bit.
"""
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.core import batchnorm as ref_bn
from repro.core import dispatch as ref_dsp
from repro.core import jpeg as ref_jpeg
from repro.core import resnet as ref_resnet
from repro.data import image_iterator as ref_image_iterator
from repro.data import jpeg_iterator as ref_jpeg_iterator
from repro.models import registry as ref_registry
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import make_schedule as ref_make_schedule
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ModelConfig, get_config, reduced_config
from repro_torch.core import batchnorm as bnlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan as planlib
from repro_torch.core import resnet
from repro_torch.data.pipeline import image_iterator, jpeg_iterator, \
    prefetch
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.optim import clip_by_global_norm, make_optimizer, \
    make_schedule, value_and_grad
from repro_torch.tree import leaves, leaves_with_paths, tree_map

# one intra-op thread: the suite runs in parallel workers beside
# wall-clock tests of the reference package
torch.set_num_threads(1)

WIDTHS, SIZE, BATCH, CLASSES = (4, 8), 16, 3, 10
SPEC = resnet.ResNetSpec(widths=WIDTHS, num_classes=CLASSES)
REF_SPEC = ref_resnet.ResNetSpec(widths=WIDTHS, num_classes=CLASSES)
CFG = ModelConfig(name="parity", image_size=SIZE, in_channels=3,
                  widths=WIDTHS, blocks_per_stage=1, num_classes=CLASSES)
REF_CFG = RefModelConfig(name="parity", family="jpeg_resnet",
                         image_size=SIZE, in_channels=3, widths=WIDTHS,
                         blocks_per_stage=1, num_classes=CLASSES,
                         dtype="float32")


def numpy_bundle(seed=0):
    rng = np.random.default_rng(seed)
    params, state = {}, {}

    def conv(cout, cin, r):
        return (rng.normal(size=(cout, cin, r, r))
                * np.sqrt(2.0 / (cin * r * r))).astype(np.float32)

    def bn(name, c):
        params[name] = {
            "gamma": (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32),
            "beta": (0.1 * rng.normal(size=c)).astype(np.float32)}
        state[name] = {
            "mean": (0.1 * rng.normal(size=c)).astype(np.float32),
            "var": (1.0 + 0.3 * rng.uniform(size=c)).astype(np.float32)}

    params["stem"] = {"kernel": conv(WIDTHS[0], 3, 3)}
    bn("stem_bn", WIDTHS[0])
    for name, s, cin, w in resnet._stages(SPEC):
        params[name] = {"conv1": conv(w, cin, 3), "conv2": conv(w, w, 3)}
        if s != 1 or cin != w:
            params[name]["proj"] = conv(w, cin, 1)
        bn(name + "_bn1", w)
        bn(name + "_bn2", w)
    params["head"] = {"w": (rng.normal(size=(WIDTHS[-1], CLASSES))
                            / np.sqrt(WIDTHS[-1])).astype(np.float32),
                      "b": (0.1 * rng.normal(size=CLASSES)).astype(
                          np.float32)}
    return {"params": params, "bn_state": state}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)), tree)


def numpy_batch(seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(BATCH, 3, SIZE, SIZE)) * 0.5).astype(np.float32)
    coef = np.array(jnp.moveaxis(ref_jpeg.jpeg_encode(
        jnp.asarray(x), quality=50, scaled=True), 1, 3))
    labels = rng.integers(0, CLASSES, size=BATCH).astype(np.int32)
    return x, coef, labels


def _close_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("dispatch", [
    {}, {"materialize_limit": 0}, {"bands": 16}],
    ids=["materialised", "factored", "bands16"])
def test_jpeg_apply_training_matches_reference(dispatch):
    bundle = numpy_bundle()
    _, coef, _ = numpy_batch()
    want, want_state = ref_resnet.jpeg_apply(
        *_jax((bundle["params"], bundle["bn_state"])), jnp.asarray(coef),
        training=True, spec=REF_SPEC,
        dispatch=ref_dsp.DispatchConfig(path="reference", **dispatch))
    got, got_state = resnet.jpeg_apply(
        *_torch((bundle["params"], bundle["bn_state"])),
        torch.as_tensor(coef), training=True, spec=SPEC,
        dispatch=dsp.DispatchConfig(**dispatch))
    _close_rel(got.detach(), want, 1e-4)
    assert [p for p, _ in leaves_with_paths(got_state)] == \
        [p for p, _ in leaves_with_paths(dict(want_state))]
    for g, w in zip(leaves(got_state), jax.tree.leaves(want_state)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("training", [True, False])
def test_batchnorms_match_reference(training):
    rng = np.random.default_rng(4)
    c = 5
    gamma, beta, mean = (rng.normal(size=c).astype(np.float32)
                         for _ in range(3))
    var = (1 + rng.uniform(size=c)).astype(np.float32)
    coef = rng.normal(size=(2, 3, 3, c, 64)).astype(np.float32)
    x = rng.normal(size=(2, c, 6, 6)).astype(np.float32)
    rp = ref_bn.BatchNormParams(jnp.asarray(gamma), jnp.asarray(beta))
    rs = ref_bn.BatchNormState(jnp.asarray(mean), jnp.asarray(var))
    tp = bnlib.BatchNormParams(torch.as_tensor(gamma), torch.as_tensor(beta))
    ts = bnlib.BatchNormState(torch.as_tensor(mean), torch.as_tensor(var))
    for ref_fn, fn, inp in ((ref_bn.batchnorm_jpeg, bnlib.batchnorm_jpeg,
                             coef),
                            (ref_bn.batchnorm_spatial,
                             bnlib.batchnorm_spatial, x)):
        want, want_s = ref_fn(jnp.asarray(inp), rp, rs, training=training)
        got, got_s = fn(torch.as_tensor(inp), tp, ts, training=training)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        for g, w in zip(got_s, want_s):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    p0, s0 = bnlib.init_batchnorm(c)
    rp0, rs0 = ref_bn.init_batchnorm(c)
    for g, w in zip((*p0, *s0), (*rp0, *rs0)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_spatial_apply_matches_reference_and_jpeg_apply():
    """The spatial oracle against the reference's, and the paper's claim on
    the port alone: with exact ASM (φ = 14) at 64 bands the JPEG-domain
    network equals the spatial one on the decoded pixels (1e-3 relative:
    the stem's de-quantization multiplies by table entries up to ~120)."""
    bundle = numpy_bundle()
    x, coef, _ = numpy_batch()
    want, _ = ref_resnet.spatial_apply(
        *_jax((bundle["params"], bundle["bn_state"])), jnp.asarray(x),
        training=True, spec=REF_SPEC)
    tparams, tstate = _torch((bundle["params"], bundle["bn_state"]))
    got, _ = resnet.spatial_apply(tparams, tstate, torch.as_tensor(x),
                                  training=True, spec=SPEC)
    _close_rel(got, want, 1e-4)
    jpeg, _ = resnet.jpeg_apply(tparams, tstate, torch.as_tensor(coef),
                                training=True, spec=SPEC)
    _close_rel(jpeg, got, 1e-3)


def _ref_step_grads(bundle, coef, labels, limit=None):
    model = ref_registry.build_model(REF_CFG)
    batch = {"coefficients": jnp.asarray(coef),
             "labels": jnp.asarray(labels)}
    with ref_dsp.override(path="reference", materialize_limit=limit):
        return jax.value_and_grad(
            lambda b: model.loss_fn(b, batch)[0])(_jax(bundle))


@pytest.mark.parametrize("limit", [None, 0], ids=["materialised",
                                                  "factored"])
def test_training_step_gradients_match_jax(limit):
    """One step's loss and the gradient of every tensor of the bundle
    against ``jax.value_and_grad`` of the reference loss; ``bn_state``
    takes no part in the loss, so its gradient is zero in both."""
    bundle = numpy_bundle()
    _, coef, labels = numpy_batch()
    want_loss, want_grads = _ref_step_grads(bundle, coef, labels, limit)
    for remat in ("none", "full"):
        model = registry.build_model(
            CFG, remat, dispatch=dsp.DispatchConfig(materialize_limit=limit))
        loss, grads = value_and_grad(
            lambda b, bt: model.loss_fn(b, bt)[0], _torch(bundle),
            {"coefficients": torch.as_tensor(coef),
             "labels": torch.as_tensor(labels.astype(np.int64))})
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        got_l = leaves_with_paths(grads)
        want_l = jax.tree_util.tree_flatten_with_path(want_grads)[0]
        assert [p for p, _ in got_l] == \
            ["/".join(str(k) for k in p) for p, _ in want_l]
        for (path, g), (_, w) in zip(got_l, want_l):
            if path.startswith("['bn_state']"):
                assert not g.any() and not np.asarray(w).any()
            else:
                assert _rel_norm(g, w) <= 1e-4, path


def test_three_step_loop_matches_reference():
    """Three steps of value-and-grad, clipping, the warmup-cosine schedule
    read before the increment, and AdamW (which also decays ``bn_state``,
    as the reference does), from the same numpy bundle."""
    lr_peak, steps = 1e-3, 3
    ref_model = ref_registry.build_model(REF_CFG)
    ref_opt = ref_make_optimizer("adamw", weight_decay=0.1)
    ref_sched = ref_make_schedule("cosine", lr_peak, 1, steps)
    model = registry.build_model(CFG)
    opt = make_optimizer("adamw", weight_decay=0.1)
    sched = make_schedule("cosine", lr_peak, 1, steps)
    rb = _jax(numpy_bundle())
    rs = ref_opt.init(rb)
    tb = _torch(numpy_bundle())
    ts = opt.init(tb)
    for step in range(steps):
        _, coef, labels = numpy_batch(seed=10 + step)
        batch = {"coefficients": jnp.asarray(coef),
                 "labels": jnp.asarray(labels)}
        with ref_dsp.override(path="reference"):
            rloss, rg = jax.value_and_grad(
                lambda b: ref_model.loss_fn(b, batch)[0])(rb)
        rg, _ = ref_clip(rg, 1.0)
        rb, rs = ref_opt.update(rg, rs, rb, ref_sched(rs.step))
        tloss, tg = value_and_grad(
            lambda b, bt: model.loss_fn(b, bt)[0], tb,
            {"coefficients": torch.as_tensor(coef),
             "labels": torch.as_tensor(labels.astype(np.int64))})
        tg, _ = clip_by_global_norm(tg, 1.0)
        tb, ts = opt.update(tg, ts, tb, sched(ts.step))
        np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-4)
    for (path, g), w in zip(leaves_with_paths(tb), jax.tree.leaves(rb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=6 * lr_peak, err_msg=path)
    decay = np.prod([1 - float(sched(s)) * 0.1 for s in range(steps)])
    np.testing.assert_allclose(tb["bn_state"]["stem_bn"]["var"].numpy(),
                               numpy_bundle()["bn_state"]["stem_bn"]["var"]
                               * decay, rtol=1e-5)


def test_jpeg_iterator_matches_reference():
    ref_it = ref_jpeg_iterator(3, 2, SIZE, 3, CLASSES)
    it = jpeg_iterator(3, 2, SIZE, 3, CLASSES, device="cpu")
    for _ in range(2):
        want, got = next(ref_it), next(it)
        assert got["coefficients"].shape == want["coefficients"].shape
        np.testing.assert_allclose(got["coefficients"].numpy(),
                                   want["coefficients"], atol=1e-5)
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      want["labels"])
    state = it.state_dict()
    assert state == {"seed": 3, "step": 2}
    again = jpeg_iterator(0, 2, SIZE, 3, CLASSES, device="cpu")
    again.load_state_dict(state)
    assert torch.equal(next(again)["coefficients"],
                       next(it)["coefficients"])
    host = next(image_iterator(3, 2, SIZE, 3, CLASSES))
    want = next(ref_image_iterator(3, 2, SIZE, 3, CLASSES))
    np.testing.assert_array_equal(host["images"], want["images"])
    np.testing.assert_array_equal(host["labels"], want["labels"])


def test_prefetch_yields_in_order_and_joins():
    src = iter(range(7))
    assert list(prefetch(src, depth=2)) == list(range(7))
    gen = prefetch(iter(range(100)), depth=1)
    assert next(gen) == 0
    gen.close()

    def boom():
        yield 1
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        list(prefetch(boom()))


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="no-such-arch"):
        get_config("no-such-arch")


def test_dense_lm_arch_resolves():
    cfg = get_config("smollm-360m")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim) == ("dense", 32, 960, 15, 5, 64)


def _args(ckpt_dir, *extra):
    return train.parse_args(
        ["--arch", "jpeg-resnet", "--reduced", "--device", "cpu",
         "--steps", "4", "--batch", "2", "--ckpt-every", "2",
         "--log-every", "1", "--ckpt-dir", str(ckpt_dir), *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Four straight steps of the reduced config, checkpointed at 2 and 4."""
    d = tmp_path_factory.mktemp("train") / "ck"
    result = train.train_loop(_args(d, "--metrics-out",
                                    str(d.parent / "m.json")))
    _, final, _ = CheckpointManager(str(d)).restore_tree(4)
    return d, result, final


def test_train_loop_runs_and_checkpoints(trained):
    d, result, final = trained
    assert result["steps_run"] == 4 and result["final_step"] == 4
    assert len(result["step_s"]) == len(result["data_s"]) == 4
    assert all(np.isfinite(v) for _, v in result["losses"])
    assert CheckpointManager(str(d)).steps() == [2, 4]
    assert (d.parent / "m.json").exists()


@pytest.mark.parametrize("damage", ["deleted", "corrupt"])
def test_resume_equals_straight_run_bit_for_bit(trained, tmp_path, damage,
                                                capsys):
    """Two steps plus a resume for two give the four-step result exactly,
    whether the newest checkpoint is gone or corrupt (then skipped)."""
    d, _, final = trained
    d2 = tmp_path / "ck"
    shutil.copytree(d, d2)
    shutil.rmtree(d2 / "plan")
    if damage == "deleted":
        shutil.rmtree(d2 / "step_4")
    else:
        npz = d2 / "step_4" / "arrays.npz"
        raw = bytearray(npz.read_bytes())
        raw[len(raw) // 3] ^= 0x5A
        npz.write_bytes(bytes(raw))
    result = train.train_loop(_args(d2, "--no-export-plan"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert result["steps_run"] == 2 and result["plan_dir"] is None
    _, again, _ = CheckpointManager(str(d2)).restore_tree(4)
    assert set(again) == set(final)
    for path, arr in final.items():
        np.testing.assert_array_equal(again[path], arr, err_msg=path)


def test_exported_plan_reloads_with_identical_logits(trained):
    d, result, final = trained
    assert result["plan_dir"] == str(d / "plan")
    cfg = reduced_config("jpeg-resnet")
    bundle = registry.build_model(cfg).init_params(
        torch.Generator().manual_seed(0), "cpu")
    _, tree, _ = CheckpointManager(str(d)).restore_latest(
        {"params": bundle, "opt": make_optimizer("adamw").init(bundle)})
    spec = registry.jpeg_resnet_spec(cfg)
    plan = planlib.build_plan(tree["params"]["params"],
                              tree["params"]["bn_state"], spec)
    loaded = planlib.load_plan(str(d / "plan"), device="cpu")
    compiled = planlib.load_compiled_plan(str(d / "plan" / "compiled"),
                                          device="cpu")
    coef = next(jpeg_iterator(9, 2, 32, device="cpu"))["coefficients"]
    with torch.no_grad():
        want = planlib.apply_plan(plan, coef)
        assert torch.equal(planlib.apply_plan(loaded, coef), want)
        assert torch.equal(planlib.apply_compiled(compiled, coef),
                           planlib.apply_compiled(
                               planlib.compile_plan(plan), coef))
        assert torch.isfinite(want).all() and want.shape == (2, 10)
