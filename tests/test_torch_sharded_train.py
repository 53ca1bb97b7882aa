"""The port's training step on a 2×2 (data × model) mesh against the
reference's own 2×2 run, on the CPU.

The reference runs in one subprocess with four forced host devices
(``launch.steps.build_train_step`` on ``make_test_mesh(2, 2)``); the port
runs the same step on four gloo ranks spawned by
``launch.mesh.run_local``.  Both start from the same numpy-drawn
parameters and feed the same batches: reduced ``smollm-360m`` (15/5-style
uneven heads: 3 over 1, so attention is gathered and the FFN Megatron),
reduced ``granite-moe-3b-a800m`` (4/2 heads, the Megatron attention, the
expert-parallel MoE with ZeRO-3 experts, capacity drops on each shard),
reduced ``jamba-v0.1-52b`` (``d_inner`` 128 and the RWKV heads below cut
over ``model``: each rank runs its slice of a Mamba layer, its product of
``in_proj`` moved by an all-to-all, beside the Megatron attention and the
MoE), reduced ``rwkv6-7b`` (4 heads of 16 and d_ff 128: each rank runs
two heads of the time mix and 64 columns of the channel mix), reduced
``whisper-small`` (4/4 heads: the Megatron split of the encoder's and
decoder's self-attention, of the cross-attention and of the gelu MLP;
the embedding and head cut by vocab; frames drawn normal) and
``jpeg-resnet`` at the parity size of ``tests/test_torch_train.py``
(widths (4, 8), 16 px; the reduced config's three stages take ~80 s on
four CPU ranks), batch norm statistics over every rank's rows.  Global
batch 8, ``grad_accum`` 2, ZeRO-1, AdamW at a constant 1e-3, three steps,
compression ``none`` and ``bf16``.  The dense model's step is the global
batch's whatever the cut, so three more layouts of it are held against
the reference's data × model run at the ``none`` tolerances: ZeRO-1 off,
a 2 (pod) × 2 (data) mesh on the multi-pod rules, and that mesh with 4
microbatches of 2 rows (fewer rows than its 4 batch ranks, as in
``jamba-v0.1-52b``'s 2×16×16 training cell: each rank holds the 2 rows
the reference's input sharding gives it, one microbatch, and runs them
a row at a time).  A fifth run of it carries a ``loss_mask`` whose
count differs between the data ranks of a microbatch, held against the
reference's masked 2×2 run at the same tolerances: the loss is the
masked mean over the global microbatch, not the mean of the ranks' own
masked means; a sixth, the same masked batches in 4 microbatches on the
2 (pod) × 2 mesh, against the reference's masked run of 4 microbatches.
The MoE's step depends on its layout (each shard's capacity, the aux
loss's statistics), so its run of 4 microbatches on the 2 (pod) × 2 mesh
is held against the reference's own run on that mesh: the reference
routes each microbatch's pod shard (one row, replicated over ``data``)
and sums the aux loss's counts over the microbatch; the port's rank runs
its two rows one at a time, after a pass that counts the routed pairs
per microbatch.

AdamW's ``eps`` is 1e-3 in both runs.  At the default 1e-8 the update
m/√v is the gradient's sign where a gradient is near zero, so a
rounding-level difference there moves the weight by up to ``lr``
whatever either package does (the losses still agreed within 1e-5 at
1e-8; three leaves of ``smollm-360m`` did not, at 2e-5 to 8e-5 of their
largest weight).

Tolerances, with their reasons:

* ``none``: each step's loss within 1e-5 relative, and every parameter
  leaf after 3 steps within 1e-5 of its largest |value| (measured below
  2e-7): the two meshes sum the same fp32 terms in other orders;
* ``bf16``: the port casts each microbatch's gradient to bf16 before the
  data reduction (the reference reduces in fp32 and casts after
  clipping), so each rank's partial and their sum are rounded: a
  relative error up to ε = 2·2^-8 of a reduced gradient, against the
  reference's one rounding.  For the first three steps AdamW's update
  m̂/(√v̂ + eps) is bounded by 1.001 (its bias-corrected weights) and moves
  by at most 2ε of its size for such an error, so over 3 updates at
  ``lr`` a weight moves by at most 3·lr·2ε = 4.7e-5: the bound on each
  leaf's mean |difference|.  Where the ranks' partials cancel, the
  rounding can flip a small gradient's sign; the bounded update then
  bounds any single weight by 3·2·lr = 6e-3.  Each loss reads the
  parameters of the steps before: 1e-4 relative (measured below 2e-6).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "jamba-v0.1-52b",
         "rwkv6-7b", "whisper-small", "jpeg-resnet")
COMPRESSION = ("none", "bf16")
#: the dense model's step on two more layouts (``_rank_runs``)
LAYOUTS = ("no-zero1", "pod-data", "micro-replicated")
#: the dense model's run with a loss mask, against the reference's own
MASKED = "masked"
#: the masked run with 4 microbatches of 2 rows, against the reference's
#: own; the port's on the 2 (pod) × 2 mesh, where a rank holds one
#: microbatch and runs it a row at a time
MASKED_SPREAD = "masked-spread"
#: the MoE's run with 4 microbatches of 2 rows on the 2 (pod) × 2 mesh in
#: both packages
MOE_SPREAD = "moe-spread"
MOE = "granite-moe-3b-a800m"
B, S, STEPS, ACCUM, LR, EPS = 8, 16, 3, 2, 1e-3, 1e-3
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-5
BF16_MEAN_ATOL = STEPS * LR * 2 * (2 * 2 ** -8)
BF16_MAX_ATOL, BF16_LOSS_RTOL = STEPS * 2 * LR, 1e-4
JPEG = dict(name="parity", family="jpeg_resnet", image_size=16,
            in_channels=3, widths=(4, 8), blocks_per_stage=1,
            num_classes=10, dtype="float32")


def draw(paths_shapes, seed: int = 0) -> list[np.ndarray]:
    """Parameters in leaf order, by name: norms and batch-norm scales
    near 1, shifts and biases small, convs and projections by fan-in."""
    rng = np.random.default_rng(seed)
    out = []
    for path, shape in paths_shapes:
        name = path.split("/")[-1]
        if name.startswith("ln") or name in ("gamma", "var"):
            a = 1.0 + 0.2 * rng.standard_normal(shape)
            if name == "var":
                a = np.abs(a)
        elif name in ("beta", "mean", "b") or len(shape) <= 1:
            a = 0.1 * rng.standard_normal(shape)
        elif name == "kernel" or len(shape) == 4 and "moe" not in path:
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        else:
            fan = shape[-1] if name == "embed" else shape[-2]
            a = rng.standard_normal(shape) * fan ** -0.5
        out.append(a.astype(np.float32))
    return out


def batches(cfg, seed: int = 1, masked: bool = False) -> list[dict]:
    """STEPS global batches; ``masked``: with a ``loss_mask`` that keeps
    each row's tokens at a rate of its own (0.1 to 0.9); the audio
    family's with ``frames`` (B, encoder_context_len, D)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        if cfg.family == "jpeg_resnet":
            n = cfg.image_size // 8
            out.append({"coefficients": rng.standard_normal(
                (B, n, n, cfg.in_channels, 64)).astype(np.float32),
                "labels": rng.integers(0, cfg.num_classes, B).astype(
                    np.int32)})
        else:
            t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
            out.append({"tokens": t[:, :S], "labels": t[:, 1:]})
            if cfg.family == "audio":
                out[-1]["frames"] = rng.standard_normal(
                    (B, cfg.encoder_context_len, cfg.d_model)).astype(
                        np.float32)
            if masked:
                keep = rng.uniform(0.1, 0.9, (B, 1))
                out[-1]["loss_mask"] = (rng.uniform(size=(B, S)) < keep
                                        ).astype(np.float32)
    return out


# ------------------------------------------------------------- the oracle


def oracle(out_path: str) -> None:
    """The reference's 2×2 runs → ``out_path`` (npz): per arch and
    compression the losses and every parameter after 3 steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import (MeshConfig, ModelConfig, RunConfig,
                                    ShapeConfig, TrainConfig,
                                    reduced_config)
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import build_train_step, path_str
    from repro.models.registry import build_model
    from repro.parallel.sharding import AxisRules, sharding_rules

    from jax.sharding import AxisType, Mesh

    grid = (make_test_mesh(2, 2), MeshConfig(data=2, model=2))
    pods = (Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1),
                 ("pod", "data", "model"),
                 axis_types=(AxisType.Auto,) * 3),
            MeshConfig(multi_pod=True, pods=2, data=2, model=1))
    runs = [(f"{arch}/{comp}", arch, comp, False, grid) for arch in ARCHS
            for comp in COMPRESSION]
    runs.append((f"smollm-360m/none/{MASKED}", "smollm-360m", "none", True,
                 grid))
    runs.append((f"smollm-360m/none/{MASKED_SPREAD}", "smollm-360m", "none",
                 True, grid))
    runs.append((f"{MOE}/none/{MOE_SPREAD}", MOE, "none", False, pods))
    res = {}
    for key, arch, comp, masked, (mesh, mesh_cfg) in runs:
        rules = AxisRules.default(
            mesh_cfg.multi_pod, pods=mesh_cfg.pods, data=mesh_cfg.data,
            model=mesh_cfg.model).with_mesh(mesh)
        cfg = ModelConfig(**JPEG) if arch == "jpeg-resnet" \
            else reduced_config(arch)
        model = build_model(cfg)
        accum = 2 * ACCUM if key.endswith((MASKED_SPREAD, MOE_SPREAD)) \
            else ACCUM
        tc = TrainConfig(grad_accum=accum, learning_rate=LR, eps=EPS,
                         schedule="constant", grad_compression=comp)
        run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                        train=tc, mesh=mesh_cfg)
        with mesh, sharding_rules(rules):
            b = build_train_step(model, run, mesh, rules)
            flat, tdef = jax.tree_util.tree_flatten_with_path(
                b.params_shape)
            params = jax.tree_util.tree_unflatten(tdef, [
                jnp.asarray(a) for a in draw(
                    [(path_str(p), l.shape) for p, l in flat])])
            opt = b.init_fns[1](params)
            p_sh, o_sh, b_sh = b.in_shardings
            # placed as the step's outputs are, so it compiles once
            params, opt = jax.device_put((params, opt), (p_sh, o_sh))
            if masked:  # the mask cut as the labels are
                b_sh = dict(b_sh, loss_mask=b_sh["labels"])
            step = jax.jit(b.step_fn, in_shardings=(p_sh, o_sh, b_sh),
                           out_shardings=b.out_shardings)
            losses = []
            for bt in batches(cfg, masked=masked):
                params, opt, m = step(params, opt, {
                    k: jnp.asarray(v) for k, v in bt.items()})
                losses.append(float(m["loss"]))
        res[f"{key}/losses"] = np.array(losses)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            res[f"{key}/{path_str(p)}"] = np.asarray(leaf)
    np.savez(out_path, **res)


# --------------------------------------------------------------- the port


def _rank_runs(mesh):
    """Every (arch, compression) run on this rank, three more layouts of
    the dense model's (``LAYOUTS``) and its masked runs (``MASKED``,
    ``MASKED_SPREAD``) → on rank 0 the losses, the full parameters after 3
    steps and the MoE's dropped pairs."""
    from repro_torch.configs import (MeshConfig, ModelConfig, RunConfig,
                                     ShapeConfig, TrainConfig,
                                     reduced_config)
    from repro_torch.launch.mesh import make_axis_rules, make_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import gather_full, path_str
    from repro_torch.tree import leaves_with_paths, tree_map

    dropped = [0]
    routing = moe._routing

    def counting(probs, cfg, cap):
        out = routing(probs, cfg, cap)
        dropped[0] += int((out[2] == cfg.n_experts * cap).sum())
        return out

    moe._routing = counting
    pods = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    grid = MeshConfig(data=2, model=2)
    runs = [(f"{arch}/{comp}", arch, comp, mesh, grid, True, False)
            for arch in ARCHS for comp in COMPRESSION]
    runs += [(f"smollm-360m/none/{LAYOUTS[0]}", "smollm-360m", "none",
              mesh, grid, False, False),
             (f"smollm-360m/none/{LAYOUTS[1]}", "smollm-360m", "none", pods,
              MeshConfig(multi_pod=True, pods=2, data=2, model=1), True,
              False),
             (f"smollm-360m/none/{LAYOUTS[2]}", "smollm-360m", "none", pods,
              MeshConfig(multi_pod=True, pods=2, data=2, model=1), True,
              False),
             (f"smollm-360m/none/{MASKED}", "smollm-360m", "none", mesh,
              grid, True, True),
             (f"smollm-360m/none/{MASKED_SPREAD}", "smollm-360m", "none",
              pods, MeshConfig(multi_pod=True, pods=2, data=2, model=1),
              True, True),
             (f"{MOE}/none/{MOE_SPREAD}", MOE, "none", pods,
              MeshConfig(multi_pod=True, pods=2, data=2, model=1), True,
              False)]
    res = {}
    for key, arch, comp, on, mesh_cfg, zero1, masked in runs:
        cfg = ModelConfig(**JPEG) if arch == "jpeg-resnet" \
            else reduced_config(arch)
        model = build_model(cfg)
        dropped[0] = 0
        accum = 2 * ACCUM if key.endswith(
            (LAYOUTS[2], MASKED_SPREAD, MOE_SPREAD)) else ACCUM
        tc = TrainConfig(grad_accum=accum, learning_rate=LR, eps=EPS,
                         schedule="constant", grad_compression=comp,
                         zero1=zero1)
        run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                        train=tc, mesh=mesh_cfg)
        b = build_train_step(model, run, on, make_axis_rules(mesh_cfg))
        shapes = [(path_str(p), tuple(t.shape))
                  for p, t in leaves_with_paths(b.params_shape)]
        it = iter(draw(shapes))
        full = tree_map(lambda _: torch.from_numpy(next(it)), b.params_shape)
        params = b.init_fns[0](full)
        opt = b.init_fns[1](params)
        losses = []
        for bt in batches(cfg, masked=masked):
            params, opt, metrics = b.step_fn(params, opt, {
                k: torch.from_numpy(v) for k, v in bt.items()})
            losses.append(float(metrics["loss"]))
        full = tree_map(lambda x, sp: gather_full(x, sp, on), params,
                        b.in_shardings[0])
        res[f"{key}/losses"] = np.array(losses)
        res[f"{key}/dropped"] = dropped[0]
        for p, leaf in leaves_with_paths(full):
            res[f"{key}/{path_str(p)}"] = leaf
    return res if torch.distributed.get_rank() == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import run_local

    out = str(tmp_path_factory.mktemp("mesh_oracle") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "oracle", out], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        port = run_local(_rank_runs, (2, 2), ("data", "model"),
                         backend="gloo", device="cpu")[0]
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-3000:]
    with np.load(out) as z:
        return dict(z), port


@pytest.mark.parametrize("comp", COMPRESSION)
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_the_references_2x2_run(runs, arch, comp):
    ref, port = runs
    want, got = ref[f"{arch}/{comp}/losses"], port[f"{arch}/{comp}/losses"]
    assert np.isfinite(got).all()
    rtol = LOSS_RTOL if comp == "none" else BF16_LOSS_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol)


def _leaf_keys(res: dict, prefix: str) -> list[str]:
    """The parameter leaves of the run at ``prefix`` (not those of the
    extra runs under it)."""
    return sorted(k for k in res if k.startswith(prefix)
                  and not k.endswith(("/losses", "/dropped"))
                  and k[len(prefix):].split("/")[0]
                  not in LAYOUTS + (MASKED, MASKED_SPREAD, MOE_SPREAD))


@pytest.mark.parametrize("comp", COMPRESSION)
@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_after_three_steps_match(runs, arch, comp):
    ref, port = runs
    prefix = f"{arch}/{comp}/"
    keys = _leaf_keys(ref, prefix)
    assert keys and keys == _leaf_keys(port, prefix)
    for k in keys:
        want, got = ref[k], port[k]
        assert got.shape == want.shape, k
        diff = np.abs(got - want)
        if comp == "bf16":
            assert diff.mean() <= BF16_MEAN_ATOL, (k, diff.mean())
            assert diff.max() <= BF16_MAX_ATOL, (k, diff.max())
        else:
            assert diff.max() <= PARAM_RTOL * np.abs(want).max(), \
                (k, diff.max())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_other_layouts_of_the_dense_step_match(runs, layout):
    """ZeRO-1 off (the gradients all-reduced once after accumulation), a
    2 (pod) × 2 (data) mesh (the batch over both axes, ZeRO-1 over
    ``data``, the pod sum beside it), and that mesh with microbatches
    smaller than its batch ranks (the batch over ``pod`` alone): the same
    global-batch step as the reference's data × model run, at the
    ``none`` tolerances."""
    ref, port = runs
    want_losses = ref["smollm-360m/none/losses"]
    np.testing.assert_allclose(
        port[f"smollm-360m/none/{layout}/losses"], want_losses,
        rtol=LOSS_RTOL)
    for k in _leaf_keys(ref, "smollm-360m/none/"):
        want = ref[k]
        got = port[k.replace("/none/", f"/none/{layout}/")]
        diff = np.abs(got - want).max()
        assert diff <= PARAM_RTOL * np.abs(want).max(), (layout, k, diff)


def test_a_masked_loss_is_the_global_microbatchs_masked_mean(runs):
    """The data ranks of a microbatch hold different numbers of unmasked
    tokens, and the port's losses and parameters after 3 steps are the
    reference's masked 2×2 run's at the ``none`` tolerances."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import batch_rows

    for bt in batches(reduced_config("smollm-360m"), masked=True):
        per_rank = [bt["loss_mask"][batch_rows(B, ACCUM, 2, r)].reshape(
            ACCUM, -1).sum(axis=1) for r in range(2)]
        assert (per_rank[0] != per_rank[1]).all()
    ref, port = runs
    key = f"smollm-360m/none/{MASKED}"
    np.testing.assert_allclose(port[f"{key}/losses"], ref[f"{key}/losses"],
                               rtol=LOSS_RTOL)
    keys = _leaf_keys(ref, f"{key}/")
    assert keys and keys == _leaf_keys(port, f"{key}/")
    for k in keys:
        diff = np.abs(port[k] - ref[k]).max()
        assert diff <= PARAM_RTOL * np.abs(ref[k]).max(), (k, diff)


def test_a_masked_loss_over_spread_microbatches_is_their_masked_mean(runs):
    """4 microbatches of 2 rows over 2 (pod) × 2 batch ranks, with a loss
    mask: each rank holds one microbatch and runs it a row at a time, the
    mask counted per microbatch over every rank.  The losses and
    parameters after 3 steps are the reference's masked run of 4
    microbatches at the ``none`` tolerances."""
    from repro_torch.launch.steps import batch_rows

    assert batch_rows(B, 2 * ACCUM, 4, 1) == [2, 3]
    ref, port = runs
    key = f"smollm-360m/none/{MASKED_SPREAD}"
    np.testing.assert_allclose(port[f"{key}/losses"], ref[f"{key}/losses"],
                               rtol=LOSS_RTOL)
    keys = _leaf_keys(ref, f"{key}/")
    assert keys and keys == _leaf_keys(port, f"{key}/")
    for k in keys:
        diff = np.abs(port[k] - ref[k]).max()
        assert diff <= PARAM_RTOL * np.abs(ref[k]).max(), (k, diff)


def test_the_moe_runs_drop_tokens(runs):
    _, port = runs
    for comp in COMPRESSION:
        assert port[f"granite-moe-3b-a800m/{comp}/dropped"] > 0


def test_the_moe_over_spread_microbatches_is_the_references(runs):
    """4 microbatches of 2 rows over 2 (pod) × 2 batch ranks: the port's
    rank runs its microbatch a row at a time, each row one of the
    reference's dispatch groups (``steps.moe_group_rows``), the aux
    loss's counts summed per microbatch.  The losses (with the aux loss)
    and parameters after 3 steps are the reference's run on the same mesh
    at the ``none`` tolerances, and tokens were dropped."""
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.steps import local_microbatches, moe_group_rows

    rules = make_axis_rules(MeshConfig(multi_pod=True, pods=2, data=2,
                                       model=1))
    assert moe_group_rows(rules, B // (2 * ACCUM), S) == 1
    assert local_microbatches(B, 2 * ACCUM, 4, 1) == 2
    ref, port = runs
    key = f"{MOE}/none/{MOE_SPREAD}"
    assert port[f"{key}/dropped"] > 0
    np.testing.assert_allclose(port[f"{key}/losses"], ref[f"{key}/losses"],
                               rtol=LOSS_RTOL)
    keys = _leaf_keys(ref, f"{key}/")
    assert keys and keys == _leaf_keys(port, f"{key}/")
    for k in keys:
        diff = np.abs(port[k] - ref[k]).max()
        assert diff <= PARAM_RTOL * np.abs(ref[k]).max(), (k, diff)


if __name__ == "__main__" and sys.argv[1:2] == ["oracle"]:
    oracle(sys.argv[2])
