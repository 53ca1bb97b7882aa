"""The port's mesh building blocks against the reference, on the CPU.

* Spec parity: ``param_pspec`` and ``zero1_pspec`` of every leaf of all 11
  archs at full width, on the default single-pod (16×16) and multi-pod
  (2×16×16) rules and on 2×2, equal to the reference's (the leaf paths and
  shapes from ``jax.eval_shape`` of the reference's ``init_params``, which
  the port's ``registry.param_shapes`` matches), and the batch and cache
  axis rules.
* The reference's own results in one subprocess with 8 forced host
  devices, the port's on gloo ranks spawned by ``launch.mesh.run_local``:
  the MoE's expert-parallel path on 2×2 with a capacity that drops tokens
  (output, aux loss and gradients within 1e-5), once in one dispatch
  group a rank and once with ``GROUP`` set to MOE_GROUP in both packages,
  so each rank's tokens form two groups, each recomputed in the backward
  with its capacity of its own; ``pipelined_apply`` over 4
  stages, the three collectives on a 2 (pod) × 4 (data) mesh, and the
  elastic restore on 2×4 and 4×2.

Tolerances: bit-equal where the arithmetic is a copy (the ring gather, a
restore's slices, the pipeline against the port's own sequential stages,
integer-valued bf16 sums); 1e-6 relative where it sums in another order
(the hierarchical sum, the pipeline against the reference); 1e-5 of the
largest |value| for the MoE, whose routing both packages compute in fp32
from the same inputs (a capacity drop that hung on a near-tie of the
router would show as a whole differing row; there is none).
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

ARCHS = ("granite-3-2b", "granite-moe-3b-a800m", "internvl2-1b",
         "jamba-v0.1-52b", "jpeg-resnet", "mistral-nemo-12b", "mixtral-8x7b",
         "rwkv6-7b", "smollm-360m", "starcoder2-3b", "whisper-small")
RULES = {"single-pod": (False, 2, 16, 16), "multi-pod": (True, 2, 16, 16),
         "2x2": (False, 2, 2, 2)}
MOE_B, MOE_S, MOE_CF = 4, 8, 0.5
#: tokens per dispatch group in the grouped run: a data rank's 16 tokens
#: form two groups
MOE_GROUP = 8
PP_STAGES, PP_MICRO, PP_MB, PP_D = 4, 6, 8, 16
MOE_TOL, SUM_RTOL = 1e-5, 1e-6


def moe_inputs(d: int, e: int, f: int) -> dict:
    rng = np.random.default_rng(3)
    return {
        "router": rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5,
        "w_gate": rng.standard_normal((e, d, f)).astype(np.float32)
        * d ** -0.5,
        "w_in": rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5,
        "w_out": rng.standard_normal((e, f, d)).astype(np.float32)
        * f ** -0.5,
        "x": rng.standard_normal((MOE_B, MOE_S, d)).astype(np.float32),
        "w": rng.standard_normal((MOE_B, MOE_S, d)).astype(np.float32),
    }


def pp_inputs() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(7)
    w = rng.standard_normal((PP_STAGES, PP_D, PP_D)).astype(np.float32) * 0.3
    mb = rng.standard_normal((PP_MICRO, PP_MB, PP_D)).astype(np.float32)
    return w, mb


def coll_inputs() -> np.ndarray:
    return np.random.default_rng(11).standard_normal((8, 3)).astype(
        np.float32)


# ------------------------------------------------------------- the oracle


def oracle(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.checkpoint import CheckpointManager
    from repro.configs.base import reduced_config
    from repro.models import moe as M
    from repro.parallel.collectives import (hierarchical_psum,
                                            psum_compressed,
                                            ring_all_gather)
    from repro.parallel.compat import make_mesh, shard_map
    from repro.parallel.pipeline import pipelined_apply
    from repro.parallel.sharding import AxisRules, sharding_rules

    res = {}
    # the MoE's expert-parallel path on 2×2, dropping tokens
    cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"),
                              capacity_factor=MOE_CF)
    inp = moe_inputs(cfg.d_model, cfg.n_experts, cfg.d_ff)
    params = {k: jnp.asarray(inp[k])
              for k in ("router", "w_gate", "w_in", "w_out")}
    x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])

    def loss(p, x):
        out, aux = M.moe_ffn(x, p, cfg)
        return jnp.sum(out * w) + 3.0 * aux, (out, aux)

    mesh = make_mesh((2, 2), ("data", "model"))
    rules = AxisRules.default(False, data=2, model=2).with_mesh(mesh)
    group = M.GROUP
    for key, size in (("moe", group), ("moe_groups", MOE_GROUP)):
        M.GROUP = size
        with mesh, sharding_rules(rules):
            (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
        res[f"{key}/out"], res[f"{key}/aux"] = np.asarray(out), \
            np.asarray(aux)
        res[f"{key}/grad/x"] = np.asarray(gx)
        for k, v in gp.items():
            res[f"{key}/grad/{k}"] = np.asarray(v)
    M.GROUP = group
    # the global path beside it: per-shard capacity drops other tokens
    res["moe/global_out"] = np.asarray(M.moe_ffn(x, params, cfg)[0])

    # the pipeline over 4 stages
    wst, mb = pp_inputs()
    with make_mesh((PP_STAGES,), ("stage",)) as pmesh:
        res["pp/out"] = np.asarray(pipelined_apply(
            lambda p, h: jnp.tanh(h @ p["w"]), {"w": jnp.asarray(wst)},
            jnp.asarray(mb), pmesh))

    # the collectives on pod × data
    cmesh = make_mesh((2, 4), ("pod", "data"))
    xs = coll_inputs()
    spec = JP(("pod", "data"), None)

    def coll(v):
        return (hierarchical_psum(v, "data", "pod"),
                psum_compressed(jnp.round(v * 4), ("pod", "data")),
                ring_all_gather(v, "data"))

    a, b, g = shard_map(coll, mesh=cmesh, in_specs=spec,
                        out_specs=(spec, spec, JP(("pod", "data"), None,
                                                  None)),
                        check_vma=False)(jnp.asarray(xs))
    res["coll/hier"], res["coll/bf16"] = np.asarray(a), np.asarray(b)
    res["coll/ring"] = np.asarray(g)

    # elastic restore: one unsharded save, two meshes
    tree = {"w": jnp.arange(64.0).reshape(8, 8)}
    with tempfile.TemporaryDirectory() as d:
        m = CheckpointManager(d)
        m.save(1, tree)
        for shape in ((2, 4), (4, 2)):
            rmesh = make_mesh(shape, ("data", "model"))
            sh = {"w": NamedSharding(rmesh, JP("data", "model"))}
            step, restored, _ = m.restore_latest(tree, sh)
            assert step == 1
            ids = {dev.id: c for c, dev in np.ndenumerate(rmesh.devices)}
            for s in restored["w"].addressable_shards:
                i, j = ids[s.device.id]
                res[f"restore/{shape[0]}x{shape[1]}/{i}/{j}"] = np.asarray(
                    s.data)
    np.savez(out_path, **res)


# --------------------------------------------------------------- the port


def _ranks_8(mesh):
    """On 8 ranks: the collectives on (pod, data), then the restore on
    2×4 and 4×2 (data, model) meshes, and a save under a mesh."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import P, local_slice

    rank = torch.distributed.get_rank()
    out = {}
    x = torch.from_numpy(coll_inputs())[rank:rank + 1]
    out["hier"] = C.hierarchical_psum(x, "data", "pod", mesh=mesh)
    out["bf16"] = C.psum_compressed(torch.round(x * 4), ("pod", "data"),
                                    mesh=mesh)
    out["ring"] = C.ring_all_gather(x, "data", mesh=mesh)
    out["staged"] = sum(C.STAGED.values())
    full = torch.arange(64.0).reshape(8, 8)
    tmp = os.environ["MESH_TEST_DIR"]
    if rank == 0:
        CheckpointManager(os.path.join(tmp, "plain")).save(1, {"w": full})
    torch.distributed.barrier()
    for shape in ((2, 4), (4, 2)):
        rmesh = make_mesh(shape, ("data", "model"), "cpu")
        spec = {"w": P("data", "model")}
        m = CheckpointManager(os.path.join(tmp, "plain"))
        step, restored, _ = m.restore_latest({"w": torch.zeros(1)}, spec,
                                             rmesh)
        key = f"{shape[0]}x{shape[1]}"
        out[f"restore/{key}"] = (step, rmesh.get_coordinate(),
                                 restored["w"])
        # saved from this mesh's slices, read back whole without a mesh
        mm = CheckpointManager(os.path.join(tmp, f"from_{key}"))
        mm.save(2, {"w": local_slice(full, spec["w"], rmesh)},
                extra={"mesh": key}, spec_tree=spec, mesh=rmesh)
        torch.distributed.barrier()
        got, extra = mm.restore(2, {"w": torch.zeros(1)})
        out[f"resave/{key}"] = (torch.equal(got["w"], full), extra)
    return out


def _ranks_4(mesh):
    """On 4 ranks: the MoE's expert-parallel path on the 2×2 mesh, then
    the pipeline over a 4-stage mesh."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_axis_rules, make_mesh
    from repro_torch.configs import MeshConfig
    from repro_torch.models import moe
    from repro_torch.parallel.pipeline import pipelined_apply, \
        stack_stage_params
    from repro_torch.parallel.sharding import (P, gather_full, local_slice,
                                               param_pspec, sharding_rules)
    from repro_torch.parallel import collectives as C

    out = {}
    cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"),
                              capacity_factor=MOE_CF)
    rules = make_axis_rules(MeshConfig(data=2, model=2)).with_mesh(mesh)
    group = moe.GROUP
    for key, size in (("moe", group), ("moe_groups", MOE_GROUP)):
        moe.GROUP = size
        # fresh leaves: a replicated leaf's local slice is the tensor itself
        inp = {k: torch.from_numpy(v) for k, v in
               moe_inputs(cfg.d_model, cfg.n_experts, cfg.d_ff).items()}
        with sharding_rules(rules):
            specs = {k: param_pspec(f"blocks/pos0/moe/{k}",
                                    tuple(inp[k].shape), cfg)
                     for k in ("router", "w_gate", "w_in", "w_out")}
            row = P("data", None, None)
            local = {k: local_slice(inp[k], s, mesh).requires_grad_(True)
                     for k, s in specs.items()}
            x = local_slice(inp["x"], row, mesh).requires_grad_(True)
            w = local_slice(inp["w"], row, mesh)
            y, aux = moe.moe_ffn(x, local, cfg)
            # each data rank's rows; the aux loss once over the data ranks
            (torch.sum(y * w) + 3.0 * aux / 2).backward()
        out[f"{key}/out"] = gather_full(y.detach(), row, mesh)
        out[f"{key}/aux"] = aux.detach()
        out[f"{key}/grad/x"] = gather_full(x.grad, row, mesh)
        for k, s in specs.items():
            g = local[k].grad
            if "data" not in [a for e in s for a in
                              ((e,) if isinstance(e, str) else (e or ()))]:
                g = C.all_reduce(g, mesh, ("data",))  # the data ranks' rows
            out[f"{key}/grad/{k}"] = gather_full(g, s, mesh)
    moe.GROUP = group
    out["moe/specs"] = {k: tuple(s) for k, s in specs.items()}

    out["remat_thread"] = _backward_on_another_thread(mesh)

    wst, mb = pp_inputs()
    pmesh = make_mesh((PP_STAGES,), ("stage",), "cpu")
    stages = [{"w": torch.from_numpy(wst[i])} for i in range(PP_STAGES)]
    stacked = stack_stage_params(stages)
    mine = {"w": local_slice(stacked["w"], P("stage", None, None), pmesh)}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])

    out["pp/out"] = pipelined_apply(stage_fn, mine, torch.from_numpy(mb),
                                    pmesh)
    seq = torch.from_numpy(mb)
    for s in stages:
        seq = stage_fn(s, seq)
    out["pp/seq"] = seq
    return out


def _backward_on_another_thread(mesh) -> float:
    """On CUDA the autograd engine runs the backward on its own thread,
    where the forward's thread-local mesh rules are not installed, and a
    recomputed (``remat``) layer must still see them.  The CPU runs the
    backward on the calling thread, so here the backward is run on a
    fresh thread: its gradients against the same backward on this
    thread (the largest difference; it raised before the fix)."""
    import dataclasses as dc
    import threading

    from repro_torch.configs import MeshConfig, reduced_config
    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.steps import params_shardings
    from repro_torch.models.registry import build_model, param_shapes
    from repro_torch.parallel.sharding import (local_slice, path_str,
                                               sharding_rules)
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    cfg = reduced_config("granite-moe-3b-a800m")
    model = build_model(cfg, remat="full")
    rules = make_axis_rules(MeshConfig(data=2, model=2))
    with sharding_rules(rules):
        specs = params_shardings(param_shapes(model), cfg)
    rules = dc.replace(rules, mesh=mesh, specs={
        path_str(p): sp for p, sp in leaves_with_paths(specs)})
    full = model.init_params(torch.Generator().manual_seed(0), "cpu")
    params = tree_map(lambda x, sp: local_slice(x, sp, mesh)
                      .requires_grad_(True), full, specs)
    rank = mesh.get_local_rank("data")
    tokens = torch.arange(2 * 16).reshape(2, 16) % cfg.vocab_size
    batch = {"tokens": tokens[rank:rank + 1],
             "labels": tokens[rank:rank + 1].roll(1, -1)}
    grads = []
    for thread in (False, True):
        with sharding_rules(rules):
            loss = model.loss_fn(params, batch)[0]
        out = {}

        def backward():
            try:
                out["g"] = torch.autograd.grad(loss, leaves(params))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                out["e"] = e

        if thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            with sharding_rules(rules):
                backward()
        if "e" in out:
            raise out["e"]
        grads.append(out["g"])
    return max(float((a - b).abs().max()) for a, b in zip(*grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import run_local

    tmp = tmp_path_factory.mktemp("mesh_parallel")
    out = str(tmp / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "oracle", out], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        os.environ["MESH_TEST_DIR"] = str(tmp)
        eight = run_local(_ranks_8, (2, 4), ("pod", "data"), backend="gloo",
                          device="cpu")
        four = run_local(_ranks_4, (2, 2), ("data", "model"),
                         backend="gloo", device="cpu")
        log, _ = ref.communicate(timeout=600)
    finally:
        os.environ.pop("MESH_TEST_DIR", None)
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-3000:]
    with np.load(out) as z:
        return dict(z), eight, four


# ------------------------------------------------------------ spec parity

_SHAPES: dict = {}


def _ref_shapes(arch: str) -> list:
    """[(path, shape)] of the reference's full-width parameters."""
    if arch not in _SHAPES:
        import jax
        from repro.configs.base import get_config
        from repro.launch.steps import path_str
        from repro.models.registry import build_model

        tree = jax.eval_shape(build_model(get_config(arch)).init_params,
                              jax.random.PRNGKey(0))
        _SHAPES[arch] = [(path_str(p), tuple(leaf.shape)) for p, leaf in
                         jax.tree_util.tree_flatten_with_path(tree)[0]]
    return _SHAPES[arch]


def _rules(name: str):
    from repro.parallel import sharding as RS
    from repro_torch.parallel import sharding as S

    multi, pods, data, model = RULES[name]
    return (RS.AxisRules.default(multi, pods=pods, data=data, model=model),
            S.AxisRules.default(multi, pods=pods, data=data, model=model))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_the_references_eval_shape(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model, param_shapes
    from repro_torch.parallel.sharding import path_str
    from repro_torch.tree import leaves_with_paths

    got = [(path_str(p), tuple(t.shape)) for p, t in
           leaves_with_paths(param_shapes(build_model(get_config(arch))))]
    assert got == _ref_shapes(arch)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_the_reference(arch, rules):
    from repro.configs.base import get_config as ref_config
    from repro.parallel import sharding as RS
    from repro_torch.configs import get_config
    from repro_torch.parallel import sharding as S

    ref_rules, port_rules = _rules(rules)
    rcfg, cfg = ref_config(arch), get_config(arch)
    cut = 0
    with RS.sharding_rules(ref_rules), S.sharding_rules(port_rules):
        for path, shape in _ref_shapes(arch):
            want = RS.param_pspec(path, shape, rcfg)
            got = S.param_pspec(path, shape, cfg)
            assert isinstance(got, S.PartitionSpec)
            assert tuple(got) == tuple(want), (path, got, want)
            zw = RS.zero1_pspec(want, shape, ref_rules)
            zg = S.zero1_pspec(got, shape, port_rules)
            assert tuple(zg) == tuple(zw), (path, zg, zw)
            cut += any(e is not None for e in zg)
    assert cut > 0  # the optimizer state of every arch is cut


@pytest.mark.parametrize("rules", sorted(RULES))
def test_batch_and_cache_axes_match_the_reference(rules):
    from repro.parallel import sharding as RS
    from repro_torch.parallel import sharding as S

    ref_rules, port_rules = _rules(rules)
    for b in (1, 2, 3, 4, 16, 32, 128, 256):
        assert S.batch_pspec(port_rules, b) == RS.batch_pspec(ref_rules, b)
        assert S.cache_pspec(port_rules, b) == RS.cache_pspec(ref_rules, b)
    assert tuple(S.logical_pspec("batch", None)) == ()  # no rules: empty
    with RS.sharding_rules(ref_rules), S.sharding_rules(port_rules):
        for names in (("batch", None, "model"), ("data", "replicated")):
            assert tuple(S.logical_pspec(*names)) \
                == tuple(RS.logical_pspec(*names))


def test_local_slices_reassemble_and_rules_switch_off():
    from repro_torch.parallel import sharding as S

    assert S.active_rules() is None
    with S.sharding_rules(S.AxisRules.default(False)):
        assert S.active_rules() is None  # rules without a mesh
    assert S.path_str("['blocks']/['pos0']/[1]/.step") == "blocks/pos0/1/.step"
    assert S.P(None, ("pod", "data"))[1:] == (("pod", "data"),)


# --------------------------------------------------------- against runs


def _hold_moe(ref: dict, four: list, key: str) -> None:
    """The port's EP run ``key`` against the reference's: output, aux loss
    and gradients within MOE_TOL of the largest |value|, and the same
    output on every rank."""
    got = four[0]
    for k in ("out", "aux", "grad/x", "grad/router", "grad/w_gate",
              "grad/w_in", "grad/w_out"):
        want = ref[f"{key}/{k}"]
        assert got[f"{key}/{k}"].shape == want.shape, k
        err = np.abs(got[f"{key}/{k}"] - want).max()
        assert err <= MOE_TOL * max(np.abs(want).max(), 1.0), (key, k, err)
    for r in four[1:]:
        np.testing.assert_array_equal(r[f"{key}/out"], got[f"{key}/out"])


def test_moe_expert_parallel_path_matches_the_reference(runs):
    ref, _, four = runs
    _hold_moe(ref, four, "moe")
    assert four[0]["moe/specs"]["w_gate"] == (None, "data", "model")


def test_moe_expert_parallel_groups_match_the_reference(runs):
    """Two dispatch groups a rank (``GROUP`` = MOE_GROUP in both packages):
    the port's grouped path, each group checkpointed with the model-axis
    collectives in its recomputation, against the reference's scan over
    the groups.  Each group's capacity drops other tokens than one group's
    would, so the grouped output differs from the one-group output."""
    ref, _, four = runs
    _hold_moe(ref, four, "moe_groups")
    assert np.abs(ref["moe_groups/out"] - ref["moe/out"]).max() > 1e-3


def test_moe_shards_drop_other_tokens_than_the_global_dispatch(runs):
    """Capacity is per shard, as in the reference: its EP output differs
    from its global path's, and the port's differs the same way."""
    ref, _, four = runs
    diff = np.abs(ref["moe/out"] - ref["moe/global_out"]).max(axis=-1)
    assert (diff > 1e-3).sum() > 0
    assert np.abs(four[0]["moe/out"] - ref["moe/global_out"]).max() > 1e-3


def test_pipeline_matches_the_reference_and_sequential_stages(runs):
    from repro_torch.parallel.pipeline import bubble_fraction

    ref, _, four = runs
    for r in four:
        np.testing.assert_array_equal(r["pp/out"], four[0]["pp/seq"])
        np.testing.assert_allclose(r["pp/out"], ref["pp/out"],
                                   rtol=SUM_RTOL, atol=SUM_RTOL)
    assert bubble_fraction(PP_STAGES, PP_MICRO) == 3 / 9


def test_collectives_match_the_reference(runs):
    ref, eight, _ = runs
    for rank, r in enumerate(eight):
        np.testing.assert_allclose(r["hier"], ref["coll/hier"][rank:rank + 1],
                                   rtol=SUM_RTOL)
        np.testing.assert_array_equal(r["bf16"],
                                      ref["coll/bf16"][rank:rank + 1])
        np.testing.assert_array_equal(r["ring"],
                                      ref["coll/ring"][4 * rank:4 * rank + 4])
        assert r["staged"] == 0  # CPU tensors never stage


def test_a_recomputed_layer_sees_the_rules_on_the_backwards_thread(runs):
    _, _, four = runs
    for r in four:
        assert r["remat_thread"] == 0.0


@pytest.mark.parametrize("mesh", ["2x4", "4x2"])
def test_elastic_restore_gives_the_references_slices(runs, mesh):
    ref, eight, _ = runs
    for r in eight:
        step, (i, j), got = r[f"restore/{mesh}"]
        assert step == 1
        np.testing.assert_array_equal(got, ref[f"restore/{mesh}/{i}/{j}"])


@pytest.mark.parametrize("mesh", ["2x4", "4x2"])
def test_a_save_under_a_mesh_reads_back_whole_without_one(runs, mesh):
    _, eight, _ = runs
    for r in eight:
        whole, extra = r[f"resave/{mesh}"]
        assert whole and extra == {"mesh": mesh}


if __name__ == "__main__" and sys.argv[1:2] == ["oracle"]:
    oracle(sys.argv[2])
