"""The port's prefill and decode steps on a 2×2 (data × model) mesh
against the reference's own 2×2 steps and against one device, on the CPU,
and the cache spec trees against the reference's.

The reference runs in one subprocess with four forced host devices
(``launch.steps.build_prefill_step`` / ``build_decode_step`` jitted with
their shardings on ``make_test_mesh(2, 2)``); the port runs the same
steps on four gloo ranks spawned by ``launch.mesh.run_local``.  Both take
the same numpy-drawn parameters, prompts, decode caches and tokens, for
reduced ``smollm-360m`` (3/1 heads: attention gathered), ``mixtral-8x7b``
(a 64-slot window, MoE), ``jamba-v0.1-52b`` (Mamba states cut along
``d_inner``, attention and MoE), ``rwkv6-7b`` (``wkv`` cut by head) and
``whisper-small`` (a cross cache; its prefill is the encoder), each at
batch 2 (the cache's slots over ``model``) and batch 1 (over both axes).
Decode starts at index ``INDEX`` of a ``T``-slot cache and takes
``STEPS`` steps: ring slots 14, 15 and 0, so each step writes on one
rank's slots only, the last one after a wrap, on another rank than the
first two.

Tolerances: the logits within 1e-5 of the largest |logit| of the step,
and every cache leaf (gathered whole from the ranks' slices) within 1e-5
of its largest |value|: both packages compute in fp32, the sums over the
mesh in another order (measured below 3e-6).  Against one device the
MoE models run with a capacity factor of 8 on both sides, so no token is
dropped (capacity is per batch shard on the mesh, global on one device),
and RWKV with 2 heads, so each rank of ``model`` holds one head of the
``wkv`` state, as a production rank holds 4 of 64.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

ARCHS = ("smollm-360m", "mixtral-8x7b", "jamba-v0.1-52b", "rwkv6-7b",
         "whisper-small")
BATCHES = (2, 1)
S, T, INDEX, STEPS = 16, 16, 14, 3
TOL = 1e-5
#: the language models: every arch of the port but jpeg-resnet, a
#: classification net without a decode cache
LM_ARCHS = ("granite-3-2b", "granite-moe-3b-a800m", "internvl2-1b",
            "jamba-v0.1-52b", "mistral-nemo-12b", "mixtral-8x7b",
            "rwkv6-7b", "smollm-360m", "starcoder2-3b", "whisper-small")


def draw(paths_shapes, seed: int = 0) -> list[np.ndarray]:
    """Parameters in leaf order: norms near 1, biases small, projections
    by fan-in (the scheme of ``tests/test_torch_sharded_train.py``)."""
    rng = np.random.default_rng(seed)
    out = []
    for path, shape in paths_shapes:
        name = path.split("/")[-1]
        if name.startswith("ln"):
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif len(shape) <= 1 or name in ("b", "bi", "bo"):
            a = 0.1 * rng.standard_normal(shape)
        else:
            fan = shape[-1] if name == "embed" else shape[-2]
            a = rng.standard_normal(shape) * fan ** -0.5
        out.append(a.astype(np.float32))
    return out


def draw_cache(paths_shapes, seed: int = 5) -> dict:
    """A decode cache: every state and key normal, the index INDEX."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in paths_shapes:
        if path == "index":
            out[path] = np.asarray(INDEX, np.int32)
        else:
            out[path] = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    return out


def prompt(cfg, b: int, seed: int = 2) -> dict:
    """A prefill batch: S tokens, or for the audio family S frames and
    max(S // 8, 8) tokens."""
    rng = np.random.default_rng(seed + b)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((b, S, cfg.d_model)).astype(
            np.float32), "tokens": rng.integers(
                0, cfg.vocab_size, (b, max(S // 8, 8))).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(
        np.int32)}


def tokens(cfg, b: int, seed: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed + b)
    return [rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
            for _ in range(STEPS)]


# ------------------------------------------------------------- the oracle


def oracle(out_path: str) -> None:
    """The reference's 2×2 prefill and decode → ``out_path`` (npz): per
    arch and batch the prefill output and cache, the decode cache drawn,
    each step's logits and the cache after the steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import (MeshConfig, RunConfig, ShapeConfig,
                                    reduced_config)
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import (build_decode_step, build_prefill_step,
                                    path_str)
    from repro.models.registry import build_model
    from repro.parallel.sharding import AxisRules, sharding_rules

    def flat(tree):
        return [(path_str(p), leaf) for p, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]]

    mesh = make_test_mesh(2, 2)
    rules = AxisRules.default(False, data=2, model=2).with_mesh(mesh)
    res = {}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        model = build_model(cfg)
        for b in BATCHES:
            key = f"{arch}/{b}"
            run = RunConfig(model=cfg, shape=ShapeConfig("p", S, b,
                                                         "prefill"),
                            mesh=MeshConfig(data=2, model=2))
            with mesh, sharding_rules(rules):
                step, sh, pshape, _ = build_prefill_step(model, run, mesh,
                                                         rules)
                leaves = flat(pshape)
                tdef = jax.tree_util.tree_structure(pshape)
                params = jax.tree_util.tree_unflatten(tdef, [
                    jnp.asarray(a) for a in draw(
                        [(p, leaf.shape) for p, leaf in leaves])])
                batch = {k: jnp.asarray(v) for k, v in
                         prompt(cfg, b).items()}
                out, cache = jax.jit(step, in_shardings=sh)(params, batch)
            res[f"{key}/prefill/out"] = np.asarray(out)
            for p, leaf in flat(cache or {}):
                res[f"{key}/prefill/cache/{p}"] = np.asarray(leaf)
            run = dataclasses.replace(run, shape=ShapeConfig("d", T, b,
                                                             "decode"))
            with mesh, sharding_rules(rules):
                step, sh, (pshape, cshape, _) = build_decode_step(
                    model, run, mesh, rules)
                drawn = draw_cache([(p, leaf.shape)
                                    for p, leaf in flat(cshape)])
                for p, a in drawn.items():
                    res[f"{key}/decode/cache_in/{p}"] = a
                cache = jax.tree_util.tree_unflatten(
                    jax.tree_util.tree_structure(cshape),
                    [jnp.asarray(drawn[p]) for p, _ in flat(cshape)])
                jitted = jax.jit(step, in_shardings=sh,
                                 out_shardings=(None, sh[1]))
                for i, t in enumerate(tokens(cfg, b)):
                    logits, cache = jitted(params, cache,
                                           {"tokens": jnp.asarray(t)})
                    res[f"{key}/decode/logits/{i}"] = np.asarray(logits)
            for p, leaf in flat(cache):
                res[f"{key}/decode/cache/{p}"] = np.asarray(leaf)
    np.savez(out_path, **res)


# --------------------------------------------------------------- the port


def _configs(arch: str):
    """(the reference's reduced config, the one held against one device:
    an MoE's capacity factor 8; RWKV with 2 heads of 32, so a rank of
    ``model`` holds one head of the ``wkv`` state)."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    if cfg.n_experts:
        return cfg, dataclasses.replace(cfg, capacity_factor=8.0)
    if cfg.ssm_kind == "rwkv6":
        return cfg, dataclasses.replace(cfg, rwkv_head_size=32)
    return cfg, cfg


def _rank_runs(mesh):
    """On every rank the port's 2×2 steps; rank 0 returns the outputs and
    the caches gathered whole, and one device's decode over the whole
    cache."""
    import torch.distributed as dist

    from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          cache_shardings)
    from repro_torch.models.registry import build_model, param_shapes
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import gather_full, path_str
    from repro_torch.tree import leaves_with_paths, tree_map

    ref = dict(np.load(os.environ["SERVE_ORACLE"]))
    rules = make_axis_rules(MeshConfig(data=2, model=2))
    res = {}

    def rows_whole(x, b):
        return C.all_gather(x, mesh, ("data",), 0) if b == 2 else x

    def whole(tree, specs):
        return {path_str(p): x for p, x in leaves_with_paths(
            tree_map(lambda x, s: gather_full(x, s, mesh), tree, specs))}

    for arch in ARCHS:
        ref_cfg, one_cfg = _configs(arch)
        for cfg, tag in ((ref_cfg, "ref"), (one_cfg, "one")):
            if tag == "one" and one_cfg == ref_cfg:
                continue
            model = build_model(cfg)
            for b in BATCHES:
                key = f"{arch}/{b}"
                run = RunConfig(model=cfg, shape=ShapeConfig("p", S, b,
                                                             "prefill"),
                                mesh=MeshConfig(data=2, model=2))
                pshape = param_shapes(model)
                it = iter(draw([(path_str(p), tuple(x.shape))
                                for p, x in leaves_with_paths(pshape)]))
                full = tree_map(lambda _: torch.from_numpy(next(it)), pshape)
                if tag == "ref":
                    pb = build_prefill_step(model, run, mesh, rules)
                    params = pb.init_fns[0](full)
                    batch = {k: torch.from_numpy(v)
                             for k, v in prompt(cfg, b).items()}
                    with torch.no_grad():
                        out, cache = pb.step_fn(params, batch)
                    res[f"{key}/prefill/out"] = rows_whole(out, b)
                    if cache is not None:
                        specs = cache_shardings(
                            model.init_cache(b, S, "meta"), cfg, rules, b)
                        for p, x in whole(cache, specs).items():
                            res[f"{key}/prefill/cache/{p}"] = x
                run = dataclasses.replace(run, shape=ShapeConfig(
                    "d", T, b, "decode"))
                db = build_decode_step(model, run, mesh, rules)
                params = db.init_fns[0](full)
                # the reference's drawn cache; a config of the port's own
                # draws its cache the same way from its shapes
                cache_in = {p[len(f"{key}/decode/cache_in/"):]: v
                            for p, v in ref.items()
                            if p.startswith(f"{key}/decode/cache_in/")} \
                    if tag == "ref" else draw_cache(
                        [(path_str(p), tuple(x.shape)) for p, x in
                         leaves_with_paths(db.cache_shape)])
                whole_cache = _fill(db.cache_shape, cache_in)
                cache = db.init_fns[1](whole_cache)
                one = _fill(db.cache_shape, cache_in)
                with torch.no_grad():
                    for i, t in enumerate(tokens(cfg, b)):
                        t = torch.from_numpy(t)
                        logits, cache = db.step_fn(params, cache,
                                                   {"tokens": t})
                        res[f"{key}/{tag}/logits/{i}"] = rows_whole(
                            logits, b)
                        lo, one = model.decode_step(full, one, {"tokens": t})
                        res[f"{key}/{tag}/one_logits/{i}"] = lo
                for p, x in whole(cache, db.in_shardings[1]).items():
                    res[f"{key}/{tag}/cache/{p}"] = x
    return res if dist.get_rank() == 0 else None


def _fill(shape_tree, arrays: dict):
    """A tree of tensors shaped as ``shape_tree`` from ``arrays`` by leaf
    path."""
    from repro_torch.parallel.sharding import path_str
    from repro_torch.tree import leaves_with_paths, tree_map

    paths = iter([path_str(p) for p, _ in leaves_with_paths(shape_tree)])
    return tree_map(lambda s: torch.from_numpy(np.array(arrays[next(paths)]))
                    .to(s.dtype), shape_tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import run_local

    out = str(tmp_path_factory.mktemp("serve_oracle") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "oracle", out], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    os.environ["SERVE_ORACLE"] = out
    try:
        port = run_local(_rank_runs, (2, 2), ("data", "model"),
                         backend="gloo", device="cpu")[0]
    finally:
        os.environ.pop("SERVE_ORACLE", None)
    with np.load(out) as z:
        return dict(z), port


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_references_2x2_step(runs, arch, b):
    ref, port = runs
    key = f"{arch}/{b}/prefill"
    _close(port[f"{key}/out"], ref[f"{key}/out"], f"{key} output")
    want = sorted(k for k in ref if k.startswith(f"{key}/cache/"))
    assert want == sorted(k for k in port if k.startswith(f"{key}/cache/"))
    assert bool(want) != (arch == "whisper-small")  # the encoder: no cache
    for k in want:
        _close(port[k], ref[k], k)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_references_2x2_steps(runs, arch, b):
    ref, port = runs
    key = f"{arch}/{b}"
    for i in range(STEPS):
        _close(port[f"{key}/ref/logits/{i}"], ref[f"{key}/decode/logits/{i}"],
               f"{key} step {i}")
    want = sorted(k[len(f"{key}/decode/cache/"):] for k in ref
                  if k.startswith(f"{key}/decode/cache/"))
    got = sorted(k[len(f"{key}/ref/cache/"):] for k in port
                 if k.startswith(f"{key}/ref/cache/"))
    assert want == got
    for p in want:
        _close(port[f"{key}/ref/cache/{p}"], ref[f"{key}/decode/cache/{p}"],
               f"{key} cache {p}")
    # every step wrote: the written slots differ from the drawn cache
    k_in = ref.get(f"{key}/decode/cache_in/pos0/k",
                   ref.get(f"{key}/decode/cache_in/pos1/k"))
    if k_in is not None:
        name = "pos0/k" if f"{key}/decode/cache_in/pos0/k" in ref \
            else "pos1/k"
        after = port[f"{key}/ref/cache/{name}"]
        changed = sorted({int(s) for s in np.nonzero(
            np.abs(after - k_in).max(axis=(0, 1, 3, 4)) > 0)[0]})
        assert changed == [0, 14, 15]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_equals_one_device_over_the_whole_cache(runs, arch,
                                                               b):
    _, port = runs
    tag = "one" if f"{arch}/{b}/one/logits/0" in port else "ref"
    for i in range(STEPS):
        _close(port[f"{arch}/{b}/{tag}/logits/{i}"],
               port[f"{arch}/{b}/{tag}/one_logits/{i}"],
               f"{arch}/{b} step {i}")


# ------------------------------------------------------------ spec parity


@pytest.mark.parametrize("multi", (False, True), ids=("single", "multi"))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_match_the_reference(arch, multi):
    """``cache_shardings`` of every arch's decode cache at each decode
    shape, on the production rules, equal to the reference's (over an
    abstract mesh of the production shape)."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs.base import SHAPES as RSHAPES
    from repro.configs.base import get_config as ref_config
    from repro.launch import steps as RST
    from repro.models.registry import build_model as ref_build
    from repro.parallel.sharding import AxisRules as RAxisRules
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import cache_shardings
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import AxisRules, path_str
    from repro_torch.tree import leaves_with_paths

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi \
        else AbstractMesh((16, 16), ("data", "model"))
    rrules, prules = RAxisRules.default(multi), AxisRules.default(multi)
    rmodel, model = ref_build(ref_config(arch)), build_model(get_config(arch))
    for name in ("decode_32k", "long_500k"):
        rs, ps = RSHAPES[name], SHAPES[name]
        rc = jax.eval_shape(lambda: rmodel.init_cache(rs.global_batch,
                                                      rs.seq_len))
        want = [(RST.path_str(p), tuple(s.spec)) for p, s in
                jax.tree_util.tree_flatten_with_path(RST.cache_shardings(
                    mesh, rc, rmodel.cfg, rrules, rs.global_batch))[0]]
        pc = model.init_cache(ps.global_batch, ps.seq_len, "meta")
        got = [(path_str(p), tuple(s)) for p, s in leaves_with_paths(
            cache_shardings(pc, model.cfg, prules, ps.global_batch))]
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch", LM_ARCHS + ("jpeg-resnet",))
def test_skips_and_sub_quadratic_match_the_reference(arch):
    from repro.configs.base import SHAPES as RSHAPES
    from repro.configs.base import get_config as ref_config
    from repro.models import registry as RR
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import registry as PR

    rcfg, cfg = ref_config(arch), get_config(arch)
    assert cfg.sub_quadratic() == rcfg.sub_quadratic()
    assert list(SHAPES) == list(RSHAPES)
    for name in SHAPES:
        assert PR.cell_is_skipped(cfg, SHAPES[name]) \
            == RR.cell_is_skipped(rcfg, RSHAPES[name]), name
        assert PR.decode_lengths(cfg, SHAPES[name]) \
            == RR.decode_lengths(rcfg, RSHAPES[name])


if __name__ == "__main__" and sys.argv[1:2] == ["oracle"]:
    oracle(sys.argv[2])
