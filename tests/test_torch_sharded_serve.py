"""The port's prefill and decode steps on a 2×2 (data × model) mesh
against the reference's own 2×2 steps and against one device, on the CPU,
and the cache spec trees against the reference's.

The reference runs in one subprocess with four forced host devices
(``launch.steps.build_prefill_step`` / ``build_decode_step`` jitted with
their shardings on ``make_test_mesh(2, 2)``); the port runs the same
steps on four gloo ranks spawned by ``launch.mesh.run_local``.  Both take
the same numpy-drawn parameters, prompts, decode caches and tokens, for
reduced ``smollm-360m`` (3/1 heads: attention's weights gathered in
prefill, the token's columns in decode), ``mixtral-8x7b``
(a 64-slot window, MoE), ``jamba-v0.1-52b`` (Mamba states cut along
``d_inner``, attention and MoE), ``rwkv6-7b`` (``wkv`` cut by head) and
``whisper-small`` (a cross cache; its prefill is the encoder), each at
batch 2 (the cache's slots over ``model``) and batch 1 (over both axes).
Decode starts at index ``INDEX`` of a ``T``-slot cache and takes
``STEPS`` steps: ring slots 14, 15 and 0, so each step writes on one
rank's slots only, the last one after a wrap, on another rank than the
first two.

The same four ranks also run a data 1 × model 4 layout, prefill then
decode, against the reference's steps compiled on a 1 × 4 mesh of its
four devices and against one device, for ``WIDE_ARCHS``
(``wide_config``: the MoE at a capacity factor of 8 on both sides): reduced ``mixtral-8x7b``
(4/2 heads: each rank's query head reads a key/value head whose columns
two ranks hold, moved to it by an all-to-all), ``smollm-360m`` (3/1
heads: the prefill gathers the attention weights, a decode step the
token's query, key and value columns) and ``whisper-small`` with 6 heads
of 16 (``WIDE_WHISPER_HEADS``, which 4 ranks do not divide: its encoder
prefill gathers the attention weights, its decode gathers the token's
columns for self- and cross-attention alike).

On a fake 1 × 2 world a Mamba or RWKV decode step steps only the rank's
slice of its states: half the whole step's state-update work, and no
state- or weight-sized collective.

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
#: the archs also run on data 1 × model 4 against one device
WIDE_ARCHS = ("mixtral-8x7b", "smollm-360m", "whisper-small")
WIDE_WHISPER_HEADS = 6
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
    res.update(_wide_oracle())
    np.savez(out_path, **res)


def _wide_oracle() -> dict:
    """The reference's prefill and decode of ``WIDE_ARCHS`` on data 1 ×
    model 4 at batch 2 (keys as :func:`_wide_runs`'s, the drawn decode
    cache under ``cache_in``)."""
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

    mesh = make_test_mesh(1, 4)
    rules = AxisRules.default(False, data=1, model=4).with_mesh(mesh)
    res, b = {}, 2
    for arch in WIDE_ARCHS:
        cfg = wide_config(reduced_config(arch))
        model = build_model(cfg)
        key = f"{arch}/1x4"
        run = RunConfig(model=cfg, shape=ShapeConfig("p", S, b, "prefill"),
                        mesh=MeshConfig(data=1, model=4))
        with mesh, sharding_rules(rules):
            step, sh, pshape, _ = build_prefill_step(model, run, mesh, rules)
            params = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(pshape),
                [jnp.asarray(a) for a in draw(
                    [(p, leaf.shape) for p, leaf in flat(pshape)])])
            out, cache = jax.jit(step, in_shardings=sh)(
                params, {k: jnp.asarray(v) for k, v in
                         prompt(cfg, b).items()})
        res[f"{key}/prefill/out"] = np.asarray(out)
        for p, leaf in flat(cache or {}):
            res[f"{key}/prefill/cache/{p}"] = np.asarray(leaf)
        run = dataclasses.replace(run, shape=ShapeConfig("d", T, b,
                                                         "decode"))
        with mesh, sharding_rules(rules):
            step, sh, (_, cshape, _) = build_decode_step(model, run, mesh,
                                                         rules)
            drawn = draw_cache([(p, leaf.shape) for p, leaf in flat(cshape)])
            for p, a in drawn.items():
                res[f"{key}/cache_in/{p}"] = a
            cache = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(cshape),
                [jnp.asarray(drawn[p]) for p, _ in flat(cshape)])
            jitted = jax.jit(step, in_shardings=sh,
                             out_shardings=(None, sh[1]))
            for i, t in enumerate(tokens(cfg, b)):
                logits, cache = jitted(params, cache,
                                       {"tokens": jnp.asarray(t)})
                res[f"{key}/logits/{i}"] = np.asarray(logits)
        for p, leaf in flat(cache):
            res[f"{key}/cache/{p}"] = np.asarray(leaf)
    return res


# --------------------------------------------------------------- the port


def wide_config(cfg):
    """``cfg`` (the reference's or the port's reduced config) as the data
    1 × model 4 runs take it: an MoE's capacity factor 8, so no token is
    dropped; whisper with ``WIDE_WHISPER_HEADS`` heads."""
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    if cfg.encoder_decoder:
        cfg = dataclasses.replace(cfg, n_heads=WIDE_WHISPER_HEADS,
                                  n_kv_heads=WIDE_WHISPER_HEADS)
    return cfg


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
    res.update(_wide_runs(ref))
    return res if dist.get_rank() == 0 else None


def _wide_runs(ref: dict) -> dict:
    """``WIDE_ARCHS`` on a data 1 × model 4 mesh of the same four ranks at
    batch 2: the prefill's output and cache gathered whole, and each
    decode step's logits and the cache after them from the reference's
    drawn cache (in ``ref``), beside one device's run of the same steps
    on the whole parameters and cache."""
    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     reduced_config)
    from repro_torch.launch.mesh import make_axis_rules, make_mesh
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          cache_shardings)
    from repro_torch.models.registry import build_model, param_shapes
    from repro_torch.parallel.sharding import gather_full, path_str
    from repro_torch.tree import leaves_with_paths, tree_map

    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    mc = MeshConfig(data=1, model=4)
    rules = make_axis_rules(mc)
    res, b = {}, 2

    def whole(tree, specs):
        return {path_str(p): x for p, x in leaves_with_paths(
            tree_map(lambda x, s: gather_full(x, s, mesh), tree, specs))}

    for arch in WIDE_ARCHS:
        cfg = wide_config(reduced_config(arch))
        model = build_model(cfg)
        pshape = param_shapes(model)
        it = iter(draw([(path_str(p), tuple(x.shape))
                        for p, x in leaves_with_paths(pshape)]))
        full = tree_map(lambda _: torch.from_numpy(next(it)), pshape)
        batch = {k: torch.from_numpy(v) for k, v in prompt(cfg, b).items()}
        run = RunConfig(model=cfg, shape=ShapeConfig("p", S, b, "prefill"),
                        mesh=mc)
        pb = build_prefill_step(model, run, mesh, rules)
        with torch.no_grad():
            out, cache = pb.step_fn(pb.init_fns[0](full), batch)
            one_out, one_cache = model.prefill(full, batch)
        key = f"{arch}/1x4"
        res[f"{key}/prefill/out"], res[f"{key}/prefill/one"] = out, one_out
        if cache is not None:  # whisper's prefill is its encoder
            specs = cache_shardings(model.init_cache(b, S, "meta"), cfg,
                                    rules, b)
            for p, x in whole(cache, specs).items():
                res[f"{key}/prefill/cache/{p}"] = x
            for p, x in leaves_with_paths(one_cache):
                res[f"{key}/prefill/one_cache/{path_str(p)}"] = x
        run = RunConfig(model=cfg, shape=ShapeConfig("d", T, b, "decode"),
                        mesh=mc)
        db = build_decode_step(model, run, mesh, rules)
        params = db.init_fns[0](full)
        drawn = {p[len(f"{key}/cache_in/"):]: v for p, v in ref.items()
                 if p.startswith(f"{key}/cache_in/")}
        cache = db.init_fns[1](_fill(db.cache_shape, drawn))
        one = _fill(db.cache_shape, drawn)
        with torch.no_grad():
            for i, t in enumerate(tokens(cfg, b)):
                t = torch.from_numpy(t)
                res[f"{key}/logits/{i}"], cache = db.step_fn(
                    params, cache, {"tokens": t})
                res[f"{key}/one_logits/{i}"], one = model.decode_step(
                    full, one, {"tokens": t})
        for p, x in whole(cache, db.in_shardings[1]).items():
            res[f"{key}/cache/{p}"] = x
        for p, x in leaves_with_paths(one):
            res[f"{key}/one_cache/{path_str(p)}"] = x
    return res


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


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_a_1x4_prefill_equals_one_device(runs, arch):
    """Data 1 × model 4, batch 2: the prefill's last logits (whisper's
    encoder output) and every cache leaf, gathered whole, against one
    device's prefill."""
    _, port = runs
    key = f"{arch}/1x4/prefill"
    _close(port[f"{key}/out"], port[f"{key}/one"], f"{key} output")
    want = sorted(k[len(f"{key}/one_cache/"):] for k in port
                  if k.startswith(f"{key}/one_cache/"))
    assert bool(want) != (arch == "whisper-small")  # the encoder: no cache
    assert want == sorted(k[len(f"{key}/cache/"):] for k in port
                          if k.startswith(f"{key}/cache/"))
    for p in want:
        _close(port[f"{key}/cache/{p}"], port[f"{key}/one_cache/{p}"],
               f"{key} cache {p}")


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_a_1x4_decode_equals_one_device(runs, arch):
    """Data 1 × model 4, batch 2, from a drawn cache at index INDEX: each
    step's logits and the cache after STEPS steps, gathered whole,
    against one device's steps over the whole cache."""
    _, port = runs
    key = f"{arch}/1x4"
    for i in range(STEPS):
        _close(port[f"{key}/logits/{i}"], port[f"{key}/one_logits/{i}"],
               f"{key} step {i}")
    want = sorted(k[len(f"{key}/one_cache/"):] for k in port
                  if k.startswith(f"{key}/one_cache/"))
    assert want
    for p in want:
        _close(port[f"{key}/cache/{p}"], port[f"{key}/one_cache/{p}"],
               f"{key} cache {p}")


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_a_1x4_prefill_matches_the_references_1x4_step(runs, arch):
    """Data 1 × model 4, batch 2: the port's prefill output (whisper's
    encoder output) and every cache leaf, gathered whole, against the
    reference's prefill compiled on the same mesh."""
    ref, port = runs
    key = f"{arch}/1x4/prefill"
    _close(port[f"{key}/out"], ref[f"{key}/out"], f"{key} output")
    want = sorted(k for k in ref if k.startswith(f"{key}/cache/"))
    assert bool(want) != (arch == "whisper-small")  # the encoder: no cache
    assert want == sorted(k for k in port if k.startswith(f"{key}/cache/"))
    for k in want:
        _close(port[k], ref[k], k)


@pytest.mark.parametrize("arch", WIDE_ARCHS)
def test_a_1x4_decode_matches_the_references_1x4_steps(runs, arch):
    """Data 1 × model 4, batch 2, from the reference's drawn cache at
    index INDEX: the port's logits of each step and its cache after STEPS
    steps, gathered whole, against the reference's decode step compiled
    on the same mesh."""
    ref, port = runs
    key = f"{arch}/1x4"
    for i in range(STEPS):
        _close(port[f"{key}/logits/{i}"], ref[f"{key}/logits/{i}"],
               f"{key} step {i}")
    want = sorted(k for k in ref if k.startswith(f"{key}/cache/"))
    assert want
    assert want == sorted(k for k in port if k.startswith(f"{key}/cache/"))
    for k in want:
        _close(port[k], ref[k], k)


# ------------------------------------------------- the slice's own work

#: the mixer code of a decode step: a collective called from one of these
#: (or from ``gather_tree``/``_slice_tree`` on a mixer's leaves) is the
#: Mamba or RWKV layer's own traffic
MIXER_FNS = ("mamba_decode_step", "rwkv_time_mix_decode",
             "rwkv_channel_mix_decode", "_mamba_xz", "_whole_states")
MIXER_LEAVES = ("/mamba", "/tm", "/cm")


def _mixer_frame() -> bool:
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_name
        if name in MIXER_FNS:
            return True
        if name in ("gather_tree", "_slice_tree") and str(
                frame.f_locals.get("prefix", "")).endswith(MIXER_LEAVES):
            return True
        frame = frame.f_back
    return False


def _decode_work(cfg, model_axis: int, monkeypatch) -> tuple[dict, list]:
    """One decode step at batch 2 on rank 0 of a fake 1 × ``model_axis``
    world → (the state steps' FLOPs and transcendentals, summed over
    Mamba's ``_ssm_step`` and RWKV's ``_wkv_step`` calls; each collective
    the mixers call, as (kind, payload bytes))."""
    from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.introspect import opcount
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import mamba as M
    from repro_torch.models import rwkv as RW
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import collectives as C

    scan = {"flops": 0.0, "transcendentals": 0.0}
    calls = []

    def counted(fn):
        def run(*args):
            with opcount.count() as cost:
                out = fn(*args)
            scan["flops"] += cost.flops
            scan["transcendentals"] += cost.transcendentals
            return out
        return run

    report = C._report

    def recording(kind, payload, n, factor=1.0):
        if _mixer_frame():
            calls.append((kind, factor * payload.numel()
                          * payload.element_size()))
        return report(kind, payload, n, factor)

    mc = MeshConfig(data=1, model=model_axis)
    run = RunConfig(model=cfg, shape=ShapeConfig("d", T, 2, "decode"),
                    mesh=mc)
    with monkeypatch.context() as patch, dryrun.fake_world(model_axis):
        patch.setattr(M, "_ssm_step", counted(M._ssm_step))
        patch.setattr(RW, "_wkv_step", counted(RW._wkv_step))
        patch.setattr(C, "_report", recording)
        dryrun.trace_step(build_model(cfg), run,
                          make_mesh_from_config(mc, "cpu"),
                          dryrun.axis_rules(mc))
    return scan, calls


@pytest.mark.parametrize("arch", ("jamba-v0.1-52b", "rwkv6-7b"))
def test_mesh_decode_steps_only_the_ranks_state_slice(arch, monkeypatch):
    """A decode step of reduced ``jamba-v0.1-52b`` (``d_inner`` 128,
    ``d_state`` 8) or ``rwkv6-7b`` (4 heads of 16) at batch 2 on rank 0 of
    a fake 1 × 2 world, against a world of one: the state steps' FLOPs and
    transcendentals are half of the whole step's, exactly, and no
    collective of a Mamba or RWKV layer moves as much as one layer's state
    (``ssm`` or ``wkv``, 8,192 bytes): no state and no weight is gathered,
    only a token's activations and partial products."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    whole, _ = _decode_work(cfg, 1, monkeypatch)
    rank, calls = _decode_work(cfg, 2, monkeypatch)
    assert whole["flops"] > 0
    assert 2 * rank["flops"] == whole["flops"]
    assert 2 * rank["transcendentals"] == whole["transcendentals"]
    if arch == "rwkv6-7b":
        state = 2 * (cfg.d_model // cfg.rwkv_head_size) \
            * cfg.rwkv_head_size ** 2 * 4
    else:
        state = 2 * cfg.expand * cfg.d_model * cfg.d_state * 4
    assert state == 8192
    assert calls and max(b for _, b in calls) < state, calls


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
