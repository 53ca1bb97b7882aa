"""The model axis moves activations, never whole weights: the port's
training, prefill and decode steps on data 1 × model 4 against the
reference's compiled steps, on the CPU.

The reference runs in one subprocess with four forced host devices: each
cell's step (``launch/steps.py``) of reduced ``jamba-v0.1-52b``,
``mixtral-8x7b``, ``smollm-360m``, ``whisper-small`` and
``granite-moe-3b-a800m`` over ``B`` × ``S`` tokens (sizes no weight has,
so a gathered weight shows by its shape), lowered and compiled; its
per-device FLOPs and collectives (``launch/hlo_analysis.py``) and the
shape of each array its forward all-gathers.  The port traces rank 0 of
the same step on a fake world of four ranks (``launch/dryrun.py``), and a
recorder around ``transformer.gather_tree`` keeps every leaf that comes
out of it in another shape than it went in.  At each cell:

* (a) no leaf the port gathers whole is one whose shape the reference's
  forward does not gather.  The one exception is named in ROADMAP's
  "Different on purpose": reduced ``smollm-360m``'s 3/1 heads over 4 in
  training and prefill (``WEIGHTS_ON_PURPOSE``), where the port gathers
  the attention weights and the reference the activations; at
  ``smollm-360m × train_4k`` the activations would move 3.4 times the
  weights' bytes (``tools/uneven_heads.py``).  There the tool's layout,
  the reference's, is held to (a) and (b) instead, and its training step
  against the port's layout's on four gloo ranks (reduced smollm and
  whisper at 6 heads);
* (b) the port's collective bytes are at most ``BYTES_FACTOR`` times the
  reference's (printed beside them);
* (c) for ``whisper-small`` and ``mixtral-8x7b`` training, the port's
  per-rank FLOPs on 1 × 4 over those on 1 × 1 are within ``CUT_RTOL`` of
  the same ratio of the reference's.

No cell of these is one the reference's dry-run skips (it skips only
``long_500k`` of full attention and the JPEG model's serving).  Beside
them, the vocab-cut lookup on four gloo ranks against a whole-table
lookup, values and gradients exactly.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

ARCHS = ("jamba-v0.1-52b", "mixtral-8x7b", "smollm-360m", "whisper-small",
         "granite-moe-3b-a800m")
KINDS = ("train", "prefill", "decode")
#: the cells whose FLOPs ratio from model 1 to 4 is held
RATIO_ARCHS = ("whisper-small", "mixtral-8x7b")
B, S, MODEL = 3, 64, 4
CUT_RTOL, BYTES_FACTOR = 0.10, 2.0
#: the cells where the port gathers attention weights on purpose
WEIGHTS_ON_PURPOSE = {("smollm-360m", "train"), ("smollm-360m", "prefill")}


# ------------------------------------------------------------- the oracle


#: an all-gather in optimized HLO text: its result's shapes, its op name
_ALL_GATHER = re.compile(r"=\s*(\(.*?\)|\S+)\s+all-gather(?:-start)?\(.*?"
                         r"op_name=\"([^\"]*)\"")


def _forward_gathers(hlo: str) -> list[list[int]]:
    """The shape of each array an all-gather of the forward returns (not
    of the backward: XLA names its ops ``transpose(jvp(...))``)."""
    out = []
    for line in hlo.splitlines():
        m = _ALL_GATHER.search(line)
        if m and "transpose(" not in m.group(2):
            out += [[int(d) for d in dims.split(",") if d] for dims in
                    re.findall(r"\w+\[([\d,]*)\]", m.group(1))]
    return out


def _reference_cell(arch: str, kind: str, model_axis: int) -> dict:
    """The reference's step of reduced ``arch`` over ``B`` × ``S`` tokens
    compiled on data 1 × ``model_axis``: its per-device FLOPs, its
    collective bytes and ops, and the shapes its forward all-gathers."""
    import jax
    from jax.sharding import AxisType, Mesh
    from repro.configs.base import (MeshConfig, RunConfig, ShapeConfig,
                                    TrainConfig, reduced_config)
    from repro.launch import hlo_analysis
    from repro.launch.steps import (build_decode_step, build_prefill_step,
                                    build_train_step)
    from repro.models.registry import build_model, input_specs
    from repro.parallel.sharding import AxisRules, sharding_rules

    mesh = Mesh(np.array(jax.devices()[:model_axis]).reshape(1, model_axis),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = AxisRules.default(False, data=1, model=model_axis
                              ).with_mesh(mesh)
    cfg = reduced_config(arch)
    model = build_model(cfg, remat="full")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, kind),
                    train=TrainConfig(grad_accum=1, remat="full"),
                    mesh=MeshConfig(data=1, model=model_axis))
    with mesh, sharding_rules(rules):
        if kind == "train":
            b = build_train_step(model, run, mesh, rules)
            lowered = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                              out_shardings=b.out_shardings).lower(
                b.params_shape, b.opt_shape,
                input_specs(cfg, run.shape, dryrun=True))
        elif kind == "prefill":
            step, shardings, params, batch = build_prefill_step(
                model, run, mesh, rules)
            lowered = jax.jit(step, in_shardings=shardings).lower(params,
                                                                   batch)
        else:
            step, shardings, shapes = build_decode_step(model, run, mesh,
                                                        rules)
            lowered = jax.jit(step, in_shardings=shardings).lower(*shapes)
        hlo = lowered.compile().as_text()
    cost = hlo_analysis.analyze_hlo(hlo, model_axis).to_json()
    return {"flops": cost["flops"], "collective_bytes":
            cost["collective_bytes"], "collectives": cost["collective_ops"],
            "gathered": _forward_gathers(hlo)}


def oracle(out_path: str) -> None:
    """The reference's cells → ``out_path`` (json): every arch and kind
    on 1 × ``MODEL``, and the ``RATIO_ARCHS``' training on 1 × 1."""
    out = {}
    for arch in ARCHS:
        for kind in KINDS:
            out[f"{arch}/{kind}/{MODEL}"] = _reference_cell(arch, kind,
                                                            MODEL)
    for arch in RATIO_ARCHS:
        out[f"{arch}/train/1"] = _reference_cell(arch, "train", 1)
    with open(out_path, "w") as f:
        json.dump(out, f)


# --------------------------------------------------------------- the port


def _gathered_leaves(monkeypatch) -> list:
    """Patch ``transformer.gather_tree`` to record each leaf that comes
    out of it in another shape than it went in, as (path, its whole shape:
    one layer's of a stacked leaf)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves_with_paths

    seen = []
    gather = T.gather_tree

    def recording(tree, prefix="", **kw):
        out = gather(tree, prefix, **kw)
        seen.extend((f"{prefix}/{path}", tuple(w.shape))
                    for (path, t), (_, w) in zip(leaves_with_paths(tree),
                                                 leaves_with_paths(out))
                    if w.shape != t.shape)
        return out

    monkeypatch.setattr(T, "gather_tree", recording)
    return seen


def _port_cell(arch: str, kind: str, model_axis: int) -> dict:
    """Rank 0 of the port's step of reduced ``arch`` over ``B`` × ``S``
    tokens on a fake world of data 1 × ``model_axis`` → its cost record
    (``introspect/opcount.py``)."""
    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig, reduced_config)
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models.registry import build_model

    cfg = reduced_config(arch)
    mc = MeshConfig(data=1, model=model_axis)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, kind),
                    train=TrainConfig(grad_accum=1, remat="full"), mesh=mc)
    model = build_model(cfg, remat="full",
                        dispatch=DispatchConfig(path="reference"))
    with dryrun.fake_world(model_axis):
        return dryrun.trace_step(model, run, make_mesh_from_config(mc, "cpu"),
                                 dryrun.axis_rules(mc))[1]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("model_axis_oracle") / "ref.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={MODEL}")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "oracle", out], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    with open(out) as f:
        return json.load(f)


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_axis_moves_what_the_references_moves(reference, arch,
                                                        kind, monkeypatch):
    """(a) every leaf the port gathers whole on 1 × 4 has a shape the
    reference's forward all-gathers, but for the cells of
    ``WEIGHTS_ON_PURPOSE``, where only attention weights are gathered;
    (b) the port's collective bytes are at most ``BYTES_FACTOR`` times
    the reference's."""
    ref = reference[f"{arch}/{kind}/{MODEL}"]
    gathered = _gathered_leaves(monkeypatch)
    cost = _port_cell(arch, kind, MODEL)
    got, want = cost["collective_bytes"], ref["collective_bytes"]
    print(f"{arch} {kind} 1x{MODEL}: port {got:.0f} B, reference "
          f"{want:.0f} B of collectives; gathered {gathered}")
    if (arch, kind) in WEIGHTS_ON_PURPOSE:
        assert gathered and all("/attn/" in p for p, _ in gathered), \
            gathered
    else:
        assert all(list(sh) in ref["gathered"] for _, sh in gathered), \
            (gathered, ref["gathered"])
    assert 0 < got <= BYTES_FACTOR * want, (got, want)


@pytest.mark.parametrize("arch", RATIO_ARCHS)
def test_a_training_step_cuts_its_work_as_the_references(reference, arch):
    """(c) the port's per-rank FLOPs of a training step on 1 × 4 over
    those on 1 × 1 are within ``CUT_RTOL`` of the reference's ratio."""
    want = reference[f"{arch}/train/{MODEL}"]["flops"] \
        / reference[f"{arch}/train/1"]["flops"]
    got = _port_cell(arch, "train", MODEL)["flops"] \
        / _port_cell(arch, "train", 1)["flops"]
    print(f"{arch} train: port {got:.4f}, reference {want:.4f}")
    assert abs(got / want - 1) <= CUT_RTOL, (got, want)


#: the vocab-cut lookup's table: VOCAB true rows padded to 512, D wide, cut
#: over model 4 (128 rows a rank)
VOCAB, PADDED, D = 500, 512, 8


def _lookup_rank(mesh):
    """On each rank of data 1 × model 4: ``transformer._lookup`` of tokens
    on every rank's first and last rows and in the padded rows, from the
    rank's rows of the table → (its output, its rows' gradient of
    ``(out · g).sum()``)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import (AxisRules, P, local_slice,
                                               sharding_rules)

    gen = torch.Generator().manual_seed(0)
    table = torch.randn(PADDED, D, generator=gen)
    tokens, g = _lookup_inputs()
    spec = P("model", None)
    rows = local_slice(table, spec, mesh).requires_grad_(True)
    rules = AxisRules(rules={"batch": ("data",), "model": ("model",)},
                      mesh_shape={"data": 1, "model": MODEL}, mesh=mesh,
                      specs={"embed": spec})
    with sharding_rules(rules):
        out = T._lookup({"embed": rows}, tokens)
    (out * g).sum().backward()
    return out.detach(), rows.grad


def _lookup_inputs():
    import torch

    per = PADDED // MODEL
    edges = [r * per + o for r in range(MODEL) for o in (0, per - 1)]
    tokens = torch.tensor([edges, [VOCAB, VOCAB + 5, 3, 3, 200, 130, 7, 511]])
    g = torch.randn(tokens.shape + (D,),
                    generator=torch.Generator().manual_seed(1))
    return tokens, g


def test_the_vocab_cut_lookup_is_the_whole_tables():
    """Tokens on each rank's first and last row and in the padded rows:
    every rank's output equals the whole table's lookup, and the
    gradient of each rank's rows is the whole table's gradient there (a
    row looked up twice gets both), so nothing lands outside the rank's
    rows."""
    import torch

    from repro_torch.launch.mesh import run_local

    table = torch.randn(PADDED, D,
                        generator=torch.Generator().manual_seed(0))
    table.requires_grad_(True)
    tokens, g = _lookup_inputs()
    want = table[tokens]
    (want * g).sum().backward()
    ranks = run_local(_lookup_rank, (1, MODEL), ("data", "model"),
                      backend="gloo", device="cpu")
    per = PADDED // MODEL
    for r, (out, grad) in enumerate(ranks):
        np.testing.assert_array_equal(out, want.detach().numpy())
        np.testing.assert_array_equal(
            grad, table.grad[r * per:(r + 1) * per].numpy())
    assert (table.grad[VOCAB + 5] != 0).all()  # a padded row looked up


# ------------------------------------ the two layouts of uneven query heads

#: ``tools/uneven_heads.py``'s layout of attention whose query heads
#: ``model`` does not divide (the reference's: activations gathered) is
#: held against the port's (weights gathered) on these configs: reduced
#: ``smollm-360m`` (3/1 heads) and ``whisper-small`` at 6 heads (its
#: cross-attention too), one training step on data 1 × 4
LAYOUT_CONFIGS = ("smollm-360m", "whisper-small")
LAYOUT_RTOL = 1e-5


def _activation_layout():
    """``tools/uneven_heads.py``'s ``activation_layout``."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import uneven_heads
    finally:
        sys.path.pop(0)
    return uneven_heads.activation_layout()


def _layout_config(arch: str):
    import dataclasses

    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    return dataclasses.replace(cfg, n_heads=6, n_kv_heads=6) \
        if cfg.encoder_decoder else cfg


def _layouts_rank(mesh):
    """On each rank of data 1 × ``MODEL``: one training step of each of
    ``LAYOUT_CONFIGS`` in the port's layout and in the activation layout,
    from the same drawn parameters and batch → on rank 0 each run's loss
    and its parameters after the step, gathered whole."""
    import contextlib

    import torch

    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig)
    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import gather_full, path_str
    from repro_torch.tree import leaves_with_paths, tree_map

    mc = MeshConfig(data=1, model=MODEL)
    res = {}
    for arch in LAYOUT_CONFIGS:
        cfg = _layout_config(arch)
        rng = np.random.default_rng(0)
        t = rng.integers(0, cfg.vocab_size, (B, S + 1))
        batch = {"tokens": torch.from_numpy(t[:, :S]).int(),
                 "labels": torch.from_numpy(t[:, 1:]).int()}
        if cfg.encoder_decoder:
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder_context_len, cfg.d_model)).astype(
                    np.float32))
        for name, layout in (("weights", contextlib.nullcontext),
                             ("activations", _activation_layout)):
            run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                            train=TrainConfig(grad_accum=1, zero1=False,
                                              schedule="constant"),
                            mesh=mc)
            with layout():
                b = build_train_step(build_model(cfg), run, mesh,
                                     make_axis_rules(mc))
                gen = torch.Generator().manual_seed(0)
                full = tree_map(lambda x: 0.3 * torch.randn(
                    x.shape, generator=gen), b.params_shape)
                params = b.init_fns[0](full)
                params, _, metrics = b.step_fn(
                    params, b.init_fns[1](params), batch)
            full = tree_map(lambda x, sp: gather_full(x, sp, mesh), params,
                            b.in_shardings[0])
            res[f"{arch}/{name}/loss"] = float(metrics["loss"])
            for p, leaf in leaves_with_paths(full):
                res[f"{arch}/{name}/{path_str(p)}"] = leaf.numpy()
    return res if torch.distributed.get_rank() == 0 else None


@pytest.fixture(scope="module")
def layouts():
    from repro_torch.launch.mesh import run_local

    return run_local(_layouts_rank, (1, MODEL), ("data", "model"),
                     backend="gloo", device="cpu")[0]


@pytest.mark.parametrize("arch", LAYOUT_CONFIGS)
def test_the_activation_layout_computes_the_ports_function(layouts, arch):
    """The activation layout is a copy of the port's attention in another
    layout: its loss and every parameter after one step equal the port's
    own layout's within ``LAYOUT_RTOL`` of the largest |value|, so the
    copy fails here when the port's attention changes what it computes."""
    keys = sorted(k[len(f"{arch}/weights/"):] for k in layouts
                  if k.startswith(f"{arch}/weights/"))
    assert "loss" in keys and len(keys) > 10
    for k in keys:
        got = np.asarray(layouts[f"{arch}/activations/{k}"])
        want = np.asarray(layouts[f"{arch}/weights/{k}"])
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= LAYOUT_RTOL * scale, k


@pytest.mark.parametrize("kind", sorted(k for _, k in WEIGHTS_ON_PURPOSE))
def test_the_activation_layout_moves_what_the_references_moves(
        reference, kind, monkeypatch):
    """At the cells the port gathers attention weights on purpose, the
    activation layout is the reference's: it gathers no weight whose
    shape the reference's forward does not gather, and its collective
    bytes are within ``BYTES_FACTOR`` of the reference's."""
    arch = next(a for a, k in WEIGHTS_ON_PURPOSE if k == kind)
    ref = reference[f"{arch}/{kind}/{MODEL}"]
    gathered = _gathered_leaves(monkeypatch)
    with _activation_layout():
        cost = _port_cell(arch, kind, MODEL)
    got, want = cost["collective_bytes"], ref["collective_bytes"]
    print(f"{arch} {kind} 1x{MODEL}, the activation layout: port {got:.0f}"
          f" B, reference {want:.0f} B; gathered {gathered}")
    assert all(list(sh) in ref["gathered"] for _, sh in gathered), \
        (gathered, ref["gathered"])
    assert 0 < got <= BYTES_FACTOR * want, (got, want)


if __name__ == "__main__" and sys.argv[1:2] == ["oracle"]:
    oracle(sys.argv[2])
