"""The port's dry-run (``launch/dryrun.py``) on the CPU: rank 0 of a
``fake`` process group traces its step on fake tensors.

* Per-rank argument bytes of a reduced ``smollm-360m`` training cell on a
  2×2 mesh equal the reference's ``compiled.memory_analysis()`` for the
  same cell on four forced host devices (one JAX subprocess), leaf by
  leaf.
* At a world of one the fake count (FLOPs, bytes, transcendentals) and
  the memory record equal the same step run for real on the CPU under the
  same counter and tracker, for training, prefill and decode (the plain
  attention on both sides: a real CPU tensor never takes a kernel).
* The backward is counted: a training step's FLOPs are its forward's
  ×3, ×4 with ``remat="full"`` (within 2 %), and kernel work added on
  another thread that carries the dispatch-mode stack (as the autograd
  engine's device threads do on CUDA) lands in the count.
* Rank 0's record equals the last rank's; the collective bytes of a
  hand-counted decode step follow the reference's payload rule.
* Each kernel wrapper's fake path returns its plain version's shapes and
  dtypes, adds its kernel's work and leaves ``launch_counts()`` as it
  was; a real CPU tensor takes the plain version, and leaves no fake
  tensor in the wrappers' caches.
* ``run_cell`` writes ``ok`` records for reduced cells of every family
  (attention head_dim 64, the kernel's), on one pod and two, and the
  reference's skip reasons; the command line; uneven cache slots raise.
* The model-axis cut of the Mamba and RWKV layers against the reference's
  compiled steps (reduced ``jamba-v0.1-52b`` and ``rwkv6-7b``, training
  and prefill, on data 1 × model 1 and 1 × 4): the port's per-rank FLOPs
  fall from one model rank to four as the reference's do (within 10 %),
  and no Mamba or RWKV weight the port gathers is one the reference's
  forward does not gather (it gathers none); a mesh prefill computes the
  rank's half of each scan on a fake 1 × 2 world and gathers no mixer
  leaf.
* The spread MoE step (reduced ``granite-moe-3b-a800m``, 4 microbatches
  of 2 rows on 2 (pod) × 2 × 1): the port's rank computes fewer FLOPs
  than the reference's device, its counting pass included.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

B, S, ACCUM = 8, 64, 2
MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "generated_code_bytes")
COST_KEYS = ("flops", "bytes", "flops_single", "bytes_single",
             "transcendentals", "collective_bytes", "collectives_by_group",
             "collective_ops", "warnings")


def smollm(ref: bool = False):
    """Reduced ``smollm-360m`` with the kernel's head_dim 64."""
    if ref:
        from repro.configs.base import reduced_config
    else:
        from repro_torch.configs import reduced_config
    return dataclasses.replace(reduced_config("smollm-360m"), head_dim=64)


# ------------------------------------------------------------- the oracle


#: the multi-pod training cell: 4 microbatches of 2 rows over 2 × 2 batch
#: ranks, fewer rows than ranks, as ``jamba-v0.1-52b``'s 16 rows over 2 × 16
POD_B, POD_ACCUM = 8, 4
#: (batch, microbatches) on a 2 (pod) × 4 × 1 mesh: a microbatch of 4 rows
#: over 8 batch ranks, one of 8 rows (a row a rank) and one of 16 (two)
SPREAD_CELLS = ((16, 4), (16, 2), (32, 2))


#: the model-axis cut's cells: reduced Mamba and RWKV models over batch
#: CUT_B of CUT_S tokens (sizes no weight has, so a gathered weight shows
#: by its shape), training and prefill, on data 1 × model 1 and 1 × 4
CUT_ARCHS, CUT_KINDS, CUT_MODEL = (("jamba-v0.1-52b", "rwkv6-7b"),
                                   ("train", "prefill"), (1, 4))
CUT_B, CUT_S, CUT_RTOL = 3, 64, 0.10
#: the spread MoE cell of ``tests/test_torch_sharded_train.py``'s
#: ``moe-spread`` run: reduced granite, 4 microbatches of 2 rows, 16 tokens,
#: on 2 (pod) × 2 × 1
MOE = "granite-moe-3b-a800m"
MOE_B, MOE_S, MOE_ACCUM = 8, 16, 4


def _reference_cell(pods: int, data: int, model_axis: int, batch: int,
                    accum: int, arch: str | None = None,
                    seq: int = S) -> dict:
    """The reference's training cell compiled on the first forced host
    devices: its argument and temp bytes (``memory_analysis``), each
    argument leaf's bytes on one device, the rows of the batch's shard and
    its per-device FLOPs (``launch/hlo_analysis.py``); reduced ``arch``
    instead of ``smollm-360m``."""
    import jax
    from jax.sharding import AxisType, Mesh
    from repro.configs.base import (MeshConfig, RunConfig, ShapeConfig,
                                    TrainConfig)
    from repro.configs.base import reduced_config
    from repro.launch import hlo_analysis
    from repro.launch.steps import build_train_step, path_str
    from repro.models.registry import build_model, input_specs
    from repro.parallel.sharding import AxisRules, sharding_rules

    shape, names = ((pods, data, model_axis), ("pod", "data", "model")) \
        if pods else ((data, model_axis), ("data", "model"))
    devices = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devices, names, axis_types=(AxisType.Auto,) * len(names))
    rules = AxisRules.default(bool(pods), pods=pods or 2, data=data,
                              model=model_axis).with_mesh(mesh)
    cfg = reduced_config(arch) if arch else smollm(ref=True)
    model = build_model(cfg, remat="full")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, batch, "train"),
                    train=TrainConfig(grad_accum=accum, remat="full"),
                    mesh=MeshConfig(multi_pod=bool(pods), pods=pods or 2,
                                    data=data, model=model_axis))
    with mesh, sharding_rules(rules):
        b = build_train_step(model, run, mesh, rules)
        host = input_specs(cfg, run.shape, dryrun=True)
        compiled = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings,
                           donate_argnums=(0, 1)).lower(
            b.params_shape, b.opt_shape, host).compile()
    leaves = {}
    for group, tree, shardings in zip(
            ("params", "opt", "batch"), (b.params_shape, b.opt_shape, host),
            b.in_shardings):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        for (path, leaf), sh in zip(flat, jax.tree.leaves(shardings)):
            shard = sh.shard_shape(leaf.shape)
            leaves[f"{group}/{path_str(path)}"] = int(
                np.prod(shard, dtype=np.int64) * leaf.dtype.itemsize)
    memory = compiled.memory_analysis()
    return {"argument_bytes": int(memory.argument_size_in_bytes),
            "temp_bytes": int(memory.temp_size_in_bytes), "leaves": leaves,
            "batch_rows": int(b.in_shardings[2]["tokens"].shard_shape(
                host["tokens"].shape)[0]),
            "flops": hlo_analysis.analyze_hlo(
                compiled.as_text(), int(np.prod(shape))).flops}


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


def _reference_cut_cell(arch: str, kind: str, model_axis: int) -> dict:
    """The reference's training or prefill step of reduced ``arch`` over
    ``CUT_B`` × ``CUT_S`` tokens, compiled on data 1 × ``model_axis``: its
    per-device FLOPs, its collectives (``launch/hlo_analysis.py``) and the
    shapes its forward all-gathers."""
    import jax
    from jax.sharding import AxisType, Mesh
    from repro.configs.base import (MeshConfig, RunConfig, ShapeConfig,
                                    TrainConfig, reduced_config)
    from repro.launch import hlo_analysis
    from repro.launch.steps import build_prefill_step, build_train_step
    from repro.models.registry import build_model, input_specs
    from repro.parallel.sharding import AxisRules, sharding_rules

    mesh = Mesh(np.array(jax.devices()[:model_axis]).reshape(1, model_axis),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = AxisRules.default(False, data=1, model=model_axis
                              ).with_mesh(mesh)
    cfg = reduced_config(arch)
    model = build_model(cfg, remat="full")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", CUT_S, CUT_B, kind),
                    train=TrainConfig(grad_accum=1, remat="full"),
                    mesh=MeshConfig(data=1, model=model_axis))
    with mesh, sharding_rules(rules):
        if kind == "train":
            b = build_train_step(model, run, mesh, rules)
            lowered = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                              out_shardings=b.out_shardings).lower(
                b.params_shape, b.opt_shape,
                input_specs(cfg, run.shape, dryrun=True))
        else:
            step, shardings, params, batch = build_prefill_step(
                model, run, mesh, rules)
            lowered = jax.jit(step, in_shardings=shardings).lower(params,
                                                                   batch)
        hlo = lowered.compile().as_text()
    cost = hlo_analysis.analyze_hlo(hlo, model_axis).to_json()
    return {"flops": cost["flops"], "collectives": cost["collective_ops"],
            "gathered": _forward_gathers(hlo)}


def oracle(out_path: str) -> None:
    """The reference's cells → ``out_path`` (json): the 2×2 one, the
    2 (pod) × 2 × 1 one of ``POD_ACCUM`` microbatches and the
    ``SPREAD_CELLS`` on 2 × 4 × 1 (eight forced host devices), the spread
    MoE cell, and the model-axis cut's cells."""
    out = {"grid": _reference_cell(0, 2, 2, B, ACCUM),
           "pods": _reference_cell(2, 2, 1, POD_B, POD_ACCUM),
           "moe-spread": _reference_cell(2, 2, 1, MOE_B, MOE_ACCUM, MOE,
                                         MOE_S)}
    for b, n in SPREAD_CELLS:
        out[f"spread/{b}/{n}"] = _reference_cell(2, 4, 1, b, n)
    for arch in CUT_ARCHS:
        for kind in CUT_KINDS:
            for m in CUT_MODEL:
                out[f"cut/{arch}/{kind}/{m}"] = _reference_cut_cell(
                    arch, kind, m)
    with open(out_path, "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------- helpers


def _run(kind: str, cfg=None, *, seq: int = S, batch: int = B,
         accum: int = ACCUM, remat: str = "full", data: int = 2,
         model_axis: int = 2, pods: int = 0, rank: int = 0,
         plain: bool = False, fake: bool = True):
    """``trace_step`` of one cell → (memory record, cost record): a fake
    world of (pods ×) data × model ranks (this one ``rank``), or a real
    gloo world of one when not ``fake``."""
    import torch.distributed as dist

    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig)
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import free_port, make_mesh_from_config
    from repro_torch.models.registry import build_model

    cfg = cfg or smollm()
    mc = _mesh_config(data, model_axis, pods)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, batch, kind),
                    train=TrainConfig(grad_accum=accum, remat=remat),
                    mesh=mc)
    model = build_model(cfg, remat=remat, dispatch=DispatchConfig(
        path="reference") if plain else None)
    rules = dryrun.axis_rules(mc)
    if fake:
        with dryrun.fake_world(data * model_axis * max(pods, 1), rank):
            return dryrun.trace_step(model, run,
                                     make_mesh_from_config(mc, "cpu"), rules)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        return dryrun.trace_step(model, run, make_mesh_from_config(mc, "cpu"),
                                 rules, fake=False)
    finally:
        dist.destroy_process_group()


def _mesh_config(data: int, model_axis: int, pods: int = 0):
    from repro_torch.configs import MeshConfig

    if pods:
        return MeshConfig(multi_pod=True, pods=pods, data=data,
                          model=model_axis)
    return MeshConfig(data=data, model=model_axis)


def _port_argument_leaves(pods: int = 0, data: int = 2, model_axis: int = 2,
                          batch: int = B, accum: int = ACCUM) -> dict:
    """Each argument leaf's bytes on rank 0 of the port's training cell
    (the 2×2 one by default), the optimizer state's paths named as the
    reference's (``.step`` / ``0``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import build_model, input_tensors
    from repro_torch.parallel.sharding import path_str
    from repro_torch.tree import leaves_with_paths

    cfg = smollm()
    mc = _mesh_config(data, model_axis, pods)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, batch, "train"),
                    train=TrainConfig(grad_accum=accum, remat="full"),
                    mesh=mc)
    model = build_model(cfg, remat="full")
    out = {}
    with dryrun.fake_world(data * model_axis * max(pods, 1)):
        b = build_train_step(model, run, make_mesh_from_config(mc, "cpu"),
                             dryrun.axis_rules(mc))
        with FakeTensorMode():
            params = b.init_fns[0](model.init_params(torch.Generator(),
                                                     "cpu"))
            trees = {"params": params, "opt": b.init_fns[1](params),
                     "batch": input_tensors(cfg, len(b.rows), S, "train",
                                            "cpu")}
            for group, tree in trees.items():
                for p, t in leaves_with_paths(tree):
                    out[f"{group}/{path_str(p)}"] = t.numel() \
                        * t.element_size()
    return {k.replace("opt/.step", "opt/0").replace("opt/.state/", "opt/1/")
            : v for k, v in out.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_oracle") / "ref.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "oracle", out], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    with open(out) as f:
        return json.load(f)


# ------------------------------------------------------------------ tests


def test_argument_bytes_equal_the_references_memory_analysis(reference):
    ref = reference["grid"]
    mem, _ = _run("train")
    got = _port_argument_leaves()
    assert sum(got.values()) == mem["argument_bytes"]
    assert sorted(got.values()) == sorted(ref["leaves"].values()), \
        (sorted(got.items()), sorted(ref["leaves"].items()))
    assert mem["argument_bytes"] == ref["argument_bytes"]


def test_a_multi_pod_cell_takes_the_references_rows(reference):
    """4 microbatches of 2 rows over 2 (pod) × 2 batch ranks: rank 0 holds
    the 2 rows the reference's input sharding gives a device, and its
    argument bytes equal the reference's ``memory_analysis`` leaf by
    leaf."""
    ref = reference["pods"]
    cell = dict(pods=2, data=2, model_axis=1, batch=POD_B, accum=POD_ACCUM)
    mem, _ = _run("train", **cell)
    got = _port_argument_leaves(**cell)
    assert ref["batch_rows"] == POD_B // 4
    assert got["batch/tokens"] == ref["leaves"]["batch/tokens"] \
        == ref["batch_rows"] * S * 4
    assert sorted(got.values()) == sorted(ref["leaves"].values()), \
        (sorted(got.items()), sorted(ref["leaves"].items()))
    assert sum(got.values()) == mem["argument_bytes"] \
        == ref["argument_bytes"]


def test_a_microbatch_under_its_batch_ranks_is_spread_over_them(reference):
    """The reference's record settles how a microbatch of fewer rows than
    its batch ranks is computed: on 2 (pod) × 4 × 1, its temp bytes with 4
    rows a microbatch sit at its one-row-a-rank level (8 rows a
    microbatch), not at the two rows a rank that replicating the rows over
    ``data`` would compute (16 rows): its partitioner spreads them, padded.
    The port's rank runs its own 2 rows one at a time: its temp bytes and
    FLOPs equal its one-row-a-rank cell's (the reference computes 4 rows a
    rank there, two of them padding)."""
    one, two = reference["spread/16/2"], reference["spread/32/2"]
    cell = reference["spread/16/4"]
    assert abs(cell["temp_bytes"] - one["temp_bytes"]) \
        < abs(cell["temp_bytes"] - two["temp_bytes"]) / 4
    port = {n: _run("train", pods=2, data=4, model_axis=1, batch=b,
                    accum=n) for b, n in SPREAD_CELLS[:2]}
    small, rows = port[4], port[2]
    assert small[0]["temp_bytes"] == rows[0]["temp_bytes"]
    assert small[0]["argument_bytes"] == rows[0]["argument_bytes"] \
        == cell["argument_bytes"]
    assert small[1]["flops"] == rows[1]["flops"]


MIXER_LEAVES = ("/mamba", "/tm", "/cm")


def _gathered_mixer_leaves(monkeypatch) -> list:
    """Patch ``transformer.gather_tree`` to record each Mamba or RWKV
    leaf it gathers, as (path, whole shape of one layer's leaf)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves_with_paths

    seen = []
    gather = T.gather_tree

    def recording(tree, prefix="", **kw):
        out = gather(tree, prefix, **kw)
        if str(prefix).endswith(MIXER_LEAVES):
            seen.extend(
                (f"{prefix}/{path}", tuple(w.shape))
                for (path, t), (_, w) in zip(leaves_with_paths(tree),
                                             leaves_with_paths(out))
                if w.shape != t.shape)
        return out

    monkeypatch.setattr(T, "gather_tree", recording)
    return seen


@pytest.mark.parametrize("kind", CUT_KINDS)
@pytest.mark.parametrize("arch", CUT_ARCHS)
def test_the_cut_scales_as_the_references(reference, arch, kind,
                                          monkeypatch):
    """Reduced ``arch`` over 3 × 64 tokens: the port's per-rank FLOPs on
    data 1 × model 4 over those on 1 × 1 are within 10 % of the same ratio
    of the reference's compiled steps (about ¼ for jamba, whose every
    layer's work is cut; about ½ for RWKV, whose token-shift mixes and
    chunked scan's elementwise work run on every rank at this width).  And
    every Mamba or RWKV weight the port gathers on 1 × 4 is a shape the
    reference's forward all-gathers: the port gathers none, and neither
    does the reference."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    ref = {m: reference[f"cut/{arch}/{kind}/{m}"] for m in CUT_MODEL}
    gathered = _gathered_mixer_leaves(monkeypatch)
    port = {m: _run(kind, cfg, seq=CUT_S, batch=CUT_B, accum=1, data=1,
                    model_axis=m, plain=True)[1]["flops"]
            for m in CUT_MODEL}
    want = ref[4]["flops"] / ref[1]["flops"]
    got = port[4] / port[1]
    assert abs(got / want - 1) <= CUT_RTOL, (got, want)
    assert want < 0.6
    assert all(list(sh) in ref[4]["gathered"] for _, sh in gathered),         gathered
    assert not gathered


@pytest.mark.parametrize("arch", CUT_ARCHS)
def test_mesh_prefill_cuts_the_mamba_and_rwkv_layers(arch, monkeypatch):
    """A prefill of reduced ``arch`` at batch 2 on rank 0 of a fake 1 × 2
    world, against a world of one: the scan's work (Mamba's
    ``_scan_chunk``, the steps of RWKV's plain scan, ``_wkv_step``) is
    half of the whole prefill's, exactly, and no Mamba or RWKV leaf goes
    through ``gather_tree``."""
    from repro_torch.configs import reduced_config
    from repro_torch.introspect import opcount
    from repro_torch.models import mamba as M
    from repro_torch.models import rwkv as RW

    cfg = reduced_config(arch)
    mod, name = (M, "_scan_chunk") if arch.startswith("jamba") \
        else (RW, "_wkv_step")
    fn = getattr(mod, name)
    work = []

    def counted(*args):
        with opcount.count() as cost:
            out = fn(*args)
        work.append(cost.flops)
        return out

    monkeypatch.setattr(mod, name, counted)
    gathered = _gathered_mixer_leaves(monkeypatch)
    scans = {}
    for m in (1, 2):
        work.clear()
        _run("prefill", cfg, seq=S, batch=2, data=1, model_axis=m,
             plain=True)
        scans[m] = sum(work)
    assert scans[1] > 0 and 2 * scans[2] == scans[1]
    assert not gathered


def test_the_spread_moe_step_computes_less_than_the_references(
        reference, monkeypatch):
    """Reduced ``granite-moe-3b-a800m``, 4 microbatches of 2 rows of 16
    tokens on 2 (pod) × 2 × 1 (the ``moe-spread`` run of
    ``tests/test_torch_sharded_train.py``): the port's rank runs its 2
    rows a dispatch group at a time after a pass without gradients that
    counts the routed pairs; the reference's device runs every
    microbatch's row, padded, and routes its pod's shard on every ``data``
    rank.  The port's per-rank FLOPs, its counting pass included, are
    below the reference's per-device FLOPs."""
    from repro_torch.configs import reduced_config
    from repro_torch.introspect import opcount
    from repro_torch.launch import steps

    weigh = steps._weigh_moe_aux
    passes = []

    def counted(*args, **kw):
        with opcount.count() as cost:
            out = weigh(*args, **kw)
        passes.append(cost.flops)
        return out

    monkeypatch.setattr(steps, "_weigh_moe_aux", counted)
    _, cost = _run("train", reduced_config(MOE), seq=MOE_S, batch=MOE_B,
                   accum=MOE_ACCUM, data=2, model_axis=1, pods=2,
                   plain=True)
    ref = reference["moe-spread"]["flops"]
    assert passes and sum(passes) > 0
    assert cost["flops"] < ref, (cost["flops"], sum(passes), ref)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_fake_count_equals_a_real_cpu_run(kind):
    seq = S if kind != "decode" else 32
    fake = _run(kind, seq=seq, data=1, model_axis=1, plain=True)
    real = _run(kind, seq=seq, data=1, model_axis=1, plain=True, fake=False)
    assert fake[0] == real[0]
    for k in ("flops", "bytes", "transcendentals"):
        assert fake[1][k] == real[1][k], k
    assert fake[1]["flops"] > 0 and fake[0]["temp_bytes"] > 0


def _mamba_chunks(kind: str, seq: int, monkeypatch):
    """Reduced ``jamba-v0.1-52b`` over ``seq`` tokens on a world of one,
    traced on fake tensors and run for real on the CPU → (fake, real,
    chunks the fake run traced, chunks the real run ran)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import mamba as M

    cfg = reduced_config("jamba-v0.1-52b")
    calls = []
    scan = M._scan_chunk

    def counted(*args):
        calls.append(1)
        return scan(*args)

    monkeypatch.setattr(M, "_scan_chunk", counted)
    run = dict(seq=seq, batch=2, accum=1, data=1, model_axis=1, plain=True)
    fake = _run(kind, cfg, **run)
    n_fake, calls[:] = len(calls), []
    real = _run(kind, cfg, **run, fake=False)
    return fake, real, n_fake, len(calls)


@pytest.mark.parametrize("kind", ("prefill", "train"))
def test_a_mamba_scan_traced_from_one_chunk_counts_every_chunk(
        kind, monkeypatch):
    """Reduced ``jamba-v0.1-52b`` over 256 tokens (two 128-step chunks of
    the selective scan) on a world of one: on fake tensors each Mamba
    layer runs its first chunk only and counts it twice, forward and
    backward (``models/mamba.py:_Repeated``).  Against the same step run
    for real on the CPU, the FLOPs, bytes and transcendentals are equal,
    and so is a prefill's memory record.  A training step's temp bytes
    are at least the real ones and within 2 %: with two chunks the fake
    peak holds one more ``(B, S, d_inner)`` gradient and one more ``(B,
    chunk, d_state)`` one than the real peak (270,336 bytes, 1.4 %); with
    three and four chunks the records are equal (the next test)."""
    fake, real, n_fake, n_real = _mamba_chunks(kind, 256, monkeypatch)
    assert n_fake > 0 and n_real > 0
    for k in ("flops", "bytes", "transcendentals"):
        assert fake[1][k] == real[1][k], k
    if kind == "prefill":
        assert n_real == 2 * n_fake
        assert fake[0] == real[0]
    else:
        assert {k: v for k, v in fake[0].items() if k != "temp_bytes"} \
            == {k: v for k, v in real[0].items() if k != "temp_bytes"}
        assert real[0]["temp_bytes"] <= fake[0]["temp_bytes"] \
            <= 1.02 * real[0]["temp_bytes"]


@pytest.mark.parametrize("seq", (384, 512))
def test_a_mamba_training_step_traced_from_one_chunk_is_the_real_one(
        seq, monkeypatch):
    """Three and four chunks of the scan: a training step traced on fake
    tensors from one chunk a layer has the real step's counts and memory
    record exactly (the first, middle and last chunks' backwards counted
    apart, the states between chunks and the gradients the split's
    backward joins held as the loop holds them), and it traces fewer
    chunks than the real step runs."""
    fake, real, n_fake, n_real = _mamba_chunks("train", seq, monkeypatch)
    assert n_real > n_fake > 0
    assert fake[1] == real[1]
    assert fake[0] == real[0]


@pytest.mark.parametrize("remat", ("none", "full"))
def test_the_backward_is_counted(remat):
    """The training step's FLOPs against its forward's F (the loss over
    the same rows, no gradient): the backward's two products a forward
    one, 3F, and with ``remat="full"`` the layer stack's forward again:
    4F less the tied head's product (outside the recomputed stack) and
    each layer's last product, ``w_out``, whose output no gradient needs
    (the recomputation stops at the last tensor the backward reads, as
    XLA drops dead recomputation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.introspect import opcount
    from repro_torch.models.registry import build_model, input_tensors

    cfg = smollm()
    _, train = _run("train", cfg, data=1, model_axis=1, remat=remat,
                    plain=True)
    model = build_model(cfg, dispatch=DispatchConfig(path="reference"))
    with FakeTensorMode():
        params = model.init_params(torch.Generator(), "cpu")
        batch = input_tensors(cfg, B, S, "train", "cpu")
        with torch.no_grad(), opcount.count() as fwd:
            model.loss_fn(params, batch)
    head = 2.0 * B * S * cfg.d_model * 512  # the padded vocab
    w_out = 2.0 * B * S * cfg.d_ff * cfg.d_model * cfg.n_layers
    want = 3 * fwd.flops + (fwd.flops - head - w_out if remat == "full"
                            else 0)
    assert abs(train["flops"] / want - 1) <= 0.02


def test_kernel_work_on_another_thread_is_counted():
    """A backward on a thread that carries the caller's dispatch-mode
    stack (as the autograd engine's CUDA device thread does) adds the
    attention backward kernel's work to the caller's count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import (_get_current_dispatch_mode_stack,
                                              _pop_mode, _push_mode)

    from repro_torch.introspect import opcount
    from repro_torch.kernels import flash_attention as kfa

    b, s, h, kvh, hd = 2, 64, 4, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, s, h, hd, requires_grad=True)
        k = torch.empty(b, s, kvh, hd, requires_grad=True)
        v = torch.empty(b, s, kvh, hd, requires_grad=True)
        with opcount.count() as cost:
            loss = kfa.flash_attention(q, k, v).sum()
            stack = _get_current_dispatch_mode_stack()
            err = []

            def backward():
                for m in stack:
                    _push_mode(m)
                try:
                    torch.autograd.grad(loss, (q, k, v))
                except BaseException as e:  # noqa: BLE001 - re-raised
                    err.append(e)
                finally:
                    for _ in stack:
                        _pop_mode()

            t = threading.Thread(target=backward)
            t.start()
            t.join()
        assert not err, err
    pairs = opcount.attention_pairs(s, s, True, None)
    want = opcount.attention_work(b, h, hd, pairs, 4, q.numel(), k.numel(),
                                  b * h * s)[0] + opcount.attention_bwd_work(
        b, h, hd, pairs, 4, q.numel(), k.numel(), b * h * s)[0]
    assert cost.flops == want


def test_rank_zero_stands_for_the_last_rank(tmp_path):
    from repro_torch.configs import MeshConfig, ShapeConfig
    from repro_torch.launch.dryrun import run_cell

    for kind, b in (("train", B), ("decode", 2), ("decode", 1)):
        shape = ShapeConfig("t", S, b, kind)
        recs = [run_cell("smollm-360m", "t", "single", str(tmp_path / str(r)),
                         cfg=smollm(), shape=shape,
                         mesh_cfg=MeshConfig(data=2, model=2), rank=r)
                for r in (0, 3)]
        for r in recs:
            assert r["status"] == "ok", r.get("traceback")
            r.pop("total_s"), r.pop("trace_s")
        assert recs[0] == recs[1], kind


def test_collectives_of_a_hand_counted_decode_step():
    """Reduced ``smollm-360m`` (d 60, 3/1 heads of 20, d_ff 128, vocab
    512, tied, 2 layers, fp32), one decode step at batch 2 on 2×2: the
    rank's row and the cache's slots over ``model``.  No weight moves.
    All-gathers (their gathered output): each layer's token columns of q,
    k and v, (1, 1, 60), (1, 1, 20) and (1, 1, 20) (3 heads do not split
    over 2 ranks: the projections stay cut by columns), and the logits'
    vocab columns (1, 1, 512) once.  All-reduces (twice their input): the
    vocab-cut embedding's rows (1, 1, 60) once; each layer's
    decode-attention combine, a max and a sum of (1, 1, 3, 1, 1) and a sum
    of (1, 1, 1, 3, 20), its ``o_proj`` rows' output (1, 1, 60) and its
    Megatron FFN's output (1, 1, 60).  Every group has 2 ranks."""
    from repro_torch.configs import reduced_config

    _, cost = _run("decode", reduced_config("smollm-360m"), seq=16, batch=2)
    f32 = 4
    gather = f32 * (2 * (60 + 20 + 20) + 512)
    reduce = 2 * f32 * (60 + 2 * (3 + 3 + 3 * 20 + 60 + 60))
    ops = {c["kind"]: (c["bytes"], c["count"], c["group_size"])
           for c in cost["collective_ops"]}
    assert ops == {"all-gather": (gather, 7.0, 2),
                   "all-reduce": (reduce, 11.0, 2)}
    assert cost["collectives_by_group"] == {"2": gather + reduce}
    assert cost["collective_bytes"] == gather + reduce


def test_collective_payloads_follow_the_references_rule():
    """One call of each collective on a fake 2 × 2 world, each over one
    axis of 2 ranks: an all-gather counts its gathered output, an
    all-reduce twice its input, a reduce-scatter, an all-to-all, a
    broadcast and a ring shift their input."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.introspect import opcount
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as C

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode(), opcount.count() as cost:
            x = torch.empty(4, 3)  # 48 bytes
            C.all_gather(x, mesh, "model", 0)
            C.all_reduce(x, mesh, ("data", "model"))
            C.all_reduce(x, mesh, "model", "max")
            C.reduce_scatter(x, mesh, "data", 0)
            C.all_to_all(x, mesh, "model", 0, [1, 3], [3, 1])
            C.broadcast(x, mesh, "data", 0)
            C.shift(x, mesh, "model", "test")
    ops = {c["kind"]: (c["bytes"], c["count"])
           for c in cost.to_json()["collective_ops"]}
    assert ops == {"all-gather": (96.0, 1.0), "all-reduce": (288.0, 3.0),
                   "reduce-scatter": (48.0, 1.0),
                   "all-to-all": (48.0, 1.0),
                   "collective-broadcast": (48.0, 1.0),
                   "collective-permute": (48.0, 1.0)}
    assert cost.collective_bytes_by_group_size() == {2: 576.0}


def _kernel_cases():
    """(name, wrapper call, plain call, inputs' shapes, work) for each
    kernel on the dry-run's path; work is (flops, bytes)."""
    from repro_torch.introspect import opcount
    from repro_torch.kernels import asm_relu as kasm
    from repro_torch.kernels import block_dct as kbd
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import jpeg_conv as kjc

    b, s, h, kvh, hd = 2, 48, 4, 2, 64
    pairs = opcount.attention_pairs(s, s, True, None)
    q_el, kv_el = b * s * h * hd, b * s * kvh * hd
    n, g, cin, cout = 2, 4, 3, 5
    rows = n * g * g
    return [
        # called for a gradient: the forward also writes each row's lse
        ("flash_attention", kfa.flash_attention, kfa.attention_plain,
         [(b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)],
         opcount.attention_work(b, h, hd, pairs, 4, q_el, kv_el,
                                b * h * s)),
        ("jpeg_conv", kjc.jpeg_conv, kjc.jpeg_conv_plain,
         [(n, g, g, cin, 64), (3, 3, cin, 64, cout, 64)],
         opcount.conv_work(rows, cin, 64, 9, 64, cout, 64, 64, rows)),
        ("asm_relu", kasm.asm_relu, kasm.asm_relu_plain,
         [(n, g, g, cout, 64)], opcount.asm_work(rows * cout, 64, 64)),
        ("block_dct", kbd.block_dct, kbd.block_dct_plain,
         [(n, g, g, 8, 8)], opcount.block_matmul_work(rows)),
        ("block_idct", kbd.block_idct, kbd.block_idct_plain,
         [(n, g, g, 64)], opcount.block_matmul_work(rows)),
    ]


@pytest.mark.parametrize("case", range(5), ids=(
    "flash_attention", "jpeg_conv", "asm_relu", "block_dct", "block_idct"))
def test_a_fake_kernel_path_is_a_shape_function(case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.introspect import opcount
    from repro_torch.kernels import launch_counts

    name, wrapper, plain, shapes, work = _kernel_cases()[case]
    gen = torch.Generator().manual_seed(0)
    real = [torch.randn(s, generator=gen) for s in shapes]
    want = plain(*real)
    before = launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(t).requires_grad_(True) for t in real]
        with opcount.count() as cost:
            out = wrapper(*fake)
        assert type(out).__name__ == "FakeTensor"
        assert out.shape == want.shape and out.dtype == want.dtype
        assert (cost.flops, cost.bytes) == work
        out.sum().backward()  # the backward's fake path, and its caches
        assert all(t.grad.shape == t.shape for t in fake)
    assert launch_counts() == before
    # a real CPU tensor takes the plain version: the same result, no
    # kernel work, and the caches the fake calls touched still real
    with opcount.count() as real_cost:
        got = wrapper(*real)
    with opcount.count() as plain_cost:
        plain(*real)
    assert torch.equal(got, want)
    assert (real_cost.flops, real_cost.bytes) == (plain_cost.flops,
                                                 plain_cost.bytes)
    assert launch_counts() == before


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``run_cell`` over reduced cells of every family (attention head_dim
    64), two on a 2 (pod) × 2 × 2 mesh, and three the reference skips."""
    from repro_torch.configs import (MeshConfig, ShapeConfig,
                                     reduced_config)
    from repro_torch.launch.dryrun import run_cell

    out = str(tmp_path_factory.mktemp("dryrun"))
    one, two = MeshConfig(data=2, model=2), \
        MeshConfig(multi_pod=True, pods=2, data=2, model=2)
    shapes = {"train_4k": ShapeConfig("train_4k", S, 2 * B, "train"),
              "prefill_32k": ShapeConfig("prefill_32k", S, 4, "prefill"),
              "decode_32k": ShapeConfig("decode_32k", S, 4, "decode"),
              "long_500k": ShapeConfig("long_500k", S, 1, "decode")}
    cells = [("smollm-360m", "train_4k", "single"),
             ("granite-moe-3b-a800m", "prefill_32k", "single"),
             ("mixtral-8x7b", "long_500k", "single"),
             ("jamba-v0.1-52b", "decode_32k", "single"),
             ("jamba-v0.1-52b", "long_500k", "multi"),
             ("rwkv6-7b", "prefill_32k", "single"),
             ("internvl2-1b", "train_4k", "multi"),
             ("whisper-small", "decode_32k", "single"),
             ("jpeg-resnet", "train_4k", "single"),
             ("jpeg-resnet", "decode_32k", "single"),
             ("smollm-360m", "long_500k", "single"),
             ("whisper-small", "long_500k", "multi")]
    recs = {}
    for arch, shape, mesh in cells:
        cfg = reduced_config(arch)
        if cfg.head_dim:
            cfg = dataclasses.replace(cfg, head_dim=64)
        recs[(arch, shape, mesh)] = run_cell(
            arch, shape, mesh, out, cfg=cfg, shape=shapes[shape],
            mesh_cfg=two if mesh == "multi" else one)
    return out, recs


@pytest.mark.parametrize("cell", range(12))
def test_run_cell_writes_the_references_records(records, cell):
    out, recs = records
    key = list(recs)[cell]
    arch, shape, mesh = key
    with open(os.path.join(out, f"{arch}__{shape}__{mesh}.json")) as f:
        rec = json.load(f)
    assert rec == recs[key]
    assert rec["devices"] == (8 if mesh == "multi" else 4)
    skip = {("jpeg-resnet", "decode_32k"):
            "skip(no-decode: classification net)",
            ("smollm-360m", "long_500k"): "skip(full-attn)",
            ("whisper-small", "long_500k"): "skip(full-attn)"}
    if (arch, shape) in skip:
        assert rec["status"] == skip[(arch, shape)]
        assert "memory" not in rec
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert tuple(rec["memory"]) == MEMORY_KEYS
    assert tuple(rec["hlo_cost"]) == COST_KEYS
    mem, cost = rec["memory"], rec["hlo_cost"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert cost["collective_bytes"] > 0  # every cell's mesh talks
    if shape in ("decode_32k", "long_500k"):
        assert mem["alias_bytes"] > 0  # the cache, written in place
    else:
        assert mem["alias_bytes"] == 0
    assert "error" not in rec and "xla_cost" not in rec
    assert rec["trace_s"] >= 0 and rec["total_s"] >= rec["trace_s"]


def test_the_command_line_writes_records_and_skips_existing(tmp_path):
    from repro_torch.configs import SHAPES, list_archs
    from repro_torch.launch import dryrun

    dryrun.main(["--arch", "jpeg-resnet", "--shape", "prefill_32k",
                 "--out", str(tmp_path)])
    with open(tmp_path / "jpeg-resnet__prefill_32k__single.json") as f:
        assert json.load(f)["status"] == \
            "skip(no-decode: classification net)"
    # --all with every record present writes nothing
    names = [f"{a}__{s}__{m}.json" for a in list_archs() for s in SHAPES
             for m in ("single", "multi")]
    assert len(names) == 88
    for n in names:
        (tmp_path / n).write_text("{}")
    dryrun.main(["--all", "--skip-existing", "--out", str(tmp_path)])
    assert all((tmp_path / n).read_text() == "{}" for n in names)


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_uneven_cache_slots_raise(kind):
    from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_axis_rules, make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import UnevenSlotsError

    cfg = smollm()
    build = steps.build_prefill_step if kind == "prefill" \
        else steps.build_decode_step
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rules = make_axis_rules(MeshConfig(data=2, model=2))
        run = RunConfig(model=cfg, shape=ShapeConfig("t", 6, 1, kind))
        with pytest.raises(UnevenSlotsError, match="6 slots"):
            build(build_model(cfg), run, mesh, rules)
        run = RunConfig(model=cfg, shape=ShapeConfig("t", 8, 1, kind))
        assert build(build_model(cfg), run, mesh, rules).rows == [0]


if __name__ == "__main__" and sys.argv[1:2] == ["oracle"]:
    oracle(sys.argv[2])
