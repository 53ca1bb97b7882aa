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
"""
import dataclasses
import json
import os
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


def oracle(out_path: str) -> None:
    """The reference's 2×2 training cell → ``out_path`` (json): its
    argument size and each argument leaf's bytes on one device."""
    import jax
    from repro.configs.base import (MeshConfig, RunConfig, ShapeConfig,
                                    TrainConfig)
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import build_train_step, path_str
    from repro.models.registry import build_model, input_specs
    from repro.parallel.sharding import AxisRules, sharding_rules

    mesh = make_test_mesh(2, 2)
    rules = AxisRules.default(False, data=2, model=2).with_mesh(mesh)
    cfg = smollm(ref=True)
    model = build_model(cfg, remat="full")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                    train=TrainConfig(grad_accum=ACCUM, remat="full"),
                    mesh=MeshConfig(data=2, model=2))
    with mesh, sharding_rules(rules):
        b = build_train_step(model, run, mesh, rules)
        batch = input_specs(cfg, run.shape, dryrun=True)
        compiled = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings,
                           donate_argnums=(0, 1)).lower(
            b.params_shape, b.opt_shape, batch).compile()
    leaves = {}
    for group, tree, shardings in zip(
            ("params", "opt", "batch"), (b.params_shape, b.opt_shape, batch),
            b.in_shardings):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        for (path, leaf), sh in zip(flat, jax.tree.leaves(shardings)):
            shape = sh.shard_shape(leaf.shape)
            leaves[f"{group}/{path_str(path)}"] = int(
                np.prod(shape, dtype=np.int64) * leaf.dtype.itemsize)
    with open(out_path, "w") as f:
        json.dump({"argument_bytes": int(
            compiled.memory_analysis().argument_size_in_bytes),
            "leaves": leaves}, f)


# ---------------------------------------------------------------- helpers


def _run(kind: str, cfg=None, *, seq: int = S, batch: int = B,
         accum: int = ACCUM, remat: str = "full", data: int = 2,
         model_axis: int = 2, rank: int = 0, plain: bool = False,
         fake: bool = True):
    """``trace_step`` of one cell → (memory record, cost record): a fake
    world of data × model ranks (this one ``rank``), or a real gloo world
    of one when not ``fake``."""
    import torch.distributed as dist

    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig)
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import free_port, make_mesh_from_config
    from repro_torch.models.registry import build_model

    cfg = cfg or smollm()
    mc = MeshConfig(data=data, model=model_axis)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, batch, kind),
                    train=TrainConfig(grad_accum=accum, remat=remat),
                    mesh=mc)
    model = build_model(cfg, remat=remat, dispatch=DispatchConfig(
        path="reference") if plain else None)
    rules = dryrun.axis_rules(mc)
    if fake:
        with dryrun.fake_world(data * model_axis, rank):
            return dryrun.trace_step(model, run,
                                     make_mesh_from_config(mc, "cpu"), rules)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        return dryrun.trace_step(model, run, make_mesh_from_config(mc, "cpu"),
                                 rules, fake=False)
    finally:
        dist.destroy_process_group()


def _port_argument_leaves() -> dict:
    """Each argument leaf's bytes on rank 0 of the port's 2×2 cell."""
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
    mc = MeshConfig(data=2, model=2)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                    train=TrainConfig(grad_accum=ACCUM, remat="full"),
                    mesh=mc)
    model = build_model(cfg, remat="full")
    out = {}
    with dryrun.fake_world(4):
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
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_oracle") / "ref.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "oracle", out], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    with open(out) as f:
        return json.load(f)


# ------------------------------------------------------------------ tests


def test_argument_bytes_equal_the_references_memory_analysis(reference):
    mem, _ = _run("train")
    got = _port_argument_leaves()
    # the optimizer state's paths differ by package (``.step`` / ``0``)
    norm = {k.replace("opt/.step", "opt/0").replace("opt/.state/", "opt/1/")
            : v for k, v in got.items()}
    assert sum(got.values()) == mem["argument_bytes"]
    assert sorted(norm.values()) == sorted(reference["leaves"].values()), \
        (sorted(norm.items()), sorted(reference["leaves"].items()))
    assert mem["argument_bytes"] == reference["argument_bytes"]


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_fake_count_equals_a_real_cpu_run(kind):
    seq = S if kind != "decode" else 32
    fake = _run(kind, seq=seq, data=1, model_axis=1, plain=True)
    real = _run(kind, seq=seq, data=1, model_axis=1, plain=True, fake=False)
    assert fake[0] == real[0]
    for k in ("flops", "bytes", "transcendentals"):
        assert fake[1][k] == real[1][k], k
    assert fake[1]["flops"] > 0 and fake[0]["temp_bytes"] > 0


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
    rank's row and the cache's slots over ``model``.  All-gathers (their
    gathered output): the embedding (512 × 60) once, and each layer's
    q/k/v/o projections (3 heads do not split over 2 ranks), 60 × 60, 60
    × 20, 60 × 20, 60 × 60.  All-reduces (twice their input): each
    layer's decode-attention combine, a max and a sum of (1, 1, 3, 1, 1)
    and a sum of (1, 1, 1, 3, 20), and its Megatron FFN's output (1, 1,
    60).  Every group has 2 ranks."""
    from repro_torch.configs import reduced_config

    _, cost = _run("decode", reduced_config("smollm-360m"), seq=16, batch=2)
    f32 = 4
    gather = f32 * (512 * 60 + 2 * (60 * 60 + 60 * 20 + 60 * 20 + 60 * 60))
    reduce = 2 * f32 * 2 * (3 + 3 + 3 * 20 + 60)
    ops = {c["kind"]: (c["bytes"], c["count"], c["group_size"])
           for c in cost["collective_ops"]}
    assert ops == {"all-gather": (gather, 9.0, 2),
                   "all-reduce": (reduce, 8.0, 2)}
    assert cost["collectives_by_group"] == {"2": gather + reduce}
    assert cost["collective_bytes"] == gather + reduce


def test_collective_payloads_follow_the_references_rule():
    """One call of each collective on a fake 2 × 2 world, each over one
    axis of 2 ranks: an all-gather counts its gathered output, an
    all-reduce twice its input, a reduce-scatter, a broadcast and a ring
    shift their input."""
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
            C.broadcast(x, mesh, "data", 0)
            C.shift(x, mesh, "model", "test")
    ops = {c["kind"]: (c["bytes"], c["count"])
           for c in cost.to_json()["collective_ops"]}
    assert ops == {"all-gather": (96.0, 1.0), "all-reduce": (288.0, 3.0),
                   "reduce-scatter": (48.0, 1.0),
                   "collective-broadcast": (48.0, 1.0),
                   "collective-permute": (48.0, 1.0)}
    assert cost.collective_bytes_by_group_size() == {2: 528.0}


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
