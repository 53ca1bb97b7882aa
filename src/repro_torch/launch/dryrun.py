"""Multi-pod dry-run: trace rank 0's step of every (arch × shape × mesh)
cell on its kernel path, with no card.

A port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell's step for the production mesh and reads XLA's memory and cost
analyses.  Here one process stands for rank 0 of the 256-rank (16 × 16)
or 512-rank (2 × 16 × 16) mesh: a ``fake`` process group of that size
(its collectives return at once), the step built as the launcher builds
it (``launch/steps.py``), and the step run once on fake tensors, whose
ops compute shapes and allocate nothing.  The kernel wrappers see fake
tensors and add their kernels' work without launching
(``kernels/_build.is_fake``); the JPEG model runs its ``cuda`` dispatch
path, so the count is the card's kernel path.  It is the one entry point
of the port that needs no CUDA: the fake tensors live on the CPU, since
a CPU-only build of PyTorch cannot run autograd on fake CUDA tensors.

Each record holds:

* ``memory``: the rank's argument, output, temporary and aliased bytes
  (``introspect/memory.py``), the reference's ``memory_analysis()``;
* ``hlo_cost``: FLOPs, bytes, transcendentals and collective bytes by
  group size (``introspect/opcount.py``), the reference's
  ``hlo_analysis`` schema;
* ``trace_s`` (the step's run; the reference has ``lower_s`` and
  ``compile_s``) and ``total_s``; no ``xla_cost``.

Every rank runs the same step on slices of the same sizes, so rank 0
stands for each (``run_cell(rank=)`` traces another).  A skipped cell
records the reference's reason.

Usage::

    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all            # every cell, both meshes

The knobs of the reference: ``DRYRUN_NO_TP`` (replicated weights, no
model-axis split), ``DRYRUN_GRAD_ACCUM`` (default by width, below),
``DRYRUN_REMAT`` (default ``full``) and ``DRYRUN_GRAD_COMPRESSION``
(default ``none``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (SHAPES, MeshConfig, ModelConfig, RunConfig,
                                 ShapeConfig, TrainConfig, get_config,
                                 list_archs)

__all__ = ["DEFAULT_OUT", "default_grad_accum", "fake_world", "axis_rules",
           "trace_step", "run_cell", "main"]

DEFAULT_OUT = "artifacts/dryrun"


def default_grad_accum(cfg: ModelConfig) -> int:
    """The reference's microbatch count (``dryrun.py:60-69``), sized for
    its TPU v5e's memory: a 52B Mamba hybrid 16, a model of width 4096
    or more 8, any other 4."""
    if cfg.ssm_kind == "mamba" and cfg.d_model >= 4096:
        return 16
    return 8 if cfg.d_model >= 4096 else 4


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A ``fake`` process group of ``size`` ranks, this process rank
    ``rank``, for the ``with`` block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=rank, world_size=size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def axis_rules(mesh_cfg: MeshConfig):
    """The mesh's axis rules, the model axis dropped under
    ``DRYRUN_NO_TP``."""
    from repro_torch.launch.mesh import make_axis_rules

    rules = make_axis_rules(mesh_cfg)
    if os.environ.get("DRYRUN_NO_TP"):
        # pure DP on the same mesh: replicated weights, no model-axis
        # collectives (the reference's lever for sub-1B models)
        rules = dataclasses.replace(rules, rules=dict(rules.rules, model=()))
    return rules


def trace_step(model, run: RunConfig, mesh, rules, fake: bool = True,
               device: str = "cpu") -> tuple[dict, dict]:
    """Build the shape's step, make this rank's arguments (parameters
    from seed 0, zero batches and caches; fake unless ``fake`` is False,
    then on ``device``), run the step once counted and tracked → (memory
    record, cost record)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.introspect import memory, opcount
    from repro_torch.launch import steps
    from repro_torch.models.registry import input_tensors

    cfg, shape = model.cfg, run.shape
    build = {"train": steps.build_train_step,
             "prefill": steps.build_prefill_step,
             "decode": steps.build_decode_step}[shape.kind]
    bundle = build(model, run, mesh, rules)
    with FakeTensorMode(allow_non_fake_inputs=True) if fake \
            else contextlib.nullcontext():
        full = model.init_params(torch.Generator().manual_seed(0), device)
        params = bundle.init_fns[0](full)
        del full
        batch = input_tensors(cfg, len(bundle.rows), shape.seq_len,
                              shape.kind, device)
        if shape.kind == "train":
            args = (params, bundle.init_fns[1](params), batch)
        elif shape.kind == "decode":
            full = model.init_cache(shape.global_batch, shape.seq_len,
                                    device)
            args = (params, bundle.init_fns[1](full), batch)
            del full
        else:
            args = (params, batch)
        with torch.no_grad() if shape.kind != "train" \
                else contextlib.nullcontext(), opcount.count() as cost, \
                memory.track() as tracker:
            out = bundle.step_fn(*args, local=True)
        return memory.memory_record(args, out, tracker), cost.to_json()


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             extra_tags: str = "", *, cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None,
             mesh_cfg: MeshConfig | None = None, rank: int = 0) -> dict:
    """Trace one cell and write its record (``out_dir``, the reference's
    file name).  ``cfg``, ``shape`` and ``mesh_cfg`` replace the
    production ones (the tests' reduced cells, phase 24's world of one);
    ``rank`` is the rank traced."""
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models.registry import build_model, cell_is_skipped

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_cfg = mesh_cfg or MeshConfig(multi_pod=mesh_kind == "multi")
    n_dev = mesh_cfg.data * mesh_cfg.model * (
        mesh_cfg.pods if mesh_cfg.multi_pod else 1)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "devices": n_dev, "family": cfg.family}
    skip = cell_is_skipped(cfg, shape)
    if skip:
        record["status"] = skip
        _write(record, out_dir, extra_tags)
        return record
    grad_accum = int(os.environ.get("DRYRUN_GRAD_ACCUM",
                                    default_grad_accum(cfg)))
    remat = os.environ.get("DRYRUN_REMAT", "full")
    compression = os.environ.get("DRYRUN_GRAD_COMPRESSION", "none")
    train_cfg = TrainConfig(remat=remat, grad_accum=grad_accum,
                            grad_compression=compression)
    run = RunConfig(model=cfg, shape=shape, train=train_cfg, mesh=mesh_cfg)
    # the JPEG model's kernel path, which "auto" picks on a CUDA tensor
    dispatch = DispatchConfig(path="cuda") \
        if cfg.family == "jpeg_resnet" else None
    model = build_model(cfg, remat=remat, dispatch=dispatch)
    t0 = time.time()
    try:
        with fake_world(n_dev, rank):
            mesh = make_mesh_from_config(mesh_cfg, "cpu")
            t1 = time.time()
            mem, cost = trace_step(model, run, mesh, axis_rules(mesh_cfg))
            record["trace_s"] = round(time.time() - t1, 2)
        record["memory"] = mem
        record["hlo_cost"] = cost
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 2)
    _write(record, out_dir, extra_tags)
    return record


def _write(record: dict, out_dir: str, extra_tags: str = "") -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{extra_tags}" if extra_tags else ""
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)
    print(f"[dryrun] {record['arch']} × {record['shape']} × {record['mesh']}"
          f" -> {record['status']} ({record.get('total_s', 0)}s)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s, m) for a in list_archs() for s in SHAPES
                 for m in ("single", "multi")]
    else:
        if args.arch is None or args.shape is None:
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.mesh)]
    for arch, shape, mesh_kind in cells:
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}.json")
        if args.skip_existing and os.path.exists(path):
            continue
        run_cell(arch, shape, mesh_kind, args.out)


if __name__ == "__main__":
    main()
