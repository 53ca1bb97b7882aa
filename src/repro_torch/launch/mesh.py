"""Mesh construction, and a launcher that runs one function on every rank
of a local mesh.

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``DeviceMesh`` over the default process group,
its dimension names the reference's axes; the caller (or
:func:`run_local`) initialises ``torch.distributed`` first.
"""
from __future__ import annotations

import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.configs import MeshConfig
from repro_torch.parallel.sharding import AxisRules

__all__ = ["make_production_mesh", "make_mesh_from_config",
           "make_axis_rules", "make_test_mesh", "make_mesh", "free_port",
           "run_local"]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, its
    dims named ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The target deployment mesh: 16×16 per pod, 2 pods multi-pod (256 or
    512 ranks).  ``pod`` is a second data-parallel level whose collectives
    cross the slow links; ``data``/``model`` live inside a pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh_from_config(cfg: MeshConfig, device_type: str = "cuda"):
    if cfg.multi_pod:
        shape, axes = (cfg.pods, cfg.data, cfg.model), ("pod", "data", "model")
    else:
        shape, axes = (cfg.data, cfg.model), ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_axis_rules(cfg: MeshConfig) -> AxisRules:
    return AxisRules.default(cfg.multi_pod, pods=cfg.pods, data=cfg.data,
                             model=cfg.model)


def make_test_mesh(data: int = 2, model: int = 2, pods: int = 0,
                   device_type: str = "cpu"):
    """A small mesh for the CPU tests (gloo process groups)."""
    if pods:
        return make_mesh((pods, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


# --------------------------------------------------------------------------
# One process per rank
# --------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(x: Any) -> Any:
    """A rank's result made picklable: tensors to numpy (bf16 widened to
    fp32), containers walked."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank: int, world: int, port: int, shape, axes,
               backend: str, device: str, out) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the machine's cores
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            mesh = make_mesh(shape, axes, device)
            result = _to_host(fn(mesh))
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", pickle.dumps(result)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise


def run_local(fn: Callable[[Any], Any], shape: Sequence[int],
              axes: Sequence[str], *, backend: str, device: str,
              timeout: float = 600.0) -> list[Any]:
    """Run ``fn(mesh)`` on every rank of a ``shape`` mesh named ``axes``,
    one spawned process a rank, and return each rank's result (tensors as
    numpy arrays) in rank order.

    Each process initialises a ``backend`` process group over TCP on a
    free local port and builds the mesh of ``device`` type (``"cpu"`` or
    ``"cuda"``; a CUDA rank uses card ``rank % device_count``).  The caller
    picks both: ``nccl`` needs one card a rank, and several ranks sharing
    one card take ``gloo`` (whose point-to-point sends stage CUDA tensors
    through the host, ``parallel/collectives.py``).  ``fn`` must be
    picklable (a module-level function).  A rank that raises fails the
    call with its traceback, after the other ranks are stopped; so does a
    rank that dies, or a run past ``timeout`` seconds."""
    import multiprocessing as mp

    world = int(np.prod(shape))
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)}")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"nccl needs one card a rank: {world} ranks, "
                           f"{torch.cuda.device_count()} cards")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, tuple(shape), tuple(axes),
                               backend, device, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, status, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_local: {world} ranks past "
                                       f"{timeout} s")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} raised:\n{payload}")
            results[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == world else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(world)]
