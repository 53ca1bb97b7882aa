"""Where the benchmark's data lives, and how a cell is looked up by name.

Everything a cell needs is data: its entry in ``BENCHMARK.json``, its
workload file ``perfbench/workloads/<cell>.json`` (configuration, driver,
traffic parameters, the limits of its correctness check), and its
configuration file.  Code is found by name: ``drivers/<driver>.py``,
``traffic/<kind>.py``, ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]   # perfbench/
ROOT = HERE.parent                            # the checkout


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry, its workload file
    under ``"workload"``, its configuration under ``"config_data"``, and
    the metrics it reports under ``"end_to_end"`` and ``"per_layer"``."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(HERE / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)

    def reports(m):
        return name in m.get("workloads", [w["name"]
                                           for w in bench["workloads"]])

    return {**entry, "workload": workload, "config_data": config,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots);
    a metric split by the cells that report it (``idle_share.train``)
    without a file of its own is read by its family's
    (``idle_share.py``)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def subseed(seed: int, stream: str) -> int:
    """An independent 63-bit seed for one named stream of a run's seed."""
    words = [int(b) for b in stream.encode()]
    return int(np.random.SeedSequence([int(seed), *words])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def set_cache_env() -> None:
    """Fixed build and kernel cache directories inside the checkout, so
    only a checkout's first run builds."""
    base = ROOT / "build" / "perfbench"
    for k, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[k] = str(base / sub)
        os.makedirs(base / sub, exist_ok=True)
