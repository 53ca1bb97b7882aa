"""No run loads JAX or the JAX package; a run needs the port beside it."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from perfbench import run

    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def test_a_whole_cpu_run_loads_no_jax():
    code = (
        "import sys, json, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'perfbench' / 'tests')!r}]\n"
        "from conftest import tiny, SEED\n"
        "from perfbench import run\n"
        "for name in ('jpeg-resnet-cifar.coef-closed',\n"
        "             'jpeg-resnet-cifar.train-b1024'):\n"
        "    run.run_cell(tiny(name), SEED, 0.5, True, torch.device('cpu'),\n"
        "                 t_start=time.monotonic())\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "JPEG_INGEST_WORKERS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_result_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "jpeg-resnet-cifar.coef-closed", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
