"""The port stands alone: importing every ``repro_torch`` module (its
examples included) and ``chip_smoke.py`` loads no JAX and nothing of the
reference package."""
import os
import pkgutil
import subprocess
import sys

import repro_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_port_imports_no_jax_and_no_reference_package():
    names = _modules()
    for want in ("kernels.fused_block", "kernels.block_dct", "launch.serve",
                 "launch.train", "optim.optimizers", "optim.schedule",
                 "optim.grad", "checkpoint.manager", "models.registry",
                 "data.pipeline", "tree", "models.layers",
                 "models.transformer", "kernels.flash_attention",
                 "configs.smollm_360m", "configs.granite_3_2b",
                 "configs.starcoder2_3b", "configs.mistral_nemo_12b",
                 "serving", "serving.ladder", "serving.grid",
                 "serving.scheduler", "serving.qos", "serving.metrics",
                 "serving.breaker", "serving.trace", "codec.ingest",
                 "data.pipeline", "core.convert", "core.transform_linear",
                 "serving.faults", "introspect", "introspect.opcount",
                 "introspect.roofline", "introspect.report",
                 "introspect.attribution", "introspect.gridprof",
                 "launch.inspect", "models.rwkv", "models.mamba",
                 "models.moe", "configs.rwkv6_7b", "configs.internvl2_1b",
                 "configs.whisper_small", "parallel", "parallel.sharding",
                 "parallel.collectives", "parallel.pipeline", "launch.mesh",
                 "launch.steps", "launch.dryrun", "introspect.memory",
                 "examples", "examples.quickstart",
                 "examples.convert_pretrained", "examples.serve_jpeg",
                 "examples.serve_qos", "examples.train_e2e",
                 "examples.lm_train"):
        assert "repro_torch." + want in names, want
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, %r)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', %r)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "assert not bad, bad\n" % (ROOT, os.path.join(ROOT, "chip_smoke.py")))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    lines = [ln.strip() for ln in src.splitlines()
             if ln.strip().startswith(("import ", "from "))]
    assert lines
    for ln in lines:
        mod = ln.split()[1].split(".")[0]
        assert mod not in ("jax", "jaxlib", "repro"), ln
