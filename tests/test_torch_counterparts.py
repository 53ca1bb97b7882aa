"""Every public top-level name of the reference package has a counterpart
of the same name in the same module of the port, or is listed below with
the reason it has none.

Both packages are parsed with ``ast``; nothing is imported.  A name
counts as public when it does not start with ``_``; a port module offers
a name it defines, assigns or imports at top level (also inside a
top-level ``if`` or ``try``).
"""
import ast
import os

import pytest

from repro_torch import configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")

#: reference module → the port module that holds its names
MODULE_MAP = {"configs/base.py": "configs/__init__.py"}

_PALLAS = "a Pallas tile or call of the TPU kernel; the port's CUDA wrapper " \
          "in the same module replaces it"
_XLA_ATTN = "bounds XLA's unrolled attention chunks; the flash-attention " \
            "kernel and its plain version chunk nothing"
_REGISTRY = "the reference's op registry falls back to `reference` for a " \
            "missing path; the port resolves each path explicitly, so no " \
            "path quietly gives way to another"

#: reference modules with no port module, and why
NO_MODULE = {
    "kernels/ops.py": "dispatch to the Pallas calls: each kernel's wrapper "
                      "in kernels/*.py is the port's",
    "kernels/ref.py": "the kernels' plain versions: the `*_plain` functions "
                      "beside each wrapper",
    "parallel/compat.py": "a shim over JAX versions; the port needs none",
    "launch/hlo_analysis.py": "a parser of XLA's HLO text; "
                              "introspect/opcount.py counts the ops as they "
                              "run",
}

#: (reference module, name) with no counterpart, and why
LEFT_OUT = {
    ("parallel/sharding.py", "shard"): "XLA's sharding hint; the port's "
                                       "collectives are explicit",
    ("models/layers.py", "DENSE_ATTN_ELEMS"): _XLA_ATTN,
    ("models/layers.py", "KV_CHUNK"): _XLA_ATTN,
    ("models/layers.py", "MAX_Q_CHUNKS"): _XLA_ATTN,
    ("core/plan.py", "VMEM_BUDGET"): "the TPU's VMEM budget; the port's is "
                                     "kernels/fused_block.py:"
                                     "fused_smem_bytes",
    ("core/dispatch.py", "register"): _REGISTRY,
    ("core/dispatch.py", "available_paths"): _REGISTRY,
    ("core/dispatch.py", "lookup"): _REGISTRY,
    ("kernels/asm_relu.py", "TILE_BLOCKS"): _PALLAS,
    ("kernels/asm_relu.py", "asm_relu_pallas"): _PALLAS,
    ("kernels/block_dct.py", "TILE"): _PALLAS,
    ("kernels/block_dct.py", "block_dct_pallas"): _PALLAS,
    ("kernels/block_dct.py", "block_idct_pallas"): _PALLAS,
    ("kernels/flash_attention.py", "Q_TILE"): _PALLAS,
    ("kernels/flash_attention.py", "KV_TILE"): _PALLAS,
    ("kernels/flash_attention.py", "NEG_INF"): _PALLAS,
    ("kernels/flash_attention.py", "flash_attention_pallas"): _PALLAS,
    ("kernels/fused_block.py", "fused_block_pallas"): _PALLAS,
    ("kernels/fused_block.py", "fused_vmem_bytes"): "the Pallas kernel's "
                                                    "VMEM; the port's is "
                                                    "fused_smem_bytes",
    ("kernels/jpeg_conv.py", "CH_TILE"): _PALLAS,
    ("kernels/jpeg_conv.py", "jpeg_conv_pallas"): _PALLAS,
    ("kernels/tiling.py", "LANE"): "the TPU's 128-lane vector width; the "
                                   "CUDA kernels pack no lanes",
}


def _ref_modules():
    out = []
    for d, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(d, f), REF)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _names(path: str, imports: bool) -> set[str]:
    """Top-level names bound in ``path``: defs, classes and assignments,
    and with ``imports`` also imported names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out: set[str] = set()

    def walk(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out.add(n.name)
            elif isinstance(n, ast.Assign):
                out.update(e.id for t in n.targets for e in ast.walk(t)
                           if isinstance(e, ast.Name))
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) \
                    and isinstance(n.target, ast.Name):
                out.add(n.target.id)
            elif isinstance(n, (ast.Import, ast.ImportFrom)) and imports:
                out.update((a.asname or a.name).split(".")[0]
                           for a in n.names)
            elif isinstance(n, (ast.If, ast.Try)):
                walk(n.body)
                walk(n.orelse)
                for h in getattr(n, "handlers", ()):
                    walk(h.body)
                walk(getattr(n, "finalbody", ()))

    walk(tree.body)
    return out


def _public(module: str) -> set[str]:
    return {n for n in _names(os.path.join(REF, module), False)
            if not n.startswith("_")}


def _port_path(module: str) -> str:
    return os.path.join(PORT, MODULE_MAP.get(module, module))


@pytest.mark.parametrize("module", _ref_modules())
def test_every_reference_name_has_a_counterpart(module):
    if module in NO_MODULE:
        assert not os.path.exists(_port_path(module)), \
            f"{module} is listed as having no port module, but it has one"
        return
    port = _port_path(module)
    assert os.path.exists(port), f"no port module for src/repro/{module}"
    have = _names(port, True)
    missing = sorted(n for n in _public(module) - have
                     if (module, n) not in LEFT_OUT)
    assert not missing, (f"src/repro/{module}: no counterpart in "
                         f"{os.path.relpath(port, ROOT)} for {missing}")


def test_every_entry_left_out_is_still_a_gap():
    """The lists go stale neither way: each entry names a reference module
    or name that exists and still has no counterpart, with a reason."""
    modules = set(_ref_modules())
    for module, why in NO_MODULE.items():
        assert module in modules and why, module
    for (module, name), why in LEFT_OUT.items():
        assert module in modules and name in _public(module) and why, \
            (module, name)
        assert name not in _names(_port_path(module), True), \
            f"{module}:{name} now has a counterpart: drop it from LEFT_OUT"
    for module, port in MODULE_MAP.items():
        assert module in modules and os.path.exists(
            os.path.join(PORT, port)), module


def test_register_adds_an_arch(monkeypatch):
    """``configs.register`` as the reference's: ``get_config``,
    ``reduced_config`` and ``list_archs`` see the registered arch, and a
    registered id replaces a built-in one."""
    monkeypatch.setattr(configs, "_REGISTRY", dict(configs._REGISTRY))
    full = configs.ModelConfig(name="tiny-resnet", widths=(8, 16))
    small = configs.ModelConfig(name="tiny-resnet", widths=(4, 8))
    configs.register("tiny-resnet", lambda: full, lambda: small)
    assert configs.get_config("tiny-resnet") is full
    assert configs.reduced_config("tiny-resnet") is small
    assert "tiny-resnet" in configs.list_archs()
    assert set(configs.ARCHS) < set(configs.list_archs())
    configs.register("smollm-360m", lambda: full, lambda: small)
    assert configs.get_config("smollm-360m") is full
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")
