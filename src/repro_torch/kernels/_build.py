"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with :mod:`ctypes` — a few seconds, where
a build against PyTorch's headers takes minutes.  The library lands in
``build/kernels/`` at the repository root (git-ignored), named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads the existing file.  Nothing is built at import: the first CUDA
launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "SOURCES", "build", "library", "check_device",
           "stream_of", "launch_check", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None
_LOG: dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the sources unless a library for this exact source text and
    flag set is already in :data:`BUILD_DIR`; returns its path."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libjpeg_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        _LOG.setdefault("seconds", 0.0)
        _LOG.setdefault("cached", True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_FLAGS, "-o", str(tmp),
                           *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    _LOG.update(seconds=time.perf_counter() - t0, cached=False,
                ptxas=proc.stderr)
    return out


def build_log() -> dict:
    """What the last :func:`build` did: ``seconds``, ``cached`` and the
    compiler's register/shared-memory report (``ptxas``)."""
    return dict(_LOG)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.jk_banded_conv.argtypes = [_P] * 7 + [_I] * 15 + [_P]
        lib.jk_banded_conv.restype = _I
        lib.jk_banded_conv_smem.argtypes = [_I, _I]
        lib.jk_banded_conv_smem.restype = _I
        lib.jk_asm.argtypes = [_P] * 4 + [ctypes.c_longlong, _I, _I, _I, _P]
        lib.jk_asm.restype = _I
        _LIB = lib
    return _LIB


def check_device(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one CUDA
    device of compute capability 9.0 or newer."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"kernel operands must be contiguous float32 on "
                             f"{dev}; got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device {dev} "
                           f"has compute capability {cap}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
