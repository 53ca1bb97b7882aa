"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` — one process per
source, all started together — and links the objects into one shared
library with a plain C interface, loaded with :mod:`ctypes`: seconds, where
a build against PyTorch's headers takes minutes.  The library lands in
``build/kernels/`` at the repository root (git-ignored), named by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads the existing file.  Nothing is built at import: the first CUDA
launch builds.  A build holds an exclusive ``flock`` on the build
directory, so processes that start together (the ranks of a mesh on one
machine) build once and never load a library another is still writing.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "SOURCES", "build", "library", "use",
           "check_device", "stream_of", "launch_check", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v")

_LIB: ctypes.CDLL | None = None
_LOG: dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: each entry point's argument types (every one returns a CUDA error code)
_SIGNATURES = {
    "jk_banded_conv": [_P] * 7 + [_I] * 16 + [_P],
    "jk_banded_conv_smem": [_I, _I, _I],
    "jk_asm": [_P] * 4 + [ctypes.c_longlong, _I, _I, _I, _P],
    "jk_block_matmul": [_P] * 3 + [ctypes.c_longlong, _P],
    "jk_flash_attention": [_P] * 6 + [_I] * 9 + [_F, _I, _P],
    "jk_flash_attention_bwd": [_P] * 11 + [_I] * 9 + [_F, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(sources: tuple[Path, ...] | None = None,
          out_dir: Path | None = None) -> Path:
    """Compile ``sources`` (default :data:`SOURCES`; edited copies of them
    for a variant) into one library in ``out_dir`` (default
    :data:`BUILD_DIR`) unless one for this exact source text and flag set
    is already there; returns its path."""
    sources = SOURCES if sources is None else tuple(map(Path, sources))
    out_dir = BUILD_DIR if out_dir is None else Path(out_dir)
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = out_dir / f"libjpeg_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        _LOG.setdefault("seconds", 0.0)
        _LOG.setdefault("cached", True)
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    lock = os.open(out_dir, os.O_RDONLY)  # flock on the directory itself
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            _LOG.setdefault("seconds", 0.0)
            _LOG.setdefault("cached", True)
            return out
        return _compile(sources, out_dir, out)
    finally:
        os.close(lock)


def _compile(sources: tuple[Path, ...], out_dir: Path, out: Path) -> Path:
    """Compile and link ``sources`` into ``out`` (the caller holds the
    build lock)."""
    tag = f"{out.stem}.{os.getpid()}.tmp"
    objs = [out_dir / f"{tag}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[1] for proc in procs]
    failed = [(src.name, proc.returncode, err) for src, proc, err
              in zip(sources, procs, logs) if proc.returncode != 0]
    tmp = out_dir / f"{tag}.so"
    if not failed:
        link = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            failed = [("the link", link.returncode, link.stderr)]
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(f"nvcc failed on {what} ({rc}):\n{err}"
                                     for what, rc, err in failed))
    os.replace(tmp, out)
    _LOG.update(seconds=time.perf_counter() - t0, cached=False,
                ptxas="".join(logs))
    return out


def build_log() -> dict:
    """What the last :func:`build` did: ``seconds``, ``cached`` and the
    compiler's register/shared-memory report (``ptxas``)."""
    return dict(_LOG)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return _LIB if _LIB is not None else use(build())


def use(path: Path | str) -> ctypes.CDLL:
    """Load the library at ``path`` (one that :func:`build` made) and
    launch every kernel through it from now on."""
    global _LIB
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        # a library built from an earlier source (kernel_variants.py
        # --parent) may lack a later entry point
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = _I
    _LIB = lib
    return lib


@functools.lru_cache(maxsize=None)
def _capability(dev: torch.device) -> tuple[int, int]:
    return torch.cuda.get_device_capability(dev)


def check_device(*tensors: torch.Tensor,
                 dtypes: tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """Raise unless every tensor is contiguous, of a dtype in ``dtypes``,
    and on one CUDA device of compute capability 9.0 or newer."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype not in dtypes \
                or not t.is_contiguous():
            names = "/".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"kernel operands must be contiguous {names} "
                             f"on {dev}; got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    cap = _capability(dev)
    if cap < (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; device {dev} "
                           f"has compute capability {cap}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
