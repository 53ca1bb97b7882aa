"""Fault-tolerant checkpoints of trees of tensors.

* **Atomic** — a step is written to ``step_<n>.tmp/`` and renamed into
  place only after its manifest (with a sha256 per leaf) is fsynced, so a
  crash mid-write never shadows the previous good step.
* **Corruption fallback** — :meth:`CheckpointManager.restore_latest`
  verifies the checksums and walks back to the newest valid step.
* **Async** — ``save(..., blocking=False)`` copies the leaves to host
  memory at once and writes them in a background thread; :meth:`wait`
  joins it.
* Keep-last-k retention and JSON extras (the data iterator's state).

The on-disk layout is the reference package's (``arrays.npz`` with leaves
``leaf_<i>``, ``manifest.json`` with each leaf's tree path, shape, dtype
and checksum; bf16 leaves stored widened to fp32 and recorded as
``bfloat16``), with its path strings (``repro_torch.tree``), so either
package can read the other's arrays.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, tree_map

__all__ = ["CheckpointManager"]

#: what a damaged step can raise while it is read back
_READ_ERRORS = (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile)


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """``(array to store, dtype to record)``: numpy has no bfloat16, so a
    bf16 tensor is widened (exactly) to fp32 for storage and recorded as
    ``bfloat16``, as the reference package does."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        # a host leaf is copied (an asynchronous save must not see later
        # writes); a device leaf's .cpu() is already a copy
        arr = t.numpy().copy() if leaf.device.type == "cpu" else t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _digest(arr: np.ndarray) -> str:
    """sha256 of the array's C-order bytes, read in place."""
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: dict[str, Any] | None = None,
             blocking: bool = True) -> None:
        """Write ``tree``'s leaves as step ``step``; ``blocking=False``
        returns once the leaves are on the host."""
        leaves = [(p, _host(v)) for p, v in leaves_with_paths(tree)]
        extra = dict(extra or {})

        def write():
            tmp, final = self._dir(step) + ".tmp", self._dir(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "extra": extra, "leaves": {}}
            arrays = {}
            for i, (path, (arr, dtype)) in enumerate(leaves):
                name = f"leaf_{i}"
                arrays[name] = arr
                manifest["leaves"][name] = {
                    "path": path, "shape": list(arr.shape), "dtype": dtype,
                    "sha256": _digest(arr)}
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()

        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the pending asynchronous write, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        """Finished steps on disk, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def _read(self, step: int) -> tuple[dict[str, np.ndarray], dict]:
        """``({path: array}, manifest)`` of a step, every checksum verified;
        raises one of ``_READ_ERRORS`` on a missing or damaged step."""
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {}
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for name, meta in manifest["leaves"].items():
                arr = z[name]
                if _digest(arr) != meta["sha256"]:
                    raise ValueError(f"checksum mismatch in {d}/{name}")
                by_path[meta["path"]] = arr
        return by_path, manifest

    def _valid(self, step: int) -> bool:
        try:
            self._read(step)
        except _READ_ERRORS:
            return False
        return True

    def restore(self, step: int, target_tree: Any
                ) -> tuple[Any, dict[str, Any]]:
        """Restore step ``step`` into the structure of ``target_tree``: each
        leaf comes back as a tensor on its target leaf's device, in its
        dtype (a bf16 leaf stored widened comes back bit-identical).
        Returns ``(tree, extra)``."""
        by_path, manifest = self._read(step)
        want = {p for p, _ in leaves_with_paths(target_tree)}
        missing = sorted(want - set(by_path))
        if missing:
            raise KeyError(f"checkpoint step {step} misses leaves {missing}")
        it = iter(by_path[p] for p, _ in leaves_with_paths(target_tree))

        def place(leaf):
            arr = next(it)
            return torch.as_tensor(arr).to(device=leaf.device,
                                           dtype=leaf.dtype)

        return tree_map(place, target_tree), manifest["extra"]

    def restore_tree(self, step: int | None = None
                     ) -> tuple[int, dict[str, np.ndarray], dict[str, Any]]:
        """Template-free restore: ``(step, {path: array}, extra)``, the
        arrays as stored: a leaf recorded as ``bfloat16`` comes back as its
        exact fp32 widening (numpy has no bf16; the reference returns it
        cast back).  ``None`` picks the newest valid step; raises
        ``FileNotFoundError`` when there is none, or when an explicit step
        is missing or damaged."""
        if step is None:
            # newest first, each step read (and verified) once
            for s in reversed(self.steps()):
                try:
                    by_path, manifest = self._read(s)
                except _READ_ERRORS:
                    continue
                return s, by_path, manifest["extra"]
            raise FileNotFoundError(
                f"no valid checkpoint under {self.directory}")
        try:
            by_path, manifest = self._read(step)
        except _READ_ERRORS as e:
            raise FileNotFoundError(
                f"checkpoint step {step} under {self.directory} is missing "
                f"or corrupt: {e}") from e
        return step, by_path, manifest["extra"]

    def restore_latest(self, target_tree: Any
                       ) -> tuple[int, Any, dict[str, Any]] | None:
        """The newest valid step as ``(step, tree, extra)``, or None.
        Damaged steps are skipped."""
        for step in reversed(self.steps()):
            if self._valid(step):
                tree, extra = self.restore(step, target_tree)
                return step, tree, extra
        return None
