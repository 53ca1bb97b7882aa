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
* **Elastic** — leaves are stored whole.  A save under a mesh
  (``spec_tree`` and ``mesh``: each leaf's ``PartitionSpec`` and the
  ``DeviceMesh``) gathers every leaf from its ranks, and rank 0 writes the
  full arrays; a restore with a spec tree and a mesh returns this rank's
  slices.  So a step saved on one mesh restores on any other, or on none,
  and the reverse, as the reference's re-placement does.

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
from concurrent.futures import ThreadPoolExecutor
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


def _hasher(workers: int | None = None) -> ThreadPoolExecutor:
    """Threads for the leaves' checksums (hashlib releases the GIL), so
    they run beside the archive's write or read: up to 8 by default, where
    the caller waits; an asynchronous save passes 1, since it shares the
    host with the training steps it overlaps."""
    return ThreadPoolExecutor(max_workers=workers
                              or min(8, os.cpu_count() or 1))


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
             blocking: bool = True, *, spec_tree: Any = None,
             mesh=None) -> None:
        """Write ``tree``'s leaves as step ``step``; ``blocking=False``
        returns once the leaves are on the host.  With ``spec_tree`` and
        ``mesh`` the leaves are this rank's slices: every rank calls save,
        the full leaves are gathered, and rank 0 of the mesh writes (its
        ``extra``)."""
        if mesh is not None:
            from repro_torch.parallel.sharding import gather_full

            tree = tree_map(lambda x, sp: gather_full(x, sp, mesh), tree,
                            spec_tree)
            if any(mesh.get_local_rank(a) for a in mesh.mesh_dim_names):
                return
        leaves = [(p, _host(v)) for p, v in leaves_with_paths(tree)]
        extra = dict(extra or {})

        def write():
            tmp, final = self._dir(step) + ".tmp", self._dir(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "extra": extra, "leaves": {}}
            arrays = {f"leaf_{i}": arr for i, (_, (arr, _)) in
                      enumerate(leaves)}
            with _hasher(None if blocking else 1) as pool:
                sums = [pool.submit(_digest, arr) for arr in arrays.values()]
                np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
                for (name, arr), (path, (_, dtype)), digest in zip(
                        arrays.items(), leaves, sums):
                    manifest["leaves"][name] = {
                        "path": path, "shape": list(arr.shape),
                        "dtype": dtype, "sha256": digest.result()}
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
        by_path, sums = {}, {}
        with _hasher() as pool, \
                np.load(os.path.join(d, "arrays.npz")) as z:
            for name, meta in manifest["leaves"].items():
                by_path[meta["path"]] = arr = z[name]
                sums[name] = pool.submit(_digest, arr)
            for name, meta in manifest["leaves"].items():
                if sums[name].result() != meta["sha256"]:
                    raise ValueError(f"checksum mismatch in {d}/{name}")
        return by_path, manifest

    def restore(self, step: int, target_tree: Any, spec_tree: Any = None,
                mesh=None) -> tuple[Any, dict[str, Any]]:
        """Restore step ``step`` into the structure of ``target_tree``: each
        leaf comes back as a tensor on its target leaf's device, in its
        dtype (a bf16 leaf stored widened comes back bit-identical); with
        ``spec_tree`` and ``mesh``, this rank's slice of it.  Returns
        ``(tree, extra)``."""
        return self._place(*self._read(step), step, target_tree, spec_tree,
                           mesh)

    @staticmethod
    def _place(by_path: dict[str, np.ndarray], manifest: dict, step: int,
               target_tree: Any, spec_tree: Any = None,
               mesh=None) -> tuple[Any, dict[str, Any]]:
        """A step's verified arrays in ``target_tree``'s structure (sliced
        for this rank when ``mesh`` is given)."""
        want = {p for p, _ in leaves_with_paths(target_tree)}
        missing = sorted(want - set(by_path))
        if missing:
            raise KeyError(f"checkpoint step {step} misses leaves {missing}")
        it = iter(by_path[p] for p, _ in leaves_with_paths(target_tree))

        def place(leaf, spec=None):
            arr = torch.as_tensor(next(it))
            if mesh is not None:
                from repro_torch.parallel.sharding import local_slice

                arr = local_slice(arr, spec, mesh)
            return arr.to(device=leaf.device, dtype=leaf.dtype)

        if mesh is None:
            return tree_map(place, target_tree), manifest["extra"]
        return tree_map(place, target_tree, spec_tree), manifest["extra"]

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

    def restore_latest(self, target_tree: Any, spec_tree: Any = None,
                       mesh=None) -> tuple[int, Any, dict[str, Any]] | None:
        """The newest valid step as ``(step, tree, extra)``, or None.
        Damaged steps are skipped; ``spec_tree`` and ``mesh`` as for
        :meth:`restore`."""
        for step in reversed(self.steps()):  # each step read once
            try:
                read = self._read(step)
            except _READ_ERRORS:
                continue
            return (step, *self._place(*read, step, target_tree, spec_tree,
                                       mesh))
        return None
