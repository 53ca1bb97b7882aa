"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest -q perfbench/tests``; the repository's suite does not
collect them)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a seed past 32 signed bits, as the driver's are
SEED = 2**31 + 11


#: the serving cell with JFIF files at Poisson arrivals in its traffic's
#: place: the byte path (``traffic/jfif.py``, ``traffic/poisson.py``, the
#: port's decode), which no cell of ``BENCHMARK.json`` runs yet
BYTES = "jpeg-resnet-cifar.bytes-poisson"


def tiny(name: str) -> dict:
    """Cell ``name`` (or :data:`BYTES`) at a size a CPU test holds: few
    images and clients, batches of 8 to serve, small training batches."""
    from perfbench.lib import spec

    if name == BYTES:
        cell = spec.cell("jpeg-resnet-cifar.coef-closed")
        cell["workload"]["traffic"] = {
            "kind": "poisson", "rate_per_s": 8.0, "images": 16,
            "payload": "bytes", "qualities": [35, 50, 75, 90]}
        cell["name"] = BYTES
    else:
        cell = spec.cell(name)
    if "serve" in cell["workload"]:
        cell["workload"]["serve"].update(batch=8, buckets=[1, 2, 4, 8])
    tr = cell["workload"]["traffic"]
    if tr["kind"] == "closed_loop":
        tr.update(clients=8, images=16)
    elif tr["kind"] == "poisson":
        tr.update(rate_per_s=8.0, images=16)
    elif tr["kind"] == "train_batches":
        tr.update(batch=16, batches=4)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture(autouse=True)
def _one_decode_worker(monkeypatch):
    # the decode pool's spawned workers each import torch: one in-process
    # decoder keeps a CPU rehearsal of the byte traffic short
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
