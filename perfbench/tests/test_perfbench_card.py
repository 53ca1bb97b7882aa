"""Each cell run by its command on the card, briefly (skips without one):
``python -m pytest -q -m cuda perfbench/tests/test_perfbench_card.py``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT, SEED


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jpeg-resnet-cifar.coef-closed",
                                  "jpeg-resnet-cifar.train-b1024"])
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
