"""A tiny run of every cell on the CPU, through the plain versions of the
kernels: the harness's whole path but the card.

The training cell's limits are set from readings at its own size on the
card; at this size an Adam step moves near-zero gradients by their sign,
so its numbers are only required to be computed and judged."""
from __future__ import annotations

import math
import time

import pytest
import torch

from conftest import BYTES, SEED, tiny

CELLS = ["jpeg-resnet-cifar.coef-closed", BYTES,
         "jpeg-resnet-cifar.train-b1024"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run(name, trace):
    from perfbench import run

    cell = tiny(name)
    res = run.run_cell(cell, SEED, 1.0, trace, torch.device("cpu"),
                       t_start=time.monotonic())
    checks = res["checks"]
    assert res["correct"] == all(c["value"] <= c["limit"]
                                 for c in checks.values())
    if cell["workload"]["driver"] == "train_step":
        assert set(checks) == set(cell["workload"]["correct"])
        assert all(math.isfinite(c["value"]) for c in checks.values())
    else:
        assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in
                                       cell["end_to_end"]}
        assert res["metrics"]["setup_s"]["value"] > 0
    else:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"
