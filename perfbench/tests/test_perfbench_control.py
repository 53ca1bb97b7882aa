"""The control, the plain reference in TF32 put in the program's place,
fails the cells' limits (here at a CPU test's size; ``control.py`` reads it
on the chip at the cells' own)."""
from __future__ import annotations

import pytest
import torch

from conftest import BYTES, SEED, tiny


@pytest.mark.parametrize("name", ["jpeg-resnet-cifar.coef-closed",
                                  BYTES])
def test_serving_control_fails(name):
    from perfbench import control

    cell = tiny(name)
    got = control.serve_control(cell, SEED, torch.device("cpu"))
    assert got["logit_gap"] > cell["workload"]["correct"]["logit_gap"]


def test_training_control_fails():
    from perfbench import control

    cell = tiny("jpeg-resnet-cifar.train-b1024")
    got = control.train_readings(cell, SEED, torch.device("cpu"),
                                 precision="tf32")
    lim = cell["workload"]["correct"]
    assert any(got[k] > lim[k] for k in lim), got


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from perfbench.reference.resnet import tf32_round

    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -3.0e-3])
    got = tf32_round(x)
    assert got[0] == 1.0 + 2.0 ** -10           # representable: kept
    assert got[1] == 1.0                        # a tie: to even
    assert got[2] == 1.0 + 2.0 ** -10           # above the tie: up
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
