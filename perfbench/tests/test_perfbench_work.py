"""The yardstick's arithmetic against hand counts and the port's own
formula."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT


def _cfg(name):
    with open(ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_spatial_flops_four_stages_by_hand():
    """A four-stage network of two blocks a stage at 256 x 256 (ResNet-18's
    widths and depth behind a stride-1 stem): every stage after the first
    halves the image and projects its first block's input."""
    from perfbench.lib.work import spatial_flops

    cfg = {"image_size": 256, "in_channels": 3, "widths": [64, 128, 256, 512],
           "blocks_per_stage": 2, "num_classes": 1000}
    px = 256 * 256
    stem = 2 * 9 * 3 * 64 * px
    stage0 = 4 * 2 * 9 * 64 * 64 * px
    later = 0
    for cin, w, hw in ((64, 128, px // 4), (128, 256, px // 16),
                       (256, 512, px // 64)):
        later += 2 * 9 * cin * w * hw + 3 * 2 * 9 * w * w * hw \
            + 2 * cin * w * hw
    head = 2 * 512 * 1000
    assert spatial_flops(cfg) == stem + stage0 + later + head
    assert spatial_flops(cfg) == pytest.approx(71.1e9, rel=0.01)


def test_spatial_flops_cifar_by_hand():
    from perfbench.lib.work import spatial_flops

    n = (2 * 9 * 3 * 16 * 1024 + 2 * 2 * 9 * 16 * 16 * 1024
         + 2 * 9 * 16 * 32 * 256 + 2 * 9 * 32 * 32 * 256 + 2 * 16 * 32 * 256
         + 2 * 9 * 32 * 64 * 64 + 2 * 9 * 64 * 64 * 64 + 2 * 32 * 64 * 64
         + 2 * 64 * 10)
    assert spatial_flops(_cfg("jpeg-resnet-cifar")) == n
    assert n == pytest.approx(25.0e6, rel=0.01)


def test_banded_conv_work_matches_the_ports_formula():
    from perfbench.lib.work import banded_conv_work
    from repro_torch.introspect import opcount

    # s0b0.conv1 of a batch of 8 at 40 bands: 8 x 32 x 32 blocks
    rows = out_rows = 8 * 32 * 32
    ours = banded_conv_work(rows, out_rows, 9, 64, 40, 64, 40)
    port = opcount.conv_work(rows, 64, 40, 9, 40, 64, 40, 40, out_rows)
    assert ours == port
