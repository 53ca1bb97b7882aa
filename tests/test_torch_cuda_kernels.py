"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU of compute capability 9.0 (the kernels are built for
``sm_90a``) and ``nvcc``; skipped elsewhere.  Run on the card with

    python -m pytest -q tests/test_torch_cuda_kernels.py

Covers ragged row counts, every per-channel width 8…64, both shortcut
kinds and both strides of the fused block, and the launch counters.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import conv as convlib
from repro_torch.kernels import _build
from repro_torch.kernels import asm_relu as kasm
from repro_torch.kernels import fused_block as kfb
from repro_torch.kernels import jpeg_conv as kjc
from repro_torch.kernels import tiling

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (capability 9.0)")
    _build.library()
    return torch.device("cuda", 0)


def _close(got, want, rtol):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    tol = rtol * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("w", list(range(8, 65, 8)))
@pytest.mark.parametrize("rows", [1, 37, 4099])
def test_asm_relu_every_width(dev, w, rows):
    g = torch.Generator(device=dev).manual_seed(w + rows)
    x = torch.randn((rows, 64), generator=g, device=dev)
    before = kasm.LAUNCHES
    got = kasm.asm_relu(x, 8, bands=w)
    assert kasm.LAUNCHES == before + 1
    _close(got, kasm.asm_relu_plain(x, 8, bands=w), 2e-5)
    narrow = x[:, :w].contiguous()
    _close(kasm.asm_relu(narrow, 14), kasm.asm_relu_plain(narrow, 14), 2e-5)


@pytest.mark.parametrize("stride,r", [(1, 3), (2, 3), (2, 1)])
@pytest.mark.parametrize("bands", [8, 16, 40, 64])
def test_jpeg_conv_matches_plain(dev, stride, r, bands):
    g = torch.Generator(device=dev).manual_seed(stride * 100 + r + bands)
    k = torch.randn((9, 5, r, r), generator=g, device=dev) * 0.3
    xi = convlib.explode(k, stride, bands=bands)
    coef = torch.randn((3, 6, 10, 5, 64), generator=g, device=dev)
    shift = torch.randn((9,), generator=g, device=dev)
    before = kjc.LAUNCHES
    for kw in ({}, {"shift": shift, "w_out": 64}):
        got = kjc.jpeg_conv(coef, xi, stride, **kw)
        _close(got, kjc.jpeg_conv_plain(coef, xi, stride, **kw), 1e-4)
    assert kjc.LAUNCHES == before + 2


def _pc(g, dev, cin, cout, stride, r, bands, w_in, w_out):
    k = torch.randn((cout, cin, r, r), generator=g, device=dev) * 0.3
    shift = torch.randn((cout,), generator=g, device=dev)
    return tiling.pack_conv(convlib.explode(k, stride, bands=bands), shift,
                            stride, w_in=w_in, w_out=w_out)


@pytest.mark.parametrize("case", [
    # (cin, cout, stride, b1, b2, bj, w_x, projection)
    (8, 8, 1, 16, 16, 16, 16, False),
    (6, 10, 2, 24, 24, 24, 24, True),
    (8, 8, 1, 24, 40, 40, 48, False),
    (4, 4, 1, 24, 16, 40, 40, False),
    (5, 3, 2, 64, 64, 64, 64, True),
])
def test_fused_block_matches_plain(dev, case):
    cin, cout, s, b1, b2, bj, w_x, with_proj = case
    g = torch.Generator(device=dev).manual_seed(sum(case))
    c1 = _pc(g, dev, cin, cout, s, 3, b1, min(b1, w_x), b1)
    c2 = _pc(g, dev, cout, cout, 1, 3, b2, min(b1, b2), b2)
    pp = _pc(g, dev, cin, cout, s, 1, bj, min(bj, w_x), bj) \
        if with_proj else None
    a1 = tiling.pack_asm(14, b1, b1, device=dev)
    a2 = tiling.pack_asm(8, bj, bj, device=dev)
    x = torch.randn((3, 6, 10, cin * w_x), generator=g, device=dev)
    before = kfb.LAUNCHES
    got = kfb.fused_block(x, c1, a1, c2, a2, pp)
    assert kfb.LAUNCHES == before + (3 if with_proj else 2)
    _close(got, kfb.fused_block_reference(x, c1, a1, c2, a2, pp), 1e-4)


def test_smem_formula_matches_library(dev):
    lib = _build.library()
    for w in range(8, 65, 8):
        for with_asm in (0, 1):
            assert lib.jk_banded_conv_smem(w, with_asm) == \
                kjc.conv_smem_bytes(w, bool(with_asm))


def test_kernels_refuse_bad_operands(dev):
    x = torch.randn((4, 64), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        kasm.asm_relu(x, 14)
    np.testing.assert_array_equal(
        kasm.asm_relu(torch.zeros((2, 16)), 14).numpy(), np.zeros((2, 16)))
