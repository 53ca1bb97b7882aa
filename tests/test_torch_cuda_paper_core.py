"""The paper's formulation in ``core/`` on the card: the kernel routes of
``jpeg_encode`` / ``jpeg_decode`` (the block-transform kernel) and of
``jpeg_conv`` with a bias (the banded-conv kernel, the bias as its DC
shift; factored: the block transforms, the bias added after), each against
the same function on CPU copies, which runs the plain versions.

Needs an NVIDIA GPU of compute capability 9.0 and ``nvcc``; skipped
elsewhere.  Run on the card with

    python -m pytest -q tests/test_torch_cuda_paper_core.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import conv as convlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import jpeg as jpeglib
from repro_torch.kernels import _build
from repro_torch.kernels import block_dct as kbd
from repro_torch.kernels import jpeg_conv as kjc

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
    got = got.cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    tol = rtol * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("table", ["orthonormal", "q50", "custom"])
def test_jpeg_encode_decode_launch_the_block_transforms(dev, table):
    kw = {"orthonormal": dict(scaled=False), "q50": dict(quality=50),
          "custom": dict(qtable=np.random.default_rng(1).integers(
              1, 100, 64).astype(np.float64))}[table]
    img = torch.rand((3, 5, 40, 24), generator=torch.Generator()
                     .manual_seed(0)) * 2 - 1
    before = dict(kbd.LAUNCHES)
    coef = jpeglib.jpeg_encode(img.to(dev), **kw)
    back = jpeglib.jpeg_decode(coef, **kw)
    assert kbd.LAUNCHES == {"block_dct": before["block_dct"] + 1,
                            "block_idct": before["block_idct"] + 1}
    _close(coef, jpeglib.jpeg_encode(img, **kw), 1e-5)
    _close(back, jpeglib.jpeg_decode(coef.cpu(), **kw), 1e-5)
    _close(back, img, 1e-5)


@pytest.mark.parametrize("out_scaled", [False, True])
@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_jpeg_conv_with_bias_on_the_card(dev, monkeypatch, stride, factored,
                                         out_scaled):
    g = torch.Generator().manual_seed(stride)
    coef = torch.randn((3, 6, 4, 5, 64), generator=g)
    k = torch.randn((7, 5, 3, 3), generator=g) * 0.3
    b = torch.randn((7,), generator=g)
    if factored:
        monkeypatch.setattr(convlib, "MATERIALIZE_LIMIT", 0)
    before = kjc.LAUNCHES, dict(kbd.LAUNCHES)
    got = convlib.jpeg_conv(coef.to(dev), k.to(dev), stride, b.to(dev),
                            out_scaled=out_scaled)
    if factored:
        assert kjc.LAUNCHES == before[0]
        assert kbd.LAUNCHES["block_dct"] == before[1]["block_dct"] + 1
    else:
        assert kjc.LAUNCHES == before[0] + 1
    _close(got, convlib.jpeg_conv(coef, k, stride, b, out_scaled=out_scaled),
           1e-4)


def test_dispatch_conv_bias_as_the_kernels_shift(dev):
    g = torch.Generator().manual_seed(3)
    coef = torch.randn((2, 4, 4, 3, 64), generator=g).to(dev)
    k = (torch.randn((6, 3, 3, 3), generator=g) * 0.3).to(dev)
    b = torch.randn((6,), generator=g).to(dev)
    before = kjc.LAUNCHES
    got = dsp.conv(coef, k, 2, b, cfg=dsp.DispatchConfig(path="cuda"))
    assert kjc.LAUNCHES == before + 1
    want = dsp.conv(coef, k, 2, b, cfg=dsp.DispatchConfig(path="reference"))
    _close(got, want.cpu(), 1e-4)


def test_explode_full_on_the_card(dev):
    g = torch.Generator().manual_seed(4)
    k = torch.randn((3, 2, 3, 3), generator=g) * 0.3
    coef = torch.randn((2, 2, 3, 2, 64), generator=g)
    before = kbd.LAUNCHES["block_dct"]
    op = convlib.explode_full(k.to(dev), 2, 3, 1)
    assert kbd.LAUNCHES["block_dct"] == before + 1
    _close(convlib.apply_full(coef.to(dev), op),
           convlib.apply_full(coef, convlib.explode_full(k, 2, 3, 1)), 1e-4)
