"""The port's block transforms and factored convolution on the CPU (the
kernel's plain version) against the reference package: its Pallas block
DCT in interpret mode, its pure-jnp oracles, and its factored and
per-step convolutions.

Tolerances: the block transforms 1e-5 absolute on unit-scale inputs
(64-term fp32 sums in another order); the factored conv 5e-4, the
exploded-conv tolerance of the reference suite (``test_kernels.py``): the
port multiplies by one 64×64 operator where the reference takes two 8×8
products and a gather."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import conv as ref_conv
from repro.core import dispatch as ref_dsp
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core import conv as convlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import jpeg as jpeglib
from repro_torch.kernels import asm_relu as kasm
from repro_torch.kernels import block_dct as kbd

# one intra-op thread: the suite runs in parallel workers beside
# wall-clock tests of the reference package
torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("quality", [None, 50])
@pytest.mark.parametrize("n", [7, 256, 515])
def test_block_dct_matches_reference(n, quality):
    blocks = np.random.default_rng(n).normal(size=(n, 8, 8)).astype(
        np.float32)
    want = np.asarray(ref_ops.block_dct(jnp.asarray(blocks), quality))
    got = kbd.block_dct(torch.as_tensor(blocks), quality)
    assert got.shape == (n, 64)
    np.testing.assert_allclose(_np(got), want, atol=1e-5)
    np.testing.assert_array_equal(_np(got),
                                  _np(kbd.block_dct_plain(
                                      torch.as_tensor(blocks), quality)))
    if quality is None:
        np.testing.assert_allclose(
            _np(got), np.asarray(ref_ref.block_dct_ref(jnp.asarray(blocks))),
            atol=1e-5)


@pytest.mark.parametrize("quality", [None, 50])
@pytest.mark.parametrize("n", [7, 256, 515])
def test_block_idct_matches_reference(n, quality):
    coef = np.random.default_rng(n + 1).normal(size=(n, 64)).astype(
        np.float32)
    want = np.asarray(ref_ops.block_idct(jnp.asarray(coef), quality))
    got = kbd.block_idct(torch.as_tensor(coef), quality)
    assert got.shape == (n, 8, 8)
    # the dequantization multiplies by table entries of up to ~120
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-6)
    if quality is None:
        np.testing.assert_allclose(
            _np(got), np.asarray(ref_ref.block_idct_ref(jnp.asarray(coef))),
            atol=1e-5)


def test_block_transforms_invert_each_other():
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, 5, 3, 8, 8)).astype(np.float32))
    coef = kbd.block_dct(x, 50)
    assert coef.shape == (2, 5, 3, 64)
    np.testing.assert_allclose(_np(kbd.block_idct(coef, 50)), _np(x),
                               atol=1e-5)


def test_block_transform_gradient_is_the_transposed_operator():
    """The kernel's backward multiplies by the transposed operator; on the
    CPU the plain version's autograd gives the same map."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(9, 8, 8))).requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(9, 64)))
    (gx,) = torch.autograd.grad(kbd.block_dct(x, 50), x, g)
    op = kbd.operator("block_dct", 50, g)
    np.testing.assert_allclose(_np(gx).reshape(9, 64), _np(g @ op.T),
                               atol=1e-12)
    c = torch.as_tensor(rng.normal(size=(3, 64))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: kbd.block_idct(t, 50), (c,))


def test_channels_last_blocking_round_trips():
    img = torch.arange(2 * 3 * 16 * 24, dtype=torch.float32).reshape(
        2, 3, 16, 24)
    blocks = jpeglib.block_channels_last(img)
    assert blocks.shape == (2, 2, 3, 3, 8, 8)
    want = _np(img).reshape(2, 3, 2, 8, 3, 8).transpose(0, 2, 4, 1, 3, 5)
    np.testing.assert_array_equal(_np(blocks), want)
    np.testing.assert_array_equal(
        _np(jpeglib.unblock_channels_last(blocks)), _np(img))


def test_cached_constants_from_inference_mode_serve_training():
    """Operators first built under ``inference_mode`` (a served batch)
    are cached as normal tensors, so a later training step can save them
    for its backward."""
    kbd._operators.cache_clear()
    kasm._operands.cache_clear()
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(4, 8, 8)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(4, 64)).astype(np.float32))
    with torch.inference_mode():
        kbd.block_dct(x, 50)
        kasm.asm_relu(c, 14, bands=16)
    xg, cg = x.clone().requires_grad_(True), c.clone().requires_grad_(True)
    (kbd.block_dct(xg, 50).sum() + kasm.asm_relu(cg, 14, bands=16).sum()
     ).backward()
    assert xg.grad is not None and cg.grad is not None


@pytest.mark.parametrize("bands", [64, 16])
def test_asm_backward_closed_form_matches_autograd(bands):
    """The ASM kernel's backward (closed form, plain PyTorch) against the
    autograd of its plain forward (fp32: the same products in another
    association)."""
    x = torch.as_tensor(np.random.default_rng(bands).normal(
        size=(3, 5, 64)).astype(np.float32)).requires_grad_(True)
    g = torch.as_tensor(np.random.default_rng(1).normal(
        size=(3, 5, 64)).astype(np.float32))
    (want,) = torch.autograd.grad(
        kasm.asm_relu_plain(x, 14, bands=bands), x, g)
    got = kasm.asm_relu_backward_plain(x.detach(), g, 14, bands)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("bands", [64, 16])
@pytest.mark.parametrize("stride,r", [(1, 3), (2, 3), (2, 1)])
@pytest.mark.parametrize("scaled", [(True, False), (False, True)])
def test_factored_conv_matches_reference(bands, stride, r, scaled):
    rng = np.random.default_rng(stride * 10 + r + bands)
    coef = rng.normal(size=(2, 4, 4, 3, 64)).astype(np.float32)
    kern = (rng.normal(size=(5, 3, r, r)) * 0.3).astype(np.float32)
    in_s, out_s = scaled
    want = np.asarray(ref_conv._jpeg_conv_factored(
        jnp.asarray(coef), jnp.asarray(kern), stride, quality=50,
        in_scaled=in_s, out_scaled=out_s, bands=bands))
    got = convlib._jpeg_conv_factored(
        torch.as_tensor(coef), torch.as_tensor(kern), stride, quality=50,
        in_scaled=in_s, out_scaled=out_s, bands=bands)
    np.testing.assert_allclose(_np(got), want, atol=5e-4)


@pytest.mark.parametrize("limit", [None, 0])
@pytest.mark.parametrize("bands", [64, 16])
def test_per_step_conv_matches_reference(limit, bands):
    """``dispatch.conv``, materialised (default limit) and factored (limit
    0), against the reference's; the gradient with respect to the kernel
    flows on both paths."""
    rng = np.random.default_rng(bands)
    coef = rng.normal(size=(2, 4, 4, 3, 64)).astype(np.float32)
    kern = (rng.normal(size=(4, 3, 3, 3)) * 0.3).astype(np.float32)
    want = np.asarray(ref_dsp.conv(
        jnp.asarray(coef), jnp.asarray(kern), 2, in_scaled=True,
        cfg=ref_dsp.DispatchConfig(path="auto", bands=bands,
                                   materialize_limit=limit)))
    k = torch.as_tensor(kern).requires_grad_(True)
    got = dsp.conv(torch.as_tensor(coef), k, 2, in_scaled=True,
                   cfg=dsp.DispatchConfig(bands=bands,
                                          materialize_limit=limit))
    np.testing.assert_allclose(_np(got), want, atol=5e-4)
    (gk,) = torch.autograd.grad(got.sum(), k)
    assert gk.shape == k.shape and bool(torch.isfinite(gk).all())


def test_forced_reference_path_keeps_large_convs_factored():
    """Above the limit a conv goes factored under a forced ``reference``
    config too (with the plain block transforms), where the reference
    package would materialise Ξ."""
    cpu = torch.device("cpu")
    small = dsp.DispatchConfig(path="reference", materialize_limit=10)
    assert dsp.choose_path("conv", small, device=cpu, op_elems=11) == \
        "factored"
    assert dsp.choose_path("conv", small, device=cpu, op_elems=10) == \
        "reference"
    rng = np.random.default_rng(2)
    coef = torch.as_tensor(rng.normal(size=(1, 2, 2, 3, 64)).astype(
        np.float32))
    kern = torch.as_tensor((rng.normal(size=(4, 3, 3, 3)) * 0.3).astype(
        np.float32))
    got = dsp.conv(coef, kern, 1, cfg=small)
    want = convlib._jpeg_conv_factored(coef, kern, 1, quality=50,
                                       in_scaled=False, out_scaled=False)
    np.testing.assert_array_equal(_np(got), _np(want))
