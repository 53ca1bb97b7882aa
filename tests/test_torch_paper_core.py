"""The paper's own formulation in the port's ``core/`` against the reference
package, on the CPU (the plain versions of the kernels): the B, J and J̃
tensors, JPEG steps 1–4 and the lossy round trip, Algorithm 1's full
operator, the JPEG-domain conv with its DC bias, and ASM in every variant
(JPEG-scaled, APX, piecewise-linear); then the paper's properties on the
port alone.

Tolerances: the block tensors and the numpy J / J̃ tensors exact; the
block transforms 1e-5 absolute on unit-scale pixels (64-term fp32 sums
in another order); the lossy round trip 1e-4 of the pixel range; the
convolutions 1e-4 (the reference suite's own, ``tests/test_conv.py``);
ASM 1e-5 and its masks equal."""
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.core import asm as ref_asm
from repro.core import conv as ref_conv
from repro.core import dispatch as ref_dsp
from repro.core import jpeg as ref_jpeg
from repro_torch import configs
from repro_torch.core import asm as asmlib
from repro_torch.core import conv as convlib
from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import jpeg as jpeglib

# one intra-op thread: the suite runs in parallel workers beside
# wall-clock tests of the reference package
torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


def _both(a):
    """One numpy array as a JAX array and a torch tensor."""
    return jnp.asarray(a), torch.as_tensor(a)


#: (reference module, port module, names) of the paper's formulation
SIGNATURES = [
    (ref_jpeg, jpeglib, ("block_image", "unblock_image", "jpeg_encode",
                         "jpeg_decode", "jpeg_round_trip_lossy",
                         "jpeg_tensor", "ijpeg_tensor")),
    (ref_conv, convlib, ("add_dc_bias", "jpeg_conv", "spatial_conv",
                         "explode_full", "apply_full")),
    (ref_dsp, dsp, ("conv",)),
    (ref_asm, asmlib, ("asm_constants", "asm_relu", "apx_relu",
                       "asm_piecewise", "approx_spatial", "nonnegative_mask",
                       "spatial_relu_oracle")),
    (ref_configs, configs, ("register",)),
]


@pytest.mark.parametrize("ref_mod,mod,name", [
    (r, m, n) for r, m, names in SIGNATURES for n in names],
    ids=lambda v: v if isinstance(v, str) else "")
def test_signature_is_the_reference(ref_mod, mod, name):
    """The reference's argument names, kinds and defaults, in its order."""
    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(getattr(mod, name)) == params(getattr(ref_mod, name))


# --------------------------------------------------------------------------
# B, J and J̃; JPEG steps 1–4; the lossy round trip
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8), (3, 24, 16), (2, 3, 16, 32)])
def test_block_image_matches_reference(shape):
    img = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    ref_img, img_t = _both(img)
    want = np.asarray(ref_jpeg.block_image(ref_img))
    got = jpeglib.block_image(img_t)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(jpeglib.unblock_image(got)),
        np.asarray(ref_jpeg.unblock_image(jnp.asarray(want))))
    np.testing.assert_array_equal(_np(jpeglib.unblock_image(got)), img)


def test_block_image_rejects_an_indivisible_size():
    for fn, img in ((ref_jpeg.block_image, jnp.zeros((2, 12, 16))),
                    (jpeglib.block_image, torch.zeros((2, 12, 16)))):
        with pytest.raises(ValueError, match="not divisible"):
            fn(img)


@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("scaled", [True, False])
def test_j_tensors_match_reference(scaled, quality):
    np.testing.assert_array_equal(
        jpeglib.jpeg_tensor(16, 24, quality=quality, scaled=scaled),
        ref_jpeg.jpeg_tensor(16, 24, quality=quality, scaled=scaled))
    np.testing.assert_array_equal(
        jpeglib.ijpeg_tensor(24, 16, quality=quality, scaled=scaled),
        ref_jpeg.ijpeg_tensor(24, 16, quality=quality, scaled=scaled))


def _custom_table():
    return np.random.default_rng(7).integers(1, 100, size=64).astype(
        np.float64)


#: (scaled, quality, qtable) of each convention
TABLES = {"orthonormal": (False, 50, None), "q50": (True, 50, None),
          "q90": (True, 90, None), "custom": (True, 50, "custom")}


@pytest.mark.parametrize("table", list(TABLES))
def test_jpeg_encode_decode_match_reference(table):
    scaled, quality, qt = TABLES[table]
    kw = dict(scaled=scaled, quality=quality,
              qtable=_custom_table() if qt else None)
    img = np.random.default_rng(3).uniform(-1, 1, size=(2, 3, 16, 24)) \
        .astype(np.float32)
    ref_img, img_t = _both(img)
    want = np.asarray(ref_jpeg.jpeg_encode(ref_img, **kw))
    got = jpeglib.jpeg_encode(img_t, **kw)
    assert got.shape == (2, 3, 2, 3, 64)
    np.testing.assert_allclose(_np(got), want, atol=1e-5)
    back = jpeglib.jpeg_decode(torch.as_tensor(want.copy()), **kw)
    np.testing.assert_allclose(
        _np(back), np.asarray(ref_jpeg.jpeg_decode(jnp.asarray(want), **kw)),
        atol=1e-5)
    np.testing.assert_allclose(_np(back), img, atol=1e-5)


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_lossy_round_trip_matches_reference(quality):
    """Each pixel image is the decode of integer step-4 coefficients moved
    by at most 0.3, so no coefficient lies within fp32 rounding of a .5
    tie, where two correct sums in another order may round apart."""
    rng = np.random.default_rng(quality)
    coef = (rng.integers(-3, 4, size=(2, 4, 3, 64))
            + rng.uniform(-0.3, 0.3, size=(2, 4, 3, 64)))
    img = np.array(ref_jpeg.jpeg_decode(
        jnp.asarray(coef, jnp.float32), quality=quality))
    want = np.asarray(ref_jpeg.jpeg_round_trip_lossy(jnp.asarray(img),
                                                     quality=quality))
    got = _np(jpeglib.jpeg_round_trip_lossy(torch.as_tensor(img),
                                            quality=quality))
    assert not np.allclose(want, img, atol=1e-3)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.ptp(want))


def test_lossy_rounding_is_half_to_even():
    ties = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(_np(torch.round(torch.as_tensor(ties))),
                                  np.asarray(jnp.round(jnp.asarray(ties))))


# --------------------------------------------------------------------------
# Algorithm 1 and the JPEG-domain conv with its bias
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_explode_full_matches_reference(stride, scaled):
    rng = np.random.default_rng(stride)
    kern = (rng.normal(size=(2, 3, 3, 3)) * 0.3).astype(np.float32)
    coef = rng.normal(size=(2, 2, 2, 3, 64)).astype(np.float32)
    ref_k, k = _both(kern)
    want_op = ref_conv.explode_full(ref_k, 2, 2, stride, scaled=scaled)
    op = convlib.explode_full(k, 2, 2, stride, scaled=scaled)
    assert op.shape == (2, 2, 64, 3, 2, 2 // stride, 2 // stride, 64)
    np.testing.assert_allclose(_np(op), np.asarray(want_op), atol=1e-4)
    want = np.asarray(ref_conv.apply_full(jnp.asarray(coef), want_op))
    np.testing.assert_allclose(
        _np(convlib.apply_full(torch.as_tensor(coef), op)), want, atol=1e-4)


@pytest.mark.parametrize("scaled", [False, True], ids=["dct", "scaled"])
@pytest.mark.parametrize("path", ["materialised", "factored"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("r", [1, 3, 5])
def test_jpeg_conv_matches_reference(monkeypatch, r, stride, bias, path,
                                     scaled):
    """Materialised (the limit lowered to Ξ's size) and factored (to one
    element below it), in both packages."""
    rng = np.random.default_rng(r * 10 + stride)
    kern = (rng.normal(size=(4, 3, r, r)) * 0.3).astype(np.float32)
    coef = rng.normal(size=(2, 4, 4, 3, 64)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32) if bias else None
    elems = convlib.operator_elems(kern.shape, stride)
    lim = elems if path == "materialised" else elems - 1
    monkeypatch.setattr(convlib, "MATERIALIZE_LIMIT", lim)
    monkeypatch.setattr(ref_conv, "MATERIALIZE_LIMIT", lim)
    kw = dict(in_scaled=scaled, out_scaled=scaled)
    want = np.asarray(ref_conv.jpeg_conv(
        jnp.asarray(coef), jnp.asarray(kern), stride,
        None if b is None else jnp.asarray(b), **kw))
    got = convlib.jpeg_conv(torch.as_tensor(coef), torch.as_tensor(kern),
                            stride, None if b is None else torch.as_tensor(b),
                            **kw)
    assert got.shape == (2, 4 // stride, 4 // stride, 4, 64)
    np.testing.assert_allclose(_np(got), want, atol=1e-4)


@pytest.mark.parametrize("out_scaled", [False, True])
def test_add_dc_bias_matches_reference(out_scaled):
    rng = np.random.default_rng(5)
    out = rng.normal(size=(2, 3, 3, 4, 64)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = np.asarray(ref_conv.add_dc_bias(jnp.asarray(out), jnp.asarray(b),
                                           out_scaled))
    got = convlib.add_dc_bias(torch.as_tensor(out), torch.as_tensor(b),
                              out_scaled)
    np.testing.assert_array_equal(_np(got), want)
    out_t = torch.as_tensor(out)
    assert convlib.add_dc_bias(out_t, None) is out_t


@pytest.mark.parametrize("limit", [None, 0])
@pytest.mark.parametrize("path", ["auto", "reference", "factored"])
def test_dispatch_conv_bias_matches_reference(path, limit):
    rng = np.random.default_rng(11)
    coef = rng.normal(size=(2, 4, 4, 3, 64)).astype(np.float32)
    kern = (rng.normal(size=(5, 3, 3, 3)) * 0.3).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = np.asarray(ref_dsp.conv(
        jnp.asarray(coef), jnp.asarray(kern), 2, jnp.asarray(b),
        cfg=ref_dsp.DispatchConfig(path=path, materialize_limit=limit)))
    got = dsp.conv(torch.as_tensor(coef), torch.as_tensor(kern), 2,
                   torch.as_tensor(b),
                   cfg=dsp.DispatchConfig(path=path, materialize_limit=limit))
    np.testing.assert_allclose(_np(got), want, atol=1e-4)


def test_spatial_conv_bias_matches_reference():
    rng = np.random.default_rng(13)
    img = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    kern = (rng.normal(size=(4, 3, 3, 3)) * 0.3).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = np.asarray(ref_conv.spatial_conv(
        jnp.asarray(img), jnp.asarray(kern), 2, jnp.asarray(b)))
    got = convlib.spatial_conv(torch.as_tensor(img), torch.as_tensor(kern),
                               2, torch.as_tensor(b))
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


# --------------------------------------------------------------------------
# ASM in every variant
# --------------------------------------------------------------------------


def _rand_blocks(rng, n=64):
    """The paper's §5.3 protocol (``tests/test_asm.py``): random 4×4 blocks
    box-upscaled to 8×8, as orthonormal zigzag coefficients."""
    small = rng.uniform(-1, 1, size=(n, 4, 4))
    big = np.kron(small, np.ones((2, 2)))
    return dctlib.dct2(big).reshape(n, 64)[:, dctlib.zigzag_permutation()]


def _q50():
    return dctlib.quantization_table(50)


#: name → (reference call, port call), each taking (coef, phi); the
#: JPEG-scaled variants take coefficients divided by q50's table
ASM_CASES = {
    "asm_relu": (lambda c, p: ref_asm.asm_relu(c, p),
                 lambda c, p: asmlib.asm_relu(c, p)),
    "asm_relu_qtable": (lambda c, p: ref_asm.asm_relu(c, p, _q50()),
                        lambda c, p: asmlib.asm_relu(c, p, _q50())),
    "asm_relu_qtable_bands": (
        lambda c, p: ref_asm.asm_relu(c, p, _q50(), bands=20),
        lambda c, p: asmlib.asm_relu(c, p, _q50(), bands=20)),
    "apx_relu": (lambda c, p: ref_asm.apx_relu(c, p),
                 lambda c, p: asmlib.apx_relu(c, p)),
    "apx_relu_qtable": (lambda c, p: ref_asm.apx_relu(c, p, _q50()),
                        lambda c, p: asmlib.apx_relu(c, p, _q50())),
    "asm_piecewise_relu": (
        lambda c, p: ref_asm.asm_piecewise(c, ref_asm.RELU, p),
        lambda c, p: asmlib.asm_piecewise(c, asmlib.RELU, p)),
    "asm_piecewise_leaky": (
        lambda c, p: ref_asm.asm_piecewise(c, ref_asm.LEAKY_RELU, p),
        lambda c, p: asmlib.asm_piecewise(c, asmlib.LEAKY_RELU, p)),
    "asm_piecewise_leaky_qtable": (
        lambda c, p: ref_asm.asm_piecewise(c, ref_asm.LEAKY_RELU, p,
                                           _q50()),
        lambda c, p: asmlib.asm_piecewise(c, asmlib.LEAKY_RELU, p, _q50())),
    "approx_spatial": (ref_asm.approx_spatial, asmlib.approx_spatial),
    "nonnegative_mask": (ref_asm.nonnegative_mask, asmlib.nonnegative_mask),
    "spatial_relu_oracle": (lambda c, p: ref_asm.spatial_relu_oracle(c),
                            lambda c, p: asmlib.spatial_relu_oracle(c)),
}


@pytest.mark.parametrize("phi", [1, 6, 14])
@pytest.mark.parametrize("name", list(ASM_CASES))
def test_asm_variants_match_reference(name, phi):
    coef = _rand_blocks(np.random.default_rng(phi), 128)
    if "qtable" in name:
        coef = coef / _q50()
    ref_c, c = _both(coef.astype(np.float32))
    ref_fn, fn = ASM_CASES[name]
    want = np.asarray(ref_fn(ref_c, phi))
    got = _np(fn(c, phi))
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "nonnegative_mask":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("bands", [64, 24])
@pytest.mark.parametrize("qtable", [False, True])
def test_asm_constants_match_reference(qtable, bands):
    q = _q50() if qtable else None
    for got, want in zip(asmlib.asm_constants(6, q, bands),
                         ref_asm.asm_constants(6, q, bands)):
        np.testing.assert_array_equal(got, want)
    assert asmlib.PiecewiseLinear._fields == ref_asm.PiecewiseLinear._fields
    assert tuple(asmlib.RELU) == tuple(ref_asm.RELU)
    assert tuple(asmlib.LEAKY_RELU) == tuple(ref_asm.LEAKY_RELU)


# --------------------------------------------------------------------------
# The paper's properties, on the port alone
# --------------------------------------------------------------------------


@pytest.mark.parametrize("phi", list(range(1, 15)))
def test_asm_beats_apx(phi):
    """Fig. 4a: ASM's RMSE against the exact ReLU is at most APX's at
    every φ."""
    c = torch.as_tensor(_rand_blocks(np.random.default_rng(0), 256))
    oracle = asmlib.spatial_relu_oracle(c)
    e_asm = float(((asmlib.asm_relu(c, phi) - oracle) ** 2).mean().sqrt())
    e_apx = float(((asmlib.apx_relu(c, phi) - oracle) ** 2).mean().sqrt())
    assert e_asm <= e_apx + 1e-9, (phi, e_asm, e_apx)


def test_asm_exact_at_all_bands_in_both_conventions():
    c = torch.as_tensor(_rand_blocks(np.random.default_rng(1)))
    np.testing.assert_allclose(_np(asmlib.asm_relu(c, asmlib.EXACT_PHI)),
                               _np(asmlib.spatial_relu_oracle(c)),
                               atol=1e-10)
    # JPEG-scaled coefficients: decode → ReLU → encode on the pixels
    q = _q50()
    cs = (c / torch.as_tensor(q)).reshape(64, 1, 1, 64)
    pixels = jpeglib.jpeg_decode(cs, qtable=q)
    want = jpeglib.jpeg_encode(torch.relu(pixels), qtable=q)
    np.testing.assert_allclose(
        _np(asmlib.asm_relu(cs, asmlib.EXACT_PHI, q)), _np(want), atol=1e-10)


def test_asm_piecewise_leaky_relu_on_the_decoded_pixels():
    c = torch.as_tensor(_rand_blocks(np.random.default_rng(2)))
    blocks = c.reshape(64, 1, 1, 64)
    pixels = jpeglib.jpeg_decode(blocks, scaled=False)
    want = jpeglib.jpeg_encode(torch.nn.functional.leaky_relu(pixels, 0.01),
                               scaled=False)
    got = asmlib.asm_piecewise(blocks, asmlib.LEAKY_RELU, asmlib.EXACT_PHI)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-10)


def test_gradient_through_the_full_operator_is_spatial_convs():
    """Algorithm 1 is exact for training too: by Parseval the squared sums
    agree, so dL/dK through ``explode_full`` → ``apply_full`` equals the
    spatial conv's (float64)."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 3, 16, 16)))
    coef = jpeglib.jpeg_encode(x, scaled=False).movedim(1, 3)
    k0 = torch.as_tensor(rng.normal(size=(2, 3, 3, 3)) * 0.3)
    for stride in (1, 2):
        k1 = k0.clone().requires_grad_(True)
        k2 = k0.clone().requires_grad_(True)
        op = convlib.explode_full(k1, 2, 2, stride)
        (convlib.apply_full(coef, op) ** 2).sum().backward()
        (convlib.spatial_conv(x, k2, stride) ** 2).sum().backward()
        np.testing.assert_allclose(_np(k1.grad), _np(k2.grad), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("out_scaled", [False, True])
def test_jpeg_conv_bias_is_the_spatial_bias(out_scaled):
    """A per-channel bias on DC is the same bias on every pixel."""
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(1, 3, 16, 16)).astype(np.float32))
    k = torch.as_tensor((rng.normal(size=(2, 3, 3, 3)) * 0.3).astype(
        np.float32))
    b = torch.as_tensor(rng.normal(size=(2,)).astype(np.float32))
    coef = jpeglib.jpeg_encode(x, scaled=False).movedim(1, 3)
    out = convlib.jpeg_conv(coef, k, 1, b, out_scaled=out_scaled)
    got = jpeglib.jpeg_decode(out.movedim(3, 1), scaled=out_scaled)
    np.testing.assert_allclose(_np(got),
                               _np(convlib.spatial_conv(x, k, 1, b)),
                               atol=1e-4)
