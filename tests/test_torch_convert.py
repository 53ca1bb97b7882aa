"""The port's model conversion (``repro_torch.core.convert``, paper §4.6)
against the reference package's, on the reduced spec of
``tests/test_resnet_conversion.py`` (widths 8/16/24, 32 px), every
parameter drawn by numpy (non-trivial batch norms) and handed to both.

Oracles, each with its tolerance:

* ``convert_and_verify``: spatial against JPEG logits below 1e-4 (the
  reference's ``atol``), the pixels encoded by the block-DCT kernel's
  plain version; the converted model's logits within 1e-5 of the largest
  |logit| of the reference's on the same coefficients (fp32 sums in
  another order);
* the unfused walk (``fuse_bn=False`` → ``jpeg_apply_precomputed``) the
  same, and fused operators fed to it raise ``ValueError``;
* at φ = 14, 10, 6 each deviation within 1e-5 of the reference's, and
  growing as the reference's do;
* ``from_torch_layout``: the reference's pytree, exactly;
* ``compile_for_inference`` → ``apply_compiled`` within 1e-5 of the largest
  |logit| of ``apply_plan`` on the same plan.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import convert as ref_convert
from repro.core import dispatch as ref_dsp
from repro.core import jpeg as ref_jpeg
from repro.core import resnet as ref_resnet
from repro_torch.core import convert
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan
from repro_torch.core import resnet
from test_torch_plan import _jax_tree, numpy_params

torch.set_num_threads(1)

SPEC = resnet.ResNetSpec(widths=(8, 16, 24), num_classes=10)
REF_SPEC = ref_resnet.ResNetSpec(widths=(8, 16, 24), num_classes=10)
#: the reference's conversion contract (paper Table 1)
ATOL = 1e-4
#: the port against the reference, relative to the largest |logit|
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def model():
    params, state = numpy_params(SPEC)
    x = (np.random.default_rng(1).normal(size=(4, 3, 32, 32))
         * 0.5).astype(np.float32)
    coef = np.array(jnp.moveaxis(ref_jpeg.jpeg_encode(
        jnp.asarray(x), quality=SPEC.quality, scaled=True), 1, 3))
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    return params, state, tparams, tstate, x, coef


def test_convert_and_verify_matches_reference(model):
    params, state, tparams, tstate, x, coef = model
    port, dev = convert.convert_and_verify(tparams, tstate, SPEC,
                                           torch.as_tensor(x))
    ref, ref_dev = ref_convert.convert_and_verify(
        _jax_tree(params), _jax_tree(state), REF_SPEC, jnp.asarray(x))
    assert dev < ATOL and ref_dev < ATOL
    assert port.plan is not None and port.dispatch == dsp.get_config()
    with torch.inference_mode():
        got = port(torch.as_tensor(coef))
    _close(got, ref(jnp.asarray(coef)))


def test_convert_and_verify_raises_past_atol(model):
    params, state, tparams, tstate, x, coef = model
    with pytest.raises(ValueError, match="verification failed"):
        convert.convert_and_verify(tparams, tstate, SPEC, torch.as_tensor(x),
                                   atol=1e-12)


def test_unfused_precomputed_matches_reference(model):
    params, state, tparams, tstate, x, coef = model
    port = convert.convert(tparams, tstate, SPEC,
                           dispatch=dsp.DispatchConfig(bands=32),
                           fuse_bn=False)
    assert port.plan is None and port.operators["stem"].shift is None
    ref = ref_convert.convert(
        _jax_tree(params), _jax_tree(state), REF_SPEC,
        dispatch=ref_dsp.DispatchConfig(path="reference", bands=32),
        fuse_bn=False)
    with torch.inference_mode():
        got = port(torch.as_tensor(coef))
        assert torch.equal(got, resnet.jpeg_apply_precomputed(
            tparams, tstate, port.operators, torch.as_tensor(coef),
            spec=SPEC, dispatch=port.dispatch))
    _close(got, ref(jnp.asarray(coef)))


def test_apply_operators_rejects_fused_operators(model):
    params, state, tparams, tstate, x, coef = model
    fused = convert.convert(tparams, tstate, SPEC)
    with pytest.raises(ValueError, match="BN twice"):
        resnet.jpeg_apply_precomputed(tparams, tstate, fused.operators,
                                      torch.as_tensor(coef), spec=SPEC)


@pytest.fixture(scope="module")
def phi_devs(model):
    """Per φ: the port's and the reference's spatial-vs-JPEG deviation."""
    params, state, tparams, tstate, x, coef = model
    out = {}
    for phi in (14, 10, 6):
        port, dev = convert.convert_and_verify(tparams, tstate, SPEC,
                                               torch.as_tensor(x), phi=phi)
        ref, ref_dev = ref_convert.convert_and_verify(
            _jax_tree(params), _jax_tree(state), REF_SPEC, jnp.asarray(x),
            phi=phi)
        out[phi] = (dev, ref_dev)
    return out


@pytest.mark.parametrize("phi", [14, 10, 6])
def test_phi_deviation_matches_reference(phi_devs, phi):
    dev, ref_dev = phi_devs[phi]
    assert abs(dev - ref_dev) <= RTOL * max(1.0, ref_dev), (dev, ref_dev)


def test_phi_deviation_grows_as_the_references(phi_devs):
    """Paper Fig. 4b: fewer spatial frequencies, larger deviation."""
    devs = [phi_devs[p][0] for p in (14, 10, 6)]
    ref = [phi_devs[p][1] for p in (14, 10, 6)]
    assert devs[0] < ATOL
    assert devs[0] <= devs[1] + 1e-6 <= devs[2] + 2e-6
    assert ref[0] <= ref[1] + 1e-6 <= ref[2] + 2e-6


def _torch_layout(params, state):
    """The numpy parameters in torch's ResNet naming and layout."""
    out = {"stem.weight": params["stem"]["kernel"]}

    def bn(src, dst):
        out[f"{dst}.weight"] = params[src]["gamma"]
        out[f"{dst}.bias"] = params[src]["beta"]
        out[f"{dst}.running_mean"] = state[src]["mean"]
        out[f"{dst}.running_var"] = state[src]["var"]

    bn("stem_bn", "stem_bn")
    for name, s, cin, w in resnet._stages(SPEC):
        for conv in ("conv1", "conv2", "proj"):
            if conv in params[name]:
                out[f"{name}.{conv}.weight"] = params[name][conv]
        bn(f"{name}_bn1", f"{name}.bn1")
        bn(f"{name}_bn2", f"{name}.bn2")
    out["head.weight"] = params["head"]["w"].T
    out["head.bias"] = params["head"]["b"]
    return out


@pytest.mark.parametrize("as_torch", [False, True])
def test_from_torch_layout_equals_the_references_tree(model, as_torch):
    params, state = model[:2]
    tensors = _torch_layout(params, state)
    ref_p, ref_s = ref_convert.from_torch_layout(tensors, REF_SPEC)
    if as_torch:
        tensors = {k: torch.as_tensor(v) for k, v in tensors.items()}
    got_p, got_s = convert.from_torch_layout(tensors, SPEC, device="cpu")

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, np.asarray(v)

    for got, want in ((got_p, ref_p), (got_s, ref_s)):
        g, w = dict(flat(got)), dict(flat(want))
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == np.float32 and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("bands", [None, 16])
def test_compile_for_inference_matches_apply_plan(model, bands):
    params, state, tparams, tstate, x, coef = model
    cp = resnet.compile_for_inference(tparams, tstate, SPEC, bands=bands)
    p = plan.build_plan(tparams, tstate, SPEC, bands=bands)
    assert cp.bands == p.bands
    with torch.inference_mode():
        got = plan.apply_compiled(cp, torch.as_tensor(coef))
        want = plan.apply_plan(p, torch.as_tensor(coef))
    _close(got, want)
