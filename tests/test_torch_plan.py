"""The port's plan against the reference package's on the reduced
``jpeg-resnet`` config (32 px, widths 16/32/64, one block per stage),
with every parameter drawn by numpy (non-trivial batch norms included)
and handed to both packages.

At 64 and 48 bands ``s0b0`` is fused with an identity shortcut, ``s1b0``
fused with stride 2 and a projection, and ``s2b0`` is factored and takes
the per-layer walk; at 16 bands every block is fused.  Logits agree
within 2e-4 (``test_fused_block.py``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dispatch as ref_dsp
from repro.core import jpeg as ref_jpeg
from repro.core import plan as ref_plan
from repro.core import resnet as ref_resnet
from repro_torch.codec import ingest as ing
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan as plan
from repro_torch.core import resnet as resnet
from repro_torch.kernels import asm_relu as kasm
from repro_torch.kernels import fused_block as kfb
from repro_torch.kernels import jpeg_conv as kjc

# one intra-op thread: the suite runs in parallel workers beside
# wall-clock tests of the reference package
torch.set_num_threads(1)

SPEC = resnet.ResNetSpec(widths=(16, 32, 64), num_classes=10)
REF_SPEC = ref_resnet.ResNetSpec(widths=(16, 32, 64), num_classes=10)


def numpy_params(spec, seed=0):
    rng = np.random.default_rng(seed)
    params, state = {}, {}

    def conv(cout, cin, r):
        return (rng.normal(size=(cout, cin, r, r))
                * np.sqrt(2.0 / (cin * r * r))).astype(np.float32)

    def bn(name, c):
        params[name] = {
            "gamma": (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32),
            "beta": (0.1 * rng.normal(size=c)).astype(np.float32)}
        state[name] = {
            "mean": (0.1 * rng.normal(size=c)).astype(np.float32),
            "var": (1.0 + 0.3 * rng.uniform(size=c)).astype(np.float32)}

    params["stem"] = {"kernel": conv(spec.widths[0], spec.in_channels, 3)}
    bn("stem_bn", spec.widths[0])
    for name, s, cin, w in resnet._stages(spec):
        params[name] = {"conv1": conv(w, cin, 3), "conv2": conv(w, w, 3)}
        if s != 1 or cin != w:
            params[name]["proj"] = conv(w, cin, 1)
        bn(name + "_bn1", w)
        bn(name + "_bn2", w)
    c = spec.widths[-1]
    params["head"] = {"w": (rng.normal(size=(c, spec.num_classes))
                            / np.sqrt(c)).astype(np.float32),
                      "b": (0.1 * rng.normal(size=spec.num_classes)
                            ).astype(np.float32)}
    return params, state


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.fixture(scope="module")
def model():
    params, state = numpy_params(SPEC)
    x = np.random.default_rng(1).normal(size=(2, 3, 32, 32)) * 0.5
    coef = np.array(jnp.moveaxis(ref_jpeg.jpeg_encode(
        jnp.asarray(x, jnp.float32), quality=50, scaled=True), 1, 3))
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    return params, state, tparams, tstate, coef


def _plans(model, bands, path="auto"):
    params, state, tparams, tstate, coef = model
    ref = ref_plan.build_plan(_jax_tree(params), _jax_tree(state), REF_SPEC,
                              dispatch=ref_dsp.DispatchConfig(bands=bands))
    port = plan.build_plan(tparams, tstate, SPEC,
                           dispatch=dsp.DispatchConfig(path=path,
                                                       bands=bands))
    return ref, port


def _schedule(cp):
    st = cp.stem
    blocks = [(b.kind, b.name, b.cin, b.cout, b.w_in, b.w_out, b.bands_in,
               b.bands_out) for b in cp.blocks]
    return (st.kind, st.w_in, st.w_out, st.bands_out, blocks,
            cp.meta["fused"], sorted(cp.meta["layers"]))


@pytest.mark.parametrize("bands", [64, 48, 16])
def test_schedule_equals_reference(model, bands):
    ref, port = _plans(model, bands)
    rcp, pcp = ref_plan.compile_plan(ref), plan.compile_plan(port)
    assert _schedule(pcp) == _schedule(rcp)
    assert port.bands == ref.bands
    want_fused = ["s0b0", "s1b0", "s2b0"] if bands == 16 else ["s0b0",
                                                                "s1b0"]
    assert pcp.meta["fused"] == want_fused
    assert set(pcp.meta["smem"]) == set(want_fused)
    for r, p in zip(rcp.blocks, pcp.blocks):
        if r.kind == "fused":
            np.testing.assert_allclose(p.conv1.xi.numpy(),
                                       np.asarray(r.conv1.xi),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bands", [64, 16])
@pytest.mark.parametrize("path", ["auto", "cuda"])
def test_compiled_packed_logits_match_reference(model, bands, path):
    """The compiled schedule from the tile-packed stem input, against the
    reference package's gemm executor and its default one."""
    coef = model[4]
    ref, port = _plans(model, bands, path)
    rcp, pcp = ref_plan.compile_plan(ref), plan.compile_plan(port)
    packed = ing.pack_tiles(coef, pcp.stem.w_in)
    got = plan.apply_compiled_packed(pcp, torch.as_tensor(packed)).numpy()
    for executor in ("gemm", None):
        want = np.asarray(ref_plan.apply_compiled_packed(
            rcp, jnp.asarray(packed), executor=executor))
        np.testing.assert_allclose(got, want, atol=2e-4)
        assert (got.argmax(-1) == want.argmax(-1)).all()
    full = plan.apply_compiled(pcp, torch.as_tensor(coef)).numpy()
    np.testing.assert_allclose(full, got, atol=2e-4)


@pytest.mark.parametrize("bands", [64, 16])
def test_apply_plan_logits_match_reference(model, bands):
    coef = model[4]
    ref, port = _plans(model, bands)
    want = np.asarray(ref_plan.apply_plan(ref, jnp.asarray(coef)))
    got = plan.apply_plan(port, torch.as_tensor(coef)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_apply_plan_matches_pallas_walk(model):
    """The per-layer walk against the reference walk through its Pallas
    kernels (interpret mode) at 16 bands, where every conv is
    materialised and every ReLU goes through the ASM kernel."""
    params, state, tparams, tstate, coef = model
    ref = ref_plan.build_plan(
        _jax_tree(params), _jax_tree(state), REF_SPEC,
        dispatch=ref_dsp.DispatchConfig(path="pallas", bands=16,
                                        interpret=True))
    port = plan.build_plan(tparams, tstate, SPEC,
                           dispatch=dsp.DispatchConfig(path="cuda", bands=16))
    want = np.asarray(ref_plan.apply_plan(ref, jnp.asarray(coef)))
    got = plan.apply_plan(port, torch.as_tensor(coef)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_reference_runtime_config_matches_kernel_path(model):
    """``DispatchConfig(path="reference")`` at apply time runs the plain
    versions on the same operators; on the CPU both are the same math,
    and no kernel counts a launch."""
    coef = torch.as_tensor(model[4])
    _, port = _plans(model, 48, "cuda")
    cp = plan.compile_plan(port)
    before = (kasm.LAUNCHES, kjc.LAUNCHES, kfb.LAUNCHES)
    a = plan.apply_compiled(cp, coef)
    b = plan.apply_compiled(cp, coef, dsp.DispatchConfig(path="reference"))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert (kasm.LAUNCHES, kjc.LAUNCHES, kfb.LAUNCHES) == before


def test_init_resnet_is_seeded_and_shaped():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    p1, s1 = resnet.init_resnet(g1, SPEC, device="cpu")
    p2, _ = resnet.init_resnet(g2, SPEC, device="cpu")
    ref, _ = numpy_params(SPEC)
    assert p1.keys() == ref.keys() and s1.keys() == set(
        k for k in ref if "bn" in k)
    for k in ref:
        for leaf in ref[k]:
            assert tuple(p1[k][leaf].shape) == ref[k][leaf].shape
            torch.testing.assert_close(p1[k][leaf], p2[k][leaf])


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet.init_resnet(torch.Generator(), SPEC)
