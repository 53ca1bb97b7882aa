"""The port's compiled-plan lowerings against the reference package's, on
the reduced ``jpeg-resnet`` (32 px, widths 16/32/64) with every parameter
drawn by numpy and handed to both packages, on the CPU.

Oracles, each relative to max(1, the largest |logit|) (or |value|):

* ``fused_block_spatial`` / ``fused_stem_spatial`` against the
  reference's on the same block and input: 1e-5 (fp32 sums in another
  order through two convs);
* the ``reference``-path compiled plan (``executor=None``: the spatial
  lowering for the packed stem and every fused block) against the
  reference's default executor off-TPU: 2e-4, top-1 equal (ROADMAP
  5(b)'s oracle, the tolerance of ``test_torch_plan.py``);
* ``executor="gemm"`` against the reference's ``executor="gemm"``: 1e-5
  (ROADMAP 5(c)'s oracle);
* folding ``compiled_steps`` and a ``StepProfile`` walk are bit-identical
  to the whole walk, for both executors, packed and unpacked;
* ``dispatch.fused_lowering`` routes as the reference's dispatch does.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dispatch as ref_dsp
from repro.core import jpeg as ref_jpeg
from repro.core import plan as ref_plan
from repro.kernels import fused_block as ref_fb
from repro_torch.codec import ingest as ing
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan
from repro_torch.core import resnet
from repro_torch.kernels import fused_block as kfb
from repro_torch.kernels.tiling import fit_width
from test_torch_plan import REF_SPEC, SPEC, _jax_tree, numpy_params

torch.set_num_threads(1)

#: the spatial lowering, block by block, against the reference's
SPATIAL_RTOL = 1e-5
#: the reference-path plan against the reference's (ROADMAP 5(b))
PLAN_RTOL = 2e-4
#: the packed-GEMM lowering against the reference's (ROADMAP 5(c))
GEMM_RTOL = 1e-5


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def model():
    params, state = numpy_params(SPEC)
    x = np.random.default_rng(4).normal(size=(3, 3, 32, 32)) * 0.5
    coef = np.array(jnp.moveaxis(ref_jpeg.jpeg_encode(
        jnp.asarray(x, jnp.float32), quality=50, scaled=True), 1, 3))
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    return params, state, tparams, tstate, coef


@pytest.fixture(scope="module", params=[64, 16])
def plans(model, request):
    """Both packages' compiled plans at one band budget, compiled on the
    CPU (the ``reference`` path): at 64 bands s0b0 and s1b0 fuse and s2b0
    walks per layer, at 16 every block fuses."""
    params, state, tparams, tstate, coef = model
    bands = request.param
    ref = ref_plan.build_plan(_jax_tree(params), _jax_tree(state), REF_SPEC,
                              dispatch=ref_dsp.DispatchConfig(bands=bands))
    port = plan.build_plan(tparams, tstate, SPEC,
                           dispatch=dsp.DispatchConfig(bands=bands))
    rcp, pcp = ref_plan.compile_plan(ref), plan.compile_plan(port)
    assert pcp.meta["path"] == "reference" and pcp.meta["fused"]
    return rcp, pcp, coef


def _inputs(pcp, coef, packed):
    if packed:
        return ing.pack_tiles(coef, pcp.stem.w_in)
    return coef


# --------------------------------------------------------------------------
# The spatial lowering, block by block
# --------------------------------------------------------------------------


def test_fused_block_spatial_matches_reference(plans):
    """Each fused block on the input the schedule gives it."""
    rcp, pcp, coef = plans
    steps = plan.compiled_steps(pcp)
    h = steps[0][1](torch.as_tensor(coef))
    fused = 0
    for (_name, fn), pblk, rblk in zip(steps[1:-1], pcp.blocks, rcp.blocks):
        if pblk.kind == "fused":
            x = fit_width(h, pblk.cin, pblk.w_in)
            got = kfb.fused_block_spatial(x, pblk, pcp.phi)
            want = ref_fb.fused_block_spatial(jnp.asarray(x.numpy()), rblk,
                                              rcp.phi)
            _close(got.numpy(), want, SPATIAL_RTOL)
            fused += 1
        h = fn(h)
    assert fused == len(pcp.meta["fused"])


def test_fused_stem_spatial_matches_reference(plans):
    rcp, pcp, coef = plans
    st = pcp.stem
    got = kfb.fused_stem_spatial(torch.as_tensor(coef), st.op, pcp.phi,
                                 st.w_out)
    want = ref_fb.fused_stem_spatial(jnp.asarray(coef), rcp.stem.op,
                                     rcp.phi, rcp.stem.w_out)
    _close(got.numpy(), want, SPATIAL_RTOL)


# --------------------------------------------------------------------------
# Whole plans, both executors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_reference_path_plan_matches_reference(plans, packed):
    rcp, pcp, coef = plans
    x = _inputs(pcp, coef, packed)
    p_fn = plan.apply_compiled_packed if packed else plan.apply_compiled
    r_fn = (ref_plan.apply_compiled_packed if packed
            else ref_plan.apply_compiled)
    got = p_fn(pcp, torch.as_tensor(x)).numpy()
    want = np.asarray(r_fn(rcp, jnp.asarray(x)))
    _close(got, want, PLAN_RTOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("packed", [False, True])
def test_gemm_executor_matches_reference(plans, packed):
    rcp, pcp, coef = plans
    x = _inputs(pcp, coef, packed)
    p_fn = plan.apply_compiled_packed if packed else plan.apply_compiled
    r_fn = (ref_plan.apply_compiled_packed if packed
            else ref_plan.apply_compiled)
    got = p_fn(pcp, torch.as_tensor(x), executor="gemm").numpy()
    want = np.asarray(r_fn(rcp, jnp.asarray(x), executor="gemm"))
    _close(got, want, GEMM_RTOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_the_two_lowerings_differ_and_agree(plans):
    """The spatial and GEMM lowerings are two computations of one
    function: not the same floats, the same logits within PLAN_RTOL."""
    _, pcp, coef = plans
    x = torch.as_tensor(coef)
    spatial = plan.apply_compiled(pcp, x)
    gemm = plan.apply_compiled(pcp, x, executor="gemm")
    assert not torch.equal(spatial, gemm)
    _close(spatial.numpy(), gemm.numpy(), PLAN_RTOL)


# --------------------------------------------------------------------------
# Step list and profiler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("executor", [None, "gemm"])
@pytest.mark.parametrize("packed", [False, True])
def test_compiled_steps_fold_is_the_walk(plans, executor, packed):
    _, pcp, coef = plans
    x = torch.as_tensor(_inputs(pcp, coef, packed))
    steps = plan.compiled_steps(pcp, executor=executor, packed=packed)
    assert [n for n, _ in steps] == (
        ["stem"] + [b.name for b in pcp.blocks] + ["head"])
    h = x
    for _name, fn in steps:
        h = fn(h)
    p_fn = plan.apply_compiled_packed if packed else plan.apply_compiled
    assert torch.equal(h, p_fn(pcp, x, executor=executor))


@pytest.mark.parametrize("executor", [None, "gemm"])
@pytest.mark.parametrize("packed", [False, True])
def test_step_profile_logits_are_bit_identical(plans, executor, packed):
    _, pcp, coef = plans
    x = torch.as_tensor(_inputs(pcp, coef, packed))
    p_fn = plan.apply_compiled_packed if packed else plan.apply_compiled
    prof = plan.StepProfile()
    a = p_fn(pcp, x, executor=executor, profile=prof)
    b = p_fn(pcp, x, executor=executor, profile=prof)
    assert torch.equal(a, p_fn(pcp, x, executor=executor))
    assert torch.equal(a, b) and prof.calls == 2
    summary = prof.summary()
    assert list(summary) == ["stem"] + [b.name for b in pcp.blocks] + [
        "head"]
    assert all(len(v) == 2 for v in prof.samples.values())
    assert prof.total_s() == pytest.approx(sum(summary.values()))
    prof.reset()
    assert prof.calls == 0 and not prof.summary()


def test_unknown_executor_raises(plans):
    _, pcp, coef = plans
    with pytest.raises(ValueError, match="executor"):
        plan.apply_compiled(pcp, torch.as_tensor(coef), executor="spatial")


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("path,cfg_path,executor,want", [
    ("reference", "auto", None, "spatial"),
    ("reference", "auto", "gemm", "gemm"),
    ("factored", "auto", None, "spatial"),
    (None, "factored", None, "spatial"),
    (None, "auto", None, "spatial"),
    ("cuda", "auto", None, "gemm"),
    ("cuda", "reference", None, "gemm"),
    ("cuda", "auto", "gemm", "gemm"),
])
def test_fused_lowering_routes_as_the_reference(path, cfg_path, executor,
                                                want):
    """On the CPU: a ``reference`` (or factored, or unresolved) block runs
    the spatial lowering, as the reference's ``_fused_reference``; a
    ``cuda`` block runs the kernels' plain twin (the kernels need a CUDA
    tensor); ``gemm`` forces the twin."""
    cfg = dsp.DispatchConfig(path=cfg_path)
    assert dsp.fused_lowering(path, cfg, device=torch.device("cpu"),
                              executor=executor) == want


def test_cuda_plan_on_the_cpu_runs_the_gemm_twin(model):
    """A ``cuda``-path plan applied to CPU tensors runs the kernels' plain
    twin whatever the executor: bit-identical to ``executor="gemm"``."""
    *_, tparams, tstate, coef = model
    port = plan.build_plan(tparams, tstate, SPEC,
                           dispatch=dsp.DispatchConfig(path="cuda",
                                                       bands=16))
    cp = plan.compile_plan(port)
    x = torch.as_tensor(coef)
    assert torch.equal(plan.apply_compiled(cp, x),
                       plan.apply_compiled(cp, x, executor="gemm"))
