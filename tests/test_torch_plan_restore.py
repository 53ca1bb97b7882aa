"""Plan directories cross between the packages: the port's ``load_plan`` /
``load_compiled_plan`` read what the reference package's ``save_plan`` /
``save_compiled_plan`` wrote (plan format 2 with ``bn_scale`` and
``provenance``, compiled format 1 with ``vmem_bytes``), and the reference
reads what the port saves.

Reduced ``jpeg-resnet`` (widths 16/32/64), every parameter drawn by numpy
and handed to both packages, at 48 bands (``s2b0`` factored) and 16 bands
(every block fused).  Plan directories are deleted after each test: at
48 bands one holds ~0.3 GB.  Oracles: restored tensors equal the reference's own
restore bit for bit; the port's logits from a restored plan equal those
of the plan it builds in memory bit for bit, and the reference's within
1e-5 of the largest |logit|."""
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dispatch as ref_dsp
from repro.core import plan as ref_plan
from repro_torch.codec import ingest as ing
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan as plan
from repro_torch.core import resnet as resnet
from test_torch_plan import REF_SPEC, SPEC, _jax_tree, numpy_params

torch.set_num_threads(1)

#: port against reference logits, relative to the largest |logit|: fp32
#: sums in another order through five layers
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    params, state = numpy_params(SPEC)
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    coef = np.random.default_rng(3).normal(
        size=(2, 4, 4, 3, 64)).astype(np.float32)
    return params, state, tparams, tstate, coef


@pytest.fixture
def scratch(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", params=[48, 16])
def ref_dir(request, weights, tmp_path_factory):
    """A plan directory the reference package wrote (plan + compiled/)."""
    params, state, *_ = weights
    bands = request.param
    ref = ref_plan.build_plan(_jax_tree(params), _jax_tree(state), REF_SPEC,
                              dispatch=ref_dsp.DispatchConfig(bands=bands))
    d = tmp_path_factory.mktemp(f"ref_plan_{bands}")
    ref_plan.save_plan(ref, str(d))
    ref_plan.save_compiled_plan(ref_plan.compile_plan(ref),
                                str(d / "compiled"))
    yield bands, str(d)
    shutil.rmtree(d, ignore_errors=True)


def _port_plan(weights, bands):
    _, _, tparams, tstate, _ = weights
    return plan.build_plan(tparams, tstate, SPEC,
                           dispatch=dsp.DispatchConfig(bands=bands))


def _assert_same(got, want, what):
    if want is None:
        assert got is None, what
        return
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want), what


def test_reference_plan_restores_bit_exact(ref_dir):
    bands, d = ref_dir
    got = plan.load_plan(d, device="cpu")
    want = ref_plan.load_plan(d)
    _assert_same(got.head_w, want.head_w, "head.w")
    _assert_same(got.head_b, want.head_b, "head.b")
    ref_ops, ops = ref_plan._flat_ops(want), plan._flat_ops(got)
    assert sorted(ops) == sorted(ref_ops)
    for key, r in ref_ops.items():
        op = ops[key]
        for f in ("xi", "kernel", "scale", "shift", "bn_scale"):
            _assert_same(getattr(op, f), getattr(r, f), f"{key}.{f}")
        for f in ("stride", "bands", "quality", "in_scaled", "out_scaled"):
            assert getattr(op, f) == getattr(r, f), (key, f)
        assert op.path == dsp.canonical_path(r.path)
    assert got.bands == want.bands and got.phi == want.phi
    assert tuple(got.spec) == tuple(want.spec)
    assert got.provenance == want.provenance
    assert got.cfg.bands == want.cfg.bands == bands


def test_reference_compiled_plan_restores_bit_exact(ref_dir):
    bands, d = ref_dir
    got = plan.load_compiled_plan(d + "/compiled", device="cpu")
    want = ref_plan.load_compiled_plan(d + "/compiled")
    assert [b.name for b in got.blocks] == [b.name for b in want.blocks]
    assert got.meta["fused"] == want.meta["fused"]
    assert got.meta["path"] == dsp.canonical_path(want.meta["path"])
    # the TPU budget rides along in meta, unused
    assert got.meta["vmem"] == {b.name: b.vmem_bytes for b in want.blocks
                                if b.kind == "fused"}
    assert sorted(got.meta["smem"]) == got.meta["fused"]
    _assert_same(got.stem.conv.xi, want.stem.conv.xi, "stem.conv.xi")
    _assert_same(got.stem.asm.cat, want.stem.asm.cat, "stem.asm.cat")
    for gb, wb in zip(got.blocks, want.blocks):
        assert tuple(gb[:8]) == tuple(wb[:8])
        for slot in ("conv1", "conv2", "proj"):
            g, w = getattr(gb, slot), getattr(wb, slot)
            assert (g is None) == (w is None)
            if g is not None:
                _assert_same(g.xi, w.xi, f"{gb.name}.{slot}.xi")
                _assert_same(g.shift, w.shift, f"{gb.name}.{slot}.shift")
                assert tuple(g[2:]) == tuple(w[2:])
        for slot in ("asm_mid", "asm_out"):
            g, w = getattr(gb, slot), getattr(wb, slot)
            if g is not None:
                _assert_same(g.cat, w.cat, f"{gb.name}.{slot}.cat")
                _assert_same(g.recon_t, w.recon_t, f"{gb.name}.{slot}.rt")
        for slot, op in wb.ops.items():
            _assert_same(gb.ops[slot].kernel, op.kernel, f"{gb.name}.{slot}")


def test_restored_logits_match_in_memory_plan_and_reference(ref_dir, weights):
    """The port serves a reference plan directory with the logits of the
    plan it builds itself (bit for bit), through the packed entry the
    server uses, and within LOGIT_RTOL of the reference's own walk."""
    bands, d = ref_dir
    coef = weights[4]
    cp = plan.load_compiled_plan(d + "/compiled", device="cpu")
    mine = plan.compile_plan(_port_plan(weights, bands))
    packed = torch.as_tensor(ing.pack_tiles(coef, cp.stem.w_in))
    got = plan.apply_compiled_packed(cp, packed)
    assert torch.equal(got, plan.apply_compiled_packed(mine, packed))
    want = np.asarray(ref_plan.apply_compiled_packed(
        ref_plan.load_compiled_plan(d + "/compiled"),
        jnp.asarray(packed.numpy())))
    err = np.abs(got.numpy() - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), err
    walk = plan.apply_plan(plan.load_plan(d, device="cpu"),
                           torch.as_tensor(coef))
    assert torch.equal(walk, plan.apply_plan(_port_plan(weights, bands),
                                             torch.as_tensor(coef)))


@pytest.mark.parametrize("bands", [48, 16])
def test_reference_reads_the_ports_plan_dirs(weights, scratch, bands):
    """The port writes the reference's formats: the reference package
    restores both directories, with ``cuda`` spelled ``pallas``, and its
    walks agree with the port's within LOGIT_RTOL."""
    coef = weights[4]
    port = plan.build_plan(weights[2], weights[3], SPEC,
                           dispatch=dsp.DispatchConfig(path="cuda",
                                                       bands=bands))
    cp = plan.compile_plan(port)
    plan.save_plan(port, str(scratch))
    plan.save_compiled_plan(cp, str(scratch / "compiled"))
    ref = ref_plan.load_plan(str(scratch))
    rcp = ref_plan.load_compiled_plan(str(scratch / "compiled"))
    assert ref.cfg.path == "pallas" and ref.bands == port.bands
    assert {op.path for op in ref_plan._flat_ops(ref).values()} <= {
        "pallas", "factored"}
    assert [b.name for b in rcp.blocks] == [b.name for b in cp.blocks]
    for got, want in ((ref_plan.apply_plan(ref, jnp.asarray(coef)),
                       plan.apply_plan(port, torch.as_tensor(coef))),
                      (ref_plan.apply_compiled(rcp, jnp.asarray(coef)),
                       plan.apply_compiled(cp, torch.as_tensor(coef)))):
        got, want = np.asarray(got), want.numpy()
        assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_port_roundtrip_is_bit_exact(weights, scratch):
    coef = torch.as_tensor(weights[4])
    port = _port_plan(weights, 24)
    cp = plan.compile_plan(port)
    plan.save_plan(port, str(scratch))
    plan.save_compiled_plan(cp, str(scratch / "compiled"))
    again = plan.load_plan(str(scratch), device="cpu")
    cp2 = plan.load_compiled_plan(str(scratch / "compiled"), device="cpu")
    assert again.provenance == port.provenance
    assert cp2.meta["smem"] == cp.meta["smem"]
    assert torch.equal(plan.apply_plan(again, coef),
                       plan.apply_plan(port, coef))
    assert torch.equal(plan.apply_compiled(cp2, coef),
                       plan.apply_compiled(cp, coef))


def test_earlier_port_format_still_loads(weights, scratch, monkeypatch):
    """Directories in the port's earlier ``repro_torch/1`` format (no
    ``bn_scale``, ``cuda`` spelled as such) still restore."""
    port = _port_plan(weights, 24)
    cp = plan.compile_plan(port)
    monkeypatch.setattr(plan, "_PLAN_FORMAT", "repro_torch/1")
    monkeypatch.setattr(plan, "_COMPILED_FORMAT", "repro_torch/1")
    monkeypatch.setattr(plan, "_OP_ARRAYS", ("xi", "kernel", "scale",
                                             "shift"))
    monkeypatch.setattr(plan, "_ref_path", lambda p: p)
    plan.save_plan(port, str(scratch))
    plan.save_compiled_plan(cp, str(scratch / "compiled"))
    monkeypatch.undo()
    coef = torch.as_tensor(weights[4])
    again = plan.load_plan(str(scratch), device="cpu")
    assert all(op.bn_scale is None
               for op in plan._flat_ops(again).values())
    assert torch.equal(plan.apply_plan(again, coef),
                       plan.apply_plan(port, coef))
    cp2 = plan.load_compiled_plan(str(scratch / "compiled"), device="cpu")
    # without bn_scale the spatial lowering cannot run: a restored
    # repro_torch/1 plan serves the packed GEMM, as the port did then
    assert torch.equal(plan.apply_compiled(cp2, coef),
                       plan.apply_compiled(cp, coef, executor="gemm"))


def test_bn_scale_kept_as_the_reference_keeps_it(weights):
    params, state, *_ = weights
    ref = ref_plan.build_plan(_jax_tree(params), _jax_tree(state), REF_SPEC,
                              dispatch=ref_dsp.DispatchConfig(bands=64))
    port = _port_plan(weights, 64)
    for key, r in ref_plan._flat_ops(ref).items():
        op = plan._flat_ops(port)[key]
        if r.bn_scale is None:
            assert op.bn_scale is None, key
        else:
            np.testing.assert_allclose(op.bn_scale.numpy(),
                                       np.asarray(r.bn_scale), rtol=1e-6)


def test_pallas_is_cuda_and_the_global_config(monkeypatch):
    """``pallas`` names the port's ``cuda`` path; ``JPEG_DISPATCH`` /
    ``JPEG_BANDS`` are parsed on first use, ``configure`` replaces the
    global config and ``override`` scopes a change."""
    assert dsp.DispatchConfig(path="pallas").path == "cuda"
    monkeypatch.setattr(dsp, "_CONFIG", None)
    monkeypatch.setenv("JPEG_DISPATCH", "pallas")
    monkeypatch.setenv("JPEG_BANDS", "24")
    assert dsp.get_config() == dsp.DispatchConfig(path="cuda", bands=24)
    with dsp.override(path="reference") as cfg:
        assert dsp.resolve_config(None) is cfg and cfg.bands == 24
    assert dsp.get_config().path == "cuda"
    assert dsp.configure(bands=16).bands == 16
    assert dsp.resolve_config(None).bands == 16
    mine = dsp.DispatchConfig(bands=8)
    assert dsp.resolve_config(mine) is mine
    monkeypatch.setattr(dsp, "_CONFIG", None)
    monkeypatch.setenv("JPEG_BANDS", "65")
    with pytest.raises(ValueError, match="bands must be in"):
        dsp.get_config()
    monkeypatch.setattr(dsp, "_CONFIG", None)
