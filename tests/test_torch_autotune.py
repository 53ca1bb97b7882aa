"""The port's per-layer band autotuning (``repro_torch.core.plan``) against
the reference package's, on the reduced spec (widths 8/16/24, 32 px) with
every parameter drawn by numpy.

* ``qtable_band_energy``, ``bands_for_budget`` and ``bands_for_profile``
  equal the reference's over qualities {25, 50, 75, 95} and budgets {0.5,
  0.8, 0.9, 0.95, 0.99}, the profiles ``IngestStats.energy`` of the
  committed codec fixtures;
* ``autotune_bands`` with a probe batch gives the reference's per-layer
  dict at the sweep's default ``tol`` (5e-2) and at 0.3.  Each sweep's
  parity margins (``tol`` minus each trial's deviation) are printed, the
  smallest first: a margin within fp32 rounding of zero could decide a
  step differently in the two packages;
* ``build_plan(bands="auto")`` records the reference's provenance, which
  survives save → load across the two packages in both directions;
* ``serve --autotune-bands --plan-dir`` rebuilds a directory that holds a
  plan that was not autotuned, and a second run restores it.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import jpeg as ref_jpeg
from repro.core import plan as ref_plan
from repro.core import resnet as ref_resnet
from repro_torch.codec import ingest as ing
from repro_torch.core import plan
from repro_torch.core import resnet
from test_torch_plan import _jax_tree, numpy_params

torch.set_num_threads(1)

SPEC = resnet.ResNetSpec(widths=(8, 16, 24), num_classes=10)
REF_SPEC = ref_resnet.ResNetSpec(widths=(8, 16, 24), num_classes=10)
QUALITIES = (25, 50, 75, 95)
BUDGETS = (0.5, 0.8, 0.9, 0.95, 0.99)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "codec")
FIXTURES = sorted(n for n in os.listdir(FIXDIR) if n.endswith(".jpg"))


def _energy(name):
    with open(os.path.join(FIXDIR, name), "rb") as f:
        data = f.read()
    _, stats = ing.ingest_batch([data], quality=50)
    return stats


@pytest.fixture(scope="module")
def model():
    params, state = numpy_params(SPEC)
    x = (np.random.default_rng(1).normal(size=(2, 3, 32, 32))
         * 0.5).astype(np.float32)
    coef = np.array(jnp.moveaxis(ref_jpeg.jpeg_encode(
        jnp.asarray(x), quality=SPEC.quality, scaled=True), 1, 3))
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    return _jax_tree(params), _jax_tree(state), tparams, tstate, coef


@pytest.mark.parametrize("quality", QUALITIES)
def test_band_budget_equals_the_references(quality):
    got = plan.qtable_band_energy(quality)
    assert np.array_equal(got, ref_plan.qtable_band_energy(quality))
    assert not got.flags.writeable
    picks = [plan.bands_for_budget(quality, b) for b in BUDGETS]
    assert picks == [ref_plan.bands_for_budget(quality, b) for b in BUDGETS]
    assert picks == sorted(picks)


@pytest.mark.parametrize("name", FIXTURES)
def test_bands_for_profile_equals_the_references(name):
    energy = _energy(name).energy
    picks = [plan.bands_for_profile(energy, b) for b in BUDGETS]
    assert picks == [ref_plan.bands_for_profile(energy, b) for b in BUDGETS]
    assert picks == sorted(picks)


def test_budget_and_profile_errors_are_the_references():
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="budget"):
            plan.bands_for_budget(50, bad)
    with pytest.raises(ValueError, match="all zero"):
        plan.bands_for_profile(np.zeros(64), 0.9)
    with pytest.raises(ValueError, match="non-negative"):
        plan.bands_for_profile(-np.ones(64), 0.9)


@pytest.mark.parametrize("tol", [5e-2, 0.3])
def test_autotune_sweep_equals_the_references(model, monkeypatch, tol):
    jparams, jstate, tparams, tstate, coef = model
    seen = []
    real = plan.apply_plan

    def recording(p, x, cfg=None):
        out = real(p, x, cfg)
        seen.append(out.clone())
        return out

    monkeypatch.setattr(plan, "apply_plan", recording)
    got = plan.autotune_bands(tparams, tstate, SPEC, tol=tol,
                              probe_coef=torch.as_tensor(coef))
    monkeypatch.undo()
    want = ref_plan.autotune_bands(jparams, jstate, REF_SPEC, tol=tol,
                                   probe_coef=jnp.asarray(coef))
    ref, trials = seen[0], seen[1:]
    margins = sorted((tol - float((t - ref).abs().max()) for t in trials),
                     key=abs)
    print(f"tol {tol}: {len(trials)} trials, parity margins nearest zero "
          f"{margins[:3]} (largest |logit| {float(ref.abs().max()):.4f})")
    assert got == want, (got, want)
    assert set(got) == set(plan.operator_keys(tparams, SPEC))


@pytest.mark.parametrize("with_profile", [False, True])
def test_autotune_without_probe_equals_the_references(model, capsys,
                                                      with_profile):
    jparams, jstate, tparams, tstate, _ = model
    kw = {}
    if with_profile:
        stats = _energy(FIXTURES[0])
        kw = dict(profile=stats.energy, occupancy=stats.occupancy)
    got = plan.autotune_bands(tparams, tstate, SPEC, budget=0.9, **kw)
    port_log = capsys.readouterr().out
    want = ref_plan.autotune_bands(jparams, jstate, REF_SPEC, budget=0.9,
                                   **kw)
    assert got == want
    assert port_log == capsys.readouterr().out  # the same [autotune] lines
    assert ("[autotune] stem" in port_log) == with_profile


@pytest.fixture(scope="module")
def auto_plans(model):
    jparams, jstate, tparams, tstate, coef = model
    stats = _energy(FIXTURES[1])
    kw = dict(bands="auto", profile=stats.energy, occupancy=stats.occupancy)
    return (plan.build_plan(tparams, tstate, SPEC, **kw),
            ref_plan.build_plan(jparams, jstate, REF_SPEC, **kw))


def test_build_plan_auto_records_the_references_provenance(auto_plans):
    port, ref = auto_plans
    assert port.provenance == ref.provenance == {
        "bands_mode": "auto", "budget": None, "probe": False,
        "energy": "empirical"}
    assert port.bands == ref.bands


def test_auto_provenance_crosses_the_packages(auto_plans, tmp_path):
    port, ref = auto_plans
    plan.save_plan(port, str(tmp_path / "port"))
    ref_plan.save_plan(ref, str(tmp_path / "ref"))
    assert ref_plan.load_plan(str(tmp_path / "port")).provenance \
        == port.provenance
    back = plan.load_plan(str(tmp_path / "ref"), device="cpu")
    assert back.provenance == ref.provenance and back.bands == ref.bands
    assert plan.load_plan(str(tmp_path / "port"),
                          device="cpu").provenance == port.provenance


def test_serve_autotune_bands_rebuilds_a_plan_that_was_not_autotuned(
        tmp_path, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    d = str(tmp_path / "plan")
    base = ["--arch", "jpeg-resnet", "--reduced", "--device", "cpu",
            "--ingest", "bytes", "--no-compiled", "--batch", "2",
            "--requests", "2", "--max-new", "1", "--plan-dir", d]
    first = serve.serve_jpeg_resnet(serve.parse_args(base + ["--bands",
                                                             "16"]))
    assert first["plan"]["provenance"]["bands_mode"] == "explicit"
    tuned = serve.serve_jpeg_resnet(serve.parse_args(
        base + ["--autotune-bands"]))
    again = serve.serve_jpeg_resnet(serve.parse_args(
        base + ["--autotune-bands"]))
    assert tuned["plan"]["built"] and not again["plan"]["built"]
    assert tuned["plan"]["provenance"] == {
        "bands_mode": "auto", "budget": None, "probe": True,
        "energy": "empirical"}
    assert again["plan"]["provenance"] == tuned["plan"]["provenance"]
    assert again["plan"]["bands"] == tuned["plan"]["bands"]
    assert again["completed"] == 2
