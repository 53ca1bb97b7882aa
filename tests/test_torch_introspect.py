"""The port's plan introspection (``repro_torch.introspect``) against the
reference package's contracts (``tests/test_introspect.py``), on the CPU.

* **attribution decomposes**: every ``block_costs`` row has positive
  FLOPs and bytes, and the steps sum to within 5 % of one counted whole
  walk, for both executors, packed and unpacked; the counter sees matrix
  products and convolutions exactly and the kernels' analytic work only
  where a wrapper adds it;
* **the report is the reference's**: ``predicted_vs_measured``'s report
  passes both packages' ``validate_report``, and the port's validator
  rejects the reference's targeted mutations;
* **roofline and profiles**: the dominant term is picked, and profile
  resolution honours spec > ``$JPEG_HW_PROFILE`` > default > detected
  device (``cpu`` here), with ``h100`` in the registry;
* **grid profiling is inert**: ``GridCell.profile`` adds no capture and
  returns the cell's own logits; the sweep covers every warmed cell;
  annotations reach the scheduler's device-dispatch spans; the
  ``serve_predicted_capacity`` gauge appears;
* **the CLI**: ``launch.inspect --device cpu --reduced`` writes a report
  that validates.

Wall-clock gates (the ±10 % reconciliation) are left to ``chip_smoke.py``
on the card: on a loaded CPU the reference's own test of it flakes.
"""
import copy
import json

import numpy as np
import pytest
import torch

from repro import introspect as ref_introspect
from repro_torch import introspect
from repro_torch import serving as sv
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan
from repro_torch.core import resnet
from repro_torch.introspect import opcount
from repro_torch.introspect.roofline import PROFILES, HardwareProfile
from test_torch_plan import numpy_params

torch.set_num_threads(1)

SPEC = resnet.ResNetSpec(widths=(6, 8), num_classes=10)


@pytest.fixture(scope="module")
def setup():
    params, state = numpy_params(SPEC)
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    coef = torch.as_tensor(np.random.default_rng(1).normal(
        size=(4, 2, 2, 3, 64)).astype(np.float32))
    p = plan.build_plan(tparams, tstate, SPEC,
                        dispatch=dsp.DispatchConfig(path="reference"))
    return p, plan.compile_plan(p), coef


@pytest.fixture(scope="module")
def report(setup):
    _, cp, coef = setup
    return introspect.predicted_vs_measured(cp, coef, executor="gemm",
                                            iters=2)


# --------------------------------------------------------------------------
# Counting
# --------------------------------------------------------------------------


def test_counter_sees_products_convolutions_and_kernel_work():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    img, k = torch.randn(1, 3, 8, 8), torch.randn(4, 3, 3, 3)
    with torch.inference_mode(), opcount.count() as c:
        a @ b
        torch.nn.functional.conv2d(img, k, padding=1)
        torch.exp(a)
        opcount.add_kernel_work(10.0, 20.0)
    assert c.flops == 2 * 8 * 16 * 4 + 2 * 64 * 4 * 27 + 10.0
    assert c.transcendentals == a.numel()
    assert c.bytes > 20.0 and c.collective_bytes == 0.0
    assert not opcount.counting()
    opcount.add_kernel_work(1.0, 1.0)  # no count active: nothing to add
    assert c.flops == 2 * 8 * 16 * 4 + 2 * 64 * 4 * 27 + 10.0


def test_kernel_work_formulas():
    """The counts the kernel table's bounds and the roofline share."""
    assert opcount.conv_work(10, 2, 8, 9, 8, 3, 8, 16, 5) == (
        2.0 * 5 * 9 * 2 * 8 * 3 * 8,
        4.0 * (10 * 2 * 8 + 9 * 2 * 8 * 3 * 8 + 5 * 3 * 16))
    assert opcount.asm_flops(7, 16) == 2.0 * 7 * (16 * 128 + 64 * 16)
    assert opcount.asm_work(7, 16) == (opcount.asm_flops(7, 16),
                                       4.0 * 7 * (16 + 64))
    assert opcount.fused_work(100, 50, 4, [30, 20], 2, 8, 16) == (
        2.0 * 4 * 50 + opcount.asm_flops(8, 8) + opcount.asm_flops(8, 16),
        4.0 * 200)
    assert opcount.block_matmul_work(3) == (2.0 * 3 * 64 * 64,
                                            4.0 * (2 * 3 * 64 + 64 * 64))
    ms, by = opcount.bound(67e12, 1.0)
    assert ms == pytest.approx(1e3) and by == "operations"
    assert opcount.bound(1.0, 3.35e12)[1] == "bytes"


@pytest.mark.parametrize("executor", [None, "gemm"])
@pytest.mark.parametrize("packed", [False, True])
def test_block_costs_sum_cross_check(setup, executor, packed):
    _, cp, coef = setup
    shape = (4, 2, 2, 3 * cp.stem.w_in) if packed else tuple(coef.shape)
    blocks, whole = introspect.block_costs(cp, shape, executor=executor,
                                           packed=packed)
    assert [b.name for b in blocks] == (
        ["stem"] + [b.name for b in cp.blocks] + ["head"])
    for b in blocks:
        assert b.flops > 0 and b.bytes > 0 and b.predicted_s > 0, b.name
    assert sum(b.flops for b in blocks) == pytest.approx(whole.flops,
                                                         rel=0.05)
    want = "gemm" if executor == "gemm" else "spatial"
    assert blocks[0].executor == want
    assert {b.executor for b in blocks if b.kind == "fused"} == {want}


def test_block_costs_metadata(setup):
    _, cp, coef = setup
    blocks, whole = introspect.block_costs(cp, coef.shape,
                                           cross_check=False)
    assert whole is None
    by_name = {b.name: b for b in blocks}
    assert by_name["stem"].kind == "stem" and by_name["head"].kind == "head"
    for blk in cp.blocks:
        row = by_name[blk.name]
        assert row.bands_out == blk.bands_out
        if blk.kind == "fused":
            assert set(row.layer_bands) >= {"conv1", "conv2"}
            assert row.vmem_bytes == 0  # no kernel on the CPU
    for b in blocks:
        if b.name == "head":
            assert b.energy_kept is None
        else:
            assert 0.0 < b.energy_kept <= 1.0 + 1e-9


def test_spatial_lowering_counts_fewer_flops(setup):
    """The spatial lowering's convs cost 64·r²·Cin·Cout a block against
    Ξ's ndy·ndx·Cin·Cout·b² (the reason the reference serves it off-TPU)."""
    _, cp, coef = setup
    gemm, _ = introspect.block_costs(cp, coef.shape, executor="gemm",
                                     cross_check=False)
    spatial, _ = introspect.block_costs(cp, coef.shape, cross_check=False)
    for g, s in zip(gemm, spatial):
        if g.kind == "fused":
            assert s.flops < g.flops, g.name


# --------------------------------------------------------------------------
# Roofline and profiles
# --------------------------------------------------------------------------


def test_roofline_term_selection():
    hw = PROFILES["h100"]
    r = introspect.roofline(1e15, 1e3, 0.0, hw)
    assert r["term"] == "compute"
    assert r["predicted_s"] == pytest.approx(1e15 / 67e12)
    assert introspect.roofline(1e3, 1e12, 0.0, hw)["term"] == "memory"
    r = introspect.roofline(1e3, 1e3, 1e12, hw)
    assert r["term"] == "collective"
    assert r["predicted_s"] == pytest.approx(1e12 / 450e9)


def test_resolve_profile_priority(monkeypatch):
    from repro.introspect.roofline import PROFILES as REF_PROFILES

    for name, hw in REF_PROFILES.items():
        assert PROFILES[name].to_json() == hw.to_json()
    assert (PROFILES["h100"].peak_flops, PROFILES["h100"].hbm_bw) == (
        67e12, 3.35e12)
    monkeypatch.setenv("JPEG_HW_PROFILE", "tpu-v4")
    assert introspect.resolve_profile("h100").name == "h100"
    assert introspect.resolve_profile().name == "tpu-v4"
    monkeypatch.delenv("JPEG_HW_PROFILE")
    assert introspect.resolve_profile(default="gpu").name == "gpu"
    if not torch.cuda.is_available():
        assert introspect.detect_backend() == "cpu"
    assert introspect.resolve_profile().name == introspect.detect_backend()
    hw = introspect.resolve_profile("1e12, 2e11, 5e10")
    assert isinstance(hw, HardwareProfile) and hw.name == "custom"
    assert (hw.peak_flops, hw.link_bw) == (1e12, 5e10)
    with pytest.raises(ValueError):
        introspect.resolve_profile("not-a-profile")


# --------------------------------------------------------------------------
# The report
# --------------------------------------------------------------------------


def test_report_measured_and_bit_identical(report, setup):
    _, cp, _ = setup
    assert [b["name"] for b in report["blocks"]] == (
        ["stem"] + [b.name for b in cp.blocks] + ["head"])
    for b in report["blocks"]:
        assert b["measured_us"] > 0
        assert b["ratio"] == pytest.approx(b["measured_us"]
                                           / b["predicted_us"])
    t = report["totals"]
    assert t["logits_match"] is True
    assert t["static_flops_ratio"] == pytest.approx(1.0, rel=0.05)
    assert report["meta"]["backend"] == "cpu"
    assert report["meta"]["executor"] == "gemm"


def test_report_passes_both_validators(report):
    mine = introspect.validate_report(report)
    theirs = ref_introspect.validate_report(json.loads(json.dumps(report)))
    assert mine == theirs
    assert mine["blocks"] == len(report["blocks"])
    assert mine["worst_ratio"] is not None and mine["worst_ratio"] >= 1


@pytest.mark.parametrize("mutate,frag", [
    (lambda r: r.update(kind="nope"), "kind"),
    (lambda r: r.update(version=99), "version"),
    (lambda r: r.pop("blocks"), "blocks missing"),
    (lambda r: r["blocks"][0].pop("flops"), "missing flops"),
    (lambda r: r["blocks"][0].update(flops=-1.0), "flops"),
    (lambda r: r["blocks"][0].update(predicted_us=0.0), "predicted_us"),
    (lambda r: r["blocks"][0].update(term="magic"), "term"),
    (lambda r: r["blocks"][0].update(ratio=123.0), "ratio"),
    (lambda r: r["totals"].update(reconciliation=9.9), "reconciliation"),
    (lambda r: r["totals"].update(logits_match="yes"), "logits_match"),
    (lambda r: r["meta"].pop("hw_profile"), "hw_profile"),
])
def test_validate_report_rejects(report, mutate, frag):
    bad = copy.deepcopy(report)
    mutate(bad)
    with pytest.raises(ValueError, match=frag):
        introspect.validate_report(bad)


def test_worst_ratio_and_render_text(report):
    blocks = [{"name": "big", "measured_us": 990.0, "predicted_us": 900.0,
               "ratio": 1.1},
              {"name": "tiny", "measured_us": 5.0, "predicted_us": 0.01,
               "ratio": 500.0}]
    assert introspect.worst_ratio({"blocks": blocks}) == pytest.approx(1.1)
    blocks[1]["measured_us"] = 500.0
    assert introspect.worst_ratio({"blocks": blocks}) == pytest.approx(500.)
    text = introspect.render_text(report)
    assert "stem" in text and "head" in text
    assert "logits bit-identical under profiling: True" in text


# --------------------------------------------------------------------------
# Grid profiling
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid(setup):
    p, _, coef = setup
    captures = []
    ladder = sv.build_ladder(p, caps=(None, 32))
    g = sv.PlanGrid(ladder, batch=4, grid=tuple(coef.shape[1:3]),
                    channels=coef.shape[3], executor="gemm",
                    on_compile=captures.append)
    g.warmup(kinds=("coefficients",))
    return g, coef, captures


def test_grid_cell_profile_parity(grid):
    g, coef, captures = grid
    n = len(captures)
    cell = g.distinct[0].cells[("coefficients", 4)]
    rows = [coef[i].numpy() for i in range(3)]  # partial: pad to 4
    want = cell(rows).numpy()
    prof = cell.profile(rows, iters=2)
    assert np.array_equal(prof["logits"], want)
    assert prof["bucket"] == 4 and prof["cell_wall_us"] > 0
    names = [s["name"] for s in prof["steps"]]
    assert names[0] == "stem" and names[-1] == "head"
    assert all(s["measured_us"] > 0 for s in prof["steps"])
    assert prof["profiled_total_us"] == pytest.approx(
        sum(s["measured_us"] for s in prof["steps"]))
    assert len(captures) == n


def test_profile_plan_grid_sweep(grid):
    g, _, captures = grid
    n = len(captures)
    pg = introspect.profile_plan_grid(g, iters=2)
    assert len(captures) == n
    assert pg["hw_profile"]["peak_flops"] > 0
    cells = {c["cell"]: c for c in pg["cells"]}
    assert set(cells) == {c.name for c in g.cells()}
    for c in g.cells():
        row = cells[c.name]
        assert row["predicted_req_s"] > 0 and row["measured_req_s"] > 0
        assert row["bucket"] == c.bucket
    by_tier = {}
    for c in pg["cells"]:
        by_tier.setdefault((c["tier"], c["kind"]), []).append(c)
    for rows in by_tier.values():
        rows = sorted(rows, key=lambda c: c["bucket"])
        f0 = rows[0]["flops"] / rows[0]["bucket"]
        for c in rows[1:]:
            assert c["flops"] / c["bucket"] == pytest.approx(f0)
    for col in pg["columns"]:
        assert all(b["measured_us"] for b in col["blocks"])


def test_grid_costs_reach_the_dispatch_spans(setup):
    """``annotate_costs`` → ``cost_for`` → the scheduler's
    ``device-dispatch`` spans carry the cell's flops and predicted_us."""
    p, _, coef = setup
    ladder = sv.build_ladder(p, caps=(None,))
    tracer = sv.Tracer()
    with sv.BandElasticScheduler(ladder, batch=2,
                                 grid=tuple(coef.shape[1:3]),
                                 channels=coef.shape[3],
                                 tracer=tracer) as s:
        s.warmup(kinds=("coefficients",))
        pg = introspect.profile_plan_grid(s.grid_engine, iters=1)
        s.grid_engine.annotate_costs(
            {c["cell"]: {"flops": c["flops"],
                         "predicted_us": c["predicted_us"]}
             for c in pg["cells"]})
        name = pg["cells"][0]["cell"]
        assert s.grid_engine.cost_for(name)["flops"] > 0
        assert s.grid_engine.cost_for("no/such/cell") is None
        for i in range(3):
            s.submit(coef[i].numpy()).result(timeout=60)
    spans = [e for e in tracer.export()["traceEvents"]
             if e["name"] == "device-dispatch"]
    assert spans
    for e in spans:
        assert e["args"]["predicted_us"] > 0 and e["args"]["flops"] > 0


def test_predicted_capacity_gauge():
    m = sv.ServeMetrics()
    m.record_predicted_capacity("top/bytes/b4", 123.456)
    m.record_predicted_capacity("b32/bytes/b1", 77.0)
    text = m.metrics_text()
    assert "# TYPE serve_predicted_capacity gauge" in text
    assert 'serve_predicted_capacity{cell="top/bytes/b4"} 123.456' in text
    assert m.report()["predicted_capacity_req_s"]["b32/bytes/b1"] == 77.0
    assert "serve_predicted_capacity" not in sv.ServeMetrics().metrics_text()


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("executor", ["auto", "plan"])
def test_inspect_cli_writes_a_valid_report(tmp_path, executor):
    from repro_torch.launch import inspect

    path = str(tmp_path / "report.json")
    inspect.main(["--reduced", "--device", "cpu", "--batch", "2",
                  "--iters", "2", "--bands", "16", "--executor", executor,
                  "--hw-profile", "cpu", "--report-out", path])
    with open(path) as f:
        rep = json.load(f)
    introspect.validate_report(rep)
    ref_introspect.validate_report(rep)
    assert rep["meta"]["hw_profile"]["name"] == "cpu"
    assert rep["meta"]["executor"] == ("gemm" if executor == "auto"
                                       else None)
    assert rep["meta"]["plan"]["fused_blocks"]
    assert inspect.resolve_executor("auto", torch.device("cuda")) is None
    with pytest.raises(SystemExit):
        inspect.resolve_executor("magic", torch.device("cpu"))
