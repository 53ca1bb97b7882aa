"""The port's serving runtime (``repro_torch.serving``) against the
reference package's (``repro.serving``), on the reduced ``jpeg-resnet``
(widths 16/32/64, 32 px) with every parameter drawn by numpy, on the CPU.

Oracles, each with its tolerance:

* ladder tiers are bit-identical to building and compiling a plan at the
  capped budget (``tests/test_serving.py``'s contract), and within 1e-5
  of the largest |logit| of the reference's tiers; ladders cross between
  the packages (caps, buckets, tier bands);
* bucket math equals the reference's on a sweep of sizes;
* logits served through ``BandElasticScheduler`` equal
  ``apply_compiled_packed`` / ``apply_compiled`` on the tier that served
  them within 1e-5 of the largest |logit|, top-1 agreeing, for bytes and
  coefficient traffic, with zero captures after warmup;
* the scheduler's lifecycle, admission control, deadline shedding and
  tier switching follow ``tests/test_serving.py``; the tier policy and
  the circuit breaker make the reference's decisions on the same signal;
  the flight recorder passes ``validate_trace`` (both packages'); the
  metrics report carries the reference's keys;
* ``serve --qos --plan-dir`` run twice: the second run restores the plan
  and the ladder, and both report the same top-1 classes.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import serving as ref_sv
from repro.core import dispatch as ref_dsp
from repro.core import plan as ref_plan
from repro.serving import grid as ref_grid
from repro_torch import serving as sv
from repro_torch.codec import encode as enc
from repro_torch.codec import ingest as ing
from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan as plan
from repro_torch.core import resnet as resnet
from repro_torch.serving import grid as grid_mod
from repro_torch.serving.qos import QosPolicy, TierSelector
from test_torch_plan import REF_SPEC, SPEC, _jax_tree, numpy_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: served logits against the same tier's compiled plan, relative to the
#: largest |logit|: the same operators, batched into other bucket shapes
#: (fp32 sums may group differently)
SERVE_RTOL = 1e-5
#: the port's tiers against the reference's: fp32 sums in another order
LADDER_RTOL = 1e-5
GRID = (4, 4)


@pytest.fixture
def scratch(tmp_path):
    """A temporary directory deleted after the test: a 64-band plan
    directory of the reduced config holds ~0.9 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


@pytest.fixture(scope="module")
def model():
    params, state = numpy_params(SPEC)
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    coef = np.random.default_rng(5).normal(
        size=(6, 4, 4, 3, 64)).astype(np.float32)
    return params, state, tparams, tstate, coef


def _build(model, bands):
    return plan.build_plan(model[2], model[3], SPEC,
                           dispatch=dsp.DispatchConfig(bands=bands))


@pytest.fixture(scope="module")
def served(model):
    """A 32-band plan and its ladder top / b24 / b16."""
    p = _build(model, 32)
    return p, sv.build_ladder(p, caps=(None, 24, 16))


def _traffic(n, seed=0, size=32):
    rng = np.random.default_rng(seed)
    qt = np.rint(dctlib.quantization_table(
        75, dc_is_mean=False)).astype(np.int64)
    return [enc.encode_pixels(
        np.clip(rng.normal(0, 0.3, (3, size, size)), -1.0, 127.0 / 128.0),
        qtable=qt) for _ in range(n)]


def _sched(ladder, **kw):
    kw.setdefault("batch", 4)
    kw.setdefault("grid", GRID)
    kw.setdefault("channels", 3)
    return sv.BandElasticScheduler(ladder, **kw)


# --------------------------------------------------------------------------
# Ladder
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [48, 32, 16])
def test_tier_bit_identical_to_independent_compile(model, cap):
    """From a 64-band base (s2b0 factored at the top), a tier equals
    ``build_plan`` at the capped bands, compiled, to the bit: the walk
    and the schedule.  As in the reference, a layer the top keeps
    factored stays factored at the cap, so the independent build runs at
    the materialise limit scaled with the band count: Ξ's size goes with
    bands², so every layer lands on the path the base chose."""
    base = _build(model, 64)
    tier = sv.build_ladder(base, caps=(None, cap)).tiers[1]
    assert tier.bands == {k: min(v, cap) for k, v in base.bands.items()}
    limit = base.cfg.limit * cap * cap // (64 * 64)
    indep = plan.build_plan(model[2], model[3], SPEC,
                            dispatch=dsp.DispatchConfig(
                                bands=64, materialize_limit=limit),
                            bands=dict(tier.bands))
    ops, indep_ops = plan._flat_ops(tier.plan), plan._flat_ops(indep)
    assert {k: op.xi is None for k, op in ops.items()} == {
        k: op.xi is None for k, op in indep_ops.items()}
    assert ops["s2b0/conv1"].xi is None
    coef = torch.as_tensor(model[4])
    assert torch.equal(plan.apply_plan(tier.plan, coef),
                       plan.apply_plan(indep, coef))
    cp = plan.compile_plan(indep)
    assert tier.compiled.meta["fused"] == cp.meta["fused"]
    assert torch.equal(plan.apply_compiled(tier.compiled, coef),
                       plan.apply_compiled(cp, coef))
    for op in ops.values():
        assert op.xi is None or op.xi.is_contiguous()


def test_tiers_match_the_references_ladder(model):
    """Same caps, same tier bands, the same blocks fused (a factored
    top-tier operator stays factored at every cap in both packages);
    logits within LADDER_RTOL."""
    params, state, *_ = model
    ref = ref_plan.build_plan(_jax_tree(params), _jax_tree(state), REF_SPEC,
                              dispatch=ref_dsp.DispatchConfig(bands=64))
    ref_ladder = ref_sv.build_ladder(ref, caps=(None, 48, 32))
    ladder = sv.build_ladder(_build(model, 64), caps=(None, 48, 32))
    coef = model[4]
    for t, rt in zip(ladder.tiers, ref_ladder.tiers):
        assert (t.name, t.cap, t.bands) == (rt.name, rt.cap, rt.bands)
        assert t.compiled.meta["fused"] == list(rt.compiled.meta["fused"])
        got = plan.apply_compiled(t.compiled, torch.as_tensor(coef))
        want = ref_plan.apply_compiled(rt.compiled, jnp.asarray(coef))
        _close(got, want, LADDER_RTOL)
    assert "s2b0" not in ladder.tiers[2].compiled.meta["fused"]


def test_top_tier_and_shared_schedules(served):
    p, ladder = served
    assert ladder.top.plan is p and ladder.top.cap is None
    again = sv.build_ladder(p, caps=(None, 32, 16))
    assert again.tiers[1].shared_with == 0
    assert again.tiers[1].compiled is again.tiers[0].compiled
    assert again.tiers[2].shared_with is None
    assert ladder.device_bytes([ladder.top]) < ladder.device_bytes()
    assert again.device_bytes() == again.device_bytes(
        [again.tiers[0], again.tiers[2]])
    with pytest.raises(ValueError):
        sv.build_ladder(p, caps=(32, None))
    with pytest.raises(ValueError):
        sv.build_ladder(p, caps=(None, 16, 24))
    with pytest.raises(ValueError):
        sv.build_ladder(p, caps=(None, 20))


def test_ladder_save_restore_roundtrip_and_stale(served, model, scratch):
    p, _ = served
    ladder = sv.build_ladder(p, caps=(None, 24, 16), buckets=(1, 2, 4))
    d = str(scratch / "plan")
    sv.save_ladder(ladder, d)
    back = sv.load_ladder(d, device="cpu")
    assert back.caps == ladder.caps and back.buckets == (1, 2, 4)
    coef = torch.as_tensor(model[4])
    for t0, t1 in zip(ladder.tiers, back.tiers):
        assert (t0.name, t0.bands) == (t1.name, t1.bands)
        assert torch.equal(plan.apply_compiled(t0.compiled, coef),
                           plan.apply_compiled(t1.compiled, coef))
    with pytest.raises(ValueError, match="stale"):
        sv.load_ladder(d, plan=_build(model, 8))


def test_ladders_cross_between_the_packages(model, scratch):
    """A ladder the reference saved loads in the port with the same caps,
    buckets and tier bands, and the reference reads the port's."""
    params, state, *_ = model
    ref = ref_plan.build_plan(_jax_tree(params), _jax_tree(state), REF_SPEC,
                              dispatch=ref_dsp.DispatchConfig(bands=32))
    ref_ladder = ref_sv.build_ladder(ref, caps=(None, 24, 16),
                                     buckets=(1, 2, 4, 8))
    d = str(scratch / "ref")
    ref_sv.save_ladder(ref_ladder, d)
    mine = sv.load_ladder(d, device="cpu")
    assert mine.caps == ref_ladder.caps and mine.buckets == (1, 2, 4, 8)
    coef = model[4]
    for t, rt in zip(mine.tiers, ref_ladder.tiers):
        assert (t.name, t.bands, t.shared_with) == (rt.name, rt.bands,
                                                     rt.shared_with)
        _close(plan.apply_compiled(t.compiled, torch.as_tensor(coef)),
               ref_plan.apply_compiled(rt.compiled, jnp.asarray(coef)),
               LADDER_RTOL)
    d2 = str(scratch / "port")
    sv.save_ladder(sv.build_ladder(_build(model, 32), caps=(None, 16),
                                   buckets=(1, 4)), d2)
    theirs = ref_sv.load_ladder(d2)
    assert theirs.caps == (None, 16) and theirs.buckets == (1, 4)
    assert [t.bands for t in theirs.tiers] == [
        t.bands for t in sv.load_ladder(d2, device="cpu").tiers]


# --------------------------------------------------------------------------
# Grid
# --------------------------------------------------------------------------


def test_bucket_math_equals_the_references():
    for top in range(1, 41):
        assert sv.batch_buckets(top) == ref_grid.batch_buckets(top)
        for n in range(1, top + 1):
            bs = sv.batch_buckets(top)
            assert sv.bucket_for(n, bs) == ref_grid.bucket_for(n, bs)
        for spec in (None, (1, 4), (2, 8, 16), (3,)):
            assert sv.cover_buckets(spec, top) == ref_grid.cover_buckets(
                spec, top)
    for bad in ((), (0, 2), (4, 2), (2, 2)):
        with pytest.raises(ValueError):
            sv.validate_buckets(bad)
    with pytest.raises(ValueError):
        sv.bucket_for(9, (1, 2, 4, 8))
    with pytest.raises(ValueError):
        sv.batch_buckets(0)


def test_cell_matches_unpadded_compiled_plan(served, model):
    """A bucket-4 cell serving 3 rows returns, in its first 3 slots, the
    schedule's logits on the unpadded batch; the captured entry is pinned
    to its shape and its capture is counted once."""
    p, ladder = served
    cp = ladder.top.compiled
    captures = []
    col = grid_mod.GridColumn(cp, buckets=(1, 2, 4),
                              on_compile=captures.append, tier_name="top")
    packed = ing.pack_tiles(model[4][:3], cp.stem.w_in)
    out = col.packed_fn(packed)
    assert tuple(out.shape) == (4, SPEC.num_classes)
    want = plan.apply_compiled_packed(cp, torch.as_tensor(packed))
    _close(out[:3], want, SERVE_RTOL)
    assert captures == ["top/bytes/b4"]
    col.packed_fn(packed[:1])
    assert captures == ["top/bytes/b4", "top/bytes/b1"]
    cell = col.cells[("bytes", 4)]
    assert cell.hits == 1 and cell.replays == 1
    with pytest.raises(ValueError):
        cell(np.zeros((5,) + packed.shape[1:], np.float32))
    with pytest.raises(ValueError):
        cell(np.zeros((2, 4, 4, 7), np.float32))
    fn = plan.capture_compiled(cp, (2,) + packed.shape[1:], packed=True,
                               device="cpu")
    with pytest.raises(ValueError, match="pinned to shape"):
        fn(torch.as_tensor(packed))
    assert fn.graph is None and fn.graph_launches == {}
    assert cell.time_wall(iters=1) > 0.0
    prof = cell.profile(packed[:3], iters=1)
    assert [s["name"] for s in prof["steps"]] == (
        ["stem"] + [b.name for b in cp.blocks] + ["head"])
    assert all(s["measured_us"] > 0 for s in prof["steps"])
    assert np.array_equal(prof["logits"], cell(packed[:3]).numpy())
    assert captures == ["top/bytes/b4", "top/bytes/b1"]


def test_pinned_pool_reuses_buffers():
    pool = sv.PinnedPool()
    a = pool.get((2, 3))
    assert pool.get((2, 3)) is a and len(pool) == 1
    pool.get((2, 3), torch.float64)
    assert len(pool) == 2 and pool.nbytes == 6 * 4 + 6 * 8
    assert not a.is_pinned()


def test_grid_warmup_and_summary(served):
    p, ladder = served
    captured = []
    g = sv.PlanGrid(ladder, batch=4, grid=GRID, on_compile=captured.append)
    g.warmup(kinds=("bytes",))
    s = g.summary()
    assert s["buckets"] == [1, 2, 4] and s["distinct_columns"] == 3
    assert s["cells"] == 9 == len(captured) and not s["cuda_graphs"]
    assert g.graph_launches() == {}
    with pytest.raises(ValueError, match="grid="):
        sv.PlanGrid(ladder, batch=4).warmup()


# --------------------------------------------------------------------------
# Scheduler
# --------------------------------------------------------------------------


class _Forced(TierSelector):
    """A policy that walks the ladder: batch k runs at tier k mod n."""

    def select(self, **kw):
        self._seq += 1
        t = (self._seq - 1) % self.n_tiers
        if t != self.tier:
            self._switch(t, "forced")
        return self.tier


def _per_tier_reference(ladder, kind, reqs, payloads):
    # the scheduler's "auto" executor on the CPU is the packed GEMM
    for r, pay in zip(reqs, payloads):
        cp = next(t.compiled for t in ladder.tiers if t.name == r.tier)
        if kind == "bytes":
            coef, _ = ing.ingest_batch([pay], quality=50, grid=GRID,
                                       parallel=False)
            want = plan.apply_compiled_packed(
                cp, torch.as_tensor(ing.pack_tiles(coef, cp.stem.w_in)),
                executor="gemm")
        else:
            want = plan.apply_compiled(cp, torch.as_tensor(pay[None]),
                                       executor="gemm")
        got = r.result(timeout=120)
        _close(got, want[0], SERVE_RTOL)
        assert got.argmax() == int(want[0].argmax())


@pytest.mark.parametrize("kind", ["bytes", "coefficients"])
def test_served_logits_match_their_tier(served, model, monkeypatch, kind):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder = served
    payloads = (_traffic(10) if kind == "bytes"
                else [model[4][i % 6] for i in range(10)])
    with _sched(ladder) as s:
        s.selector = _Forced(len(ladder.tiers), tier_names=s.tier_names,
                             on_switch=s._on_switch)
        s.warmup(kinds=(kind,))
        reqs = [s.submit(pay, kind=kind) for pay in payloads]
        s.drain(timeout=120)
    _per_tier_reference(ladder, kind, reqs, payloads)
    rep = s.metrics.report()
    assert len(rep["per_tier"]) >= 2 and rep["tier_switches"]
    assert rep["compiles_total"] == 9 and rep["compiles_post_warmup"] == 0
    assert sum(rep["grid_cell_hits"].values()) == sum(
        t["batches"] for t in rep["per_tier"].values())


def test_zero_captures_after_warmup_on_mixed_occupancy(served, model):
    p, ladder = served
    with _sched(ladder) as s:
        s.warmup(kinds=("coefficients",))
        assert s.metrics.report()["compiles_total"] == 9
        for i in range(3):  # a trickle: bucket 1
            s.submit(model[4][i]).result(timeout=60)
        for i in range(7):  # a burst
            s.submit(model[4][i % 6])
        s.drain(timeout=120)
    rep = s.metrics.report()
    assert rep["compiles_total"] == 9 and rep["compiles_post_warmup"] == 0
    assert any(k.endswith("/b1") for k in rep["grid_cell_hits"])


def test_lazy_capture_is_counted_post_warmup(served, model):
    p, ladder = served
    with _sched(ladder, batch=2) as s:
        s.warmup(kinds=())
        s.submit(model[4][0]).result(timeout=60)
    rep = s.metrics.report()
    assert rep["compiles_post_warmup"] == 1
    assert rep["post_warmup_compiles"] == ["top/coefficients/b1"]


def test_gemm_executor_is_not_ported(served, model):
    """Named for what ``executor="gemm"`` did before it was ported: the
    scheduler now serves through the packed-GEMM lowering, and every
    request's logits equal the reference's GEMM executor on the same
    tier within SERVE_RTOL, top-1 agreeing; ``auto`` is ``gemm`` on the
    CPU, and an unknown executor raises."""
    params, state, *_ = model
    p, ladder = served
    ref = ref_plan.build_plan(_jax_tree(params), _jax_tree(state), REF_SPEC,
                              dispatch=ref_dsp.DispatchConfig(bands=32))
    ref_tiers = {t.name: t.compiled for t in ref_sv.build_ladder(
        ref, caps=(None, 24, 16)).tiers}
    with _sched(ladder, executor="gemm") as s:
        s.selector = _Forced(len(ladder.tiers), tier_names=s.tier_names,
                             on_switch=s._on_switch)
        s.warmup(kinds=("coefficients",))
        reqs = [s.submit(model[4][i % 6]) for i in range(6)]
        s.drain(timeout=120)
    assert s.executor == "gemm"
    for i, r in enumerate(reqs):
        want = np.asarray(ref_plan.apply_compiled(
            ref_tiers[r.tier], jnp.asarray(model[4][i % 6][None]),
            executor="gemm"))[0]
        got = r.result(timeout=60)
        _close(got, want, SERVE_RTOL)
        assert got.argmax() == want.argmax()
    with _sched(ladder) as auto:
        assert auto.executor == "gemm"
    with pytest.raises(ValueError, match="executor"):
        _sched(ladder, executor="spatial")


def test_admission_control_rejects_past_max_pending(served, model):
    p, ladder = served
    with _sched(ladder, batch=2, max_pending=3) as s:
        with s._lock:  # hold the worker off while the queue fills
            for i in range(3):
                s._queues["coefficients"].append(sv.ServeRequest(
                    900 + i, "coefficients", model[4][i], None))
        assert s.submit(model[4][0]) is None
        s.drain(timeout=60)
        assert s.submit(model[4][0]).result(timeout=60) is not None
    assert s.metrics.report()["rejected"] == 1


def test_deadline_shedding(served, model, monkeypatch):
    """Expired requests are shed at dequeue, before paying a decode or a
    batch slot, and fail with DeadlineExceeded."""
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder = served
    with _sched(ladder) as s:
        s.warmup()
        late = [s.submit(model[4][0], deadline_s=0.0),
                s.submit(_traffic(1)[0], kind="bytes", deadline_s=0.0)]
        ok = s.submit(model[4][1], deadline_s=60.0)
        s.drain(timeout=60)
    for r in late:
        with pytest.raises(sv.DeadlineExceeded):
            r.result(timeout=1)
    assert ok.result() is not None
    rep = s.metrics.report()
    assert rep["deadline_shed"] == 2 and rep["failures_total"]["deadline"] == 2


def test_overload_degrades_then_recovers(served, model):
    """A burst deep enough for ``high_depth`` walks the default policy
    down the ladder; everything still completes."""
    p, ladder = served
    with _sched(ladder, batch=2,
                policy=QosPolicy(high_depth=2.0, hysteresis=1)) as s:
        s.warmup(kinds=("coefficients",))
        with s._lock:  # the whole burst queued before the first take
            reqs = [sv.ServeRequest(800 + i, "coefficients",
                                    model[4][i % 6], None)
                    for i in range(12)]
            s._queues["coefficients"].extend(reqs)
            s._work.notify_all()
        s.drain(timeout=120)
    assert all(r.result() is not None for r in reqs)
    switches = s.metrics.report()["tier_switches"]
    assert switches and switches[0]["from"] == "top"
    assert {r.tier for r in reqs} - {"top"}


def test_close_drains_and_close_without_drain_fails(served, model):
    p, ladder = served
    s = _sched(ladder, batch=2)
    reqs = [s.submit(model[4][i % 6]) for i in range(5)]
    s.close()
    assert all(r.result() is not None for r in reqs)
    assert s.metrics.report()["requests"] == 5
    s = _sched(ladder, batch=2)
    with s._lock:
        queued = []
        for i in range(4):
            r = sv.ServeRequest(700 + i, "coefficients", model[4][0], None)
            s._queues["coefficients"].append(r)
            queued.append(r)
        s._stop, s._drain = True, False
        s._work.notify_all()
    s.close(drain=False)
    for r in queued:
        with pytest.raises(sv.SchedulerClosed):
            r.result(timeout=5)
    with pytest.raises(sv.SchedulerClosed):
        s.submit(model[4][0])


def test_executor_failure_is_contained_and_retried(served, model):
    """One transient executor fault is retried; a persistent one fails
    its batch alone (RequestFailed, stage executor) and feeds the
    breaker, and the scheduler keeps serving."""
    p, ladder = served

    class Faults:
        def __init__(self, bad):
            self.bad, self.calls = bad, 0

        def on_ingest(self, reqs):
            pass

        def on_execute(self, seq, reqs):
            self.calls += 1
            if self.calls in self.bad:
                raise RuntimeError("injected")

    with _sched(ladder, batch=1, faults=Faults({1})) as s:
        assert s.submit(model[4][0]).result(timeout=60) is not None
    with _sched(ladder, batch=1, faults=Faults({1, 2}),
                executor_retries=1) as s:
        r = s.submit(model[4][0])
        with pytest.raises(sv.RequestFailed) as ei:
            r.result(timeout=60)
        assert ei.value.stage == "executor"
        assert s.submit(model[4][1]).result(timeout=60) is not None
        assert s.health()["failures_total"] == {"executor": 1}


def test_codec_errors_fail_only_their_request(served, monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder = served
    good = _traffic(3)
    with _sched(ladder) as s:
        s.warmup(kinds=("bytes",))
        reqs = [s.submit(good[0], kind="bytes"),
                s.submit(good[1][:50], kind="bytes"),
                s.submit(good[2], kind="bytes")]
        s.drain(timeout=60)
    assert reqs[0].result() is not None and reqs[2].result() is not None
    with pytest.raises(sv.RequestFailed) as ei:
        reqs[1].result()
    assert ei.value.stage == "codec"
    assert s.health()["breaker"]["state"] == "closed"


# --------------------------------------------------------------------------
# The tier policy, the breaker, the flight recorder, the metrics report
# --------------------------------------------------------------------------


def test_tier_policy_decides_as_the_references():
    """The same pseudo-random signal (queue depth, head slack, observed
    latency, bucket) through both selectors: the same tier every batch
    and the same switch log."""
    rng = np.random.default_rng(11)
    logs = ([], [])
    sel = [cls(4, pol(high_depth=2.0, low_depth=0.5, hysteresis=2),
               tier_names=["top", "b48", "b32", "b24"],
               on_switch=lambda *a, log=log: log.append(a))
           for cls, pol, log in ((TierSelector, QosPolicy, logs[0]),
                                 (ref_sv.TierSelector, ref_sv.QosPolicy,
                                  logs[1]))]
    for _ in range(400):
        pending = int(rng.integers(0, 40))
        slack = None if rng.random() < 0.3 else float(rng.uniform(0, 0.2))
        bucket = int(rng.choice([1, 2, 4, 8]))
        tiers = [s.select(pending=pending, batch=8, head_slack_s=slack,
                          bucket=bucket) for s in sel]
        assert tiers[0] == tiers[1]
        wall = float(rng.uniform(0.005, 0.1))
        for s in sel:
            s.observe(tiers[0], wall, bucket=bucket)
        if rng.random() < 0.05:
            for s in sel:
                s.note_failure()
    assert logs[0] == logs[1] and logs[0]
    assert sel[0].estimates() == sel[1].estimates()


def test_breaker_walks_as_the_references():
    """The same outcome sequence on a fake clock: the same states, the
    same transition timeline (closed → open → half_open → closed …)."""
    rng = np.random.default_rng(12)
    t = [0.0]
    hops = ([], [])
    pol = dict(window=8, failure_rate=0.5, min_samples=4, max_consecutive=3,
               open_s=0.5, half_open_successes=2)
    br = [sv.CircuitBreaker(sv.BreakerPolicy(**pol), clock=lambda: t[0],
                            on_transition=lambda *a: hops[0].append(a)),
          ref_sv.CircuitBreaker(ref_sv.BreakerPolicy(**pol),
                                clock=lambda: t[0],
                                on_transition=lambda *a: hops[1].append(a))]
    for _ in range(300):
        t[0] += float(rng.uniform(0.0, 0.2))
        allowed = [b.allow() for b in br]
        assert allowed[0] == allowed[1]
        if allowed[0]:
            if rng.random() < 0.45:
                for b in br:
                    b.record_failure("executor")
            else:
                for b in br:
                    b.record_success()
        assert br[0].state == br[1].state
    assert hops[0] == hops[1]
    assert {(a, b) for a, b, _ in hops[0]} >= {
        ("closed", "open"), ("open", "half_open"), ("half_open", "closed")}
    s0, s1 = br[0].snapshot(), br[1].snapshot()
    assert s0 == s1


def test_traced_run_validates_in_both_packages(served, model, scratch,
                                               monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder = served
    tracer = sv.Tracer()
    with _sched(ladder, tracer=tracer) as s:
        s.warmup()
        reqs = [s.submit(model[4][i]) for i in range(5)]
        reqs += [s.submit(d, kind="bytes") for d in _traffic(5)]
        s.drain(timeout=120)
    path = scratch / "trace.json"
    tracer.write(str(path))
    with open(path) as f:
        obj = json.load(f)
    summ = sv.validate_trace(obj)
    assert summ == ref_sv.validate_trace(obj)
    assert summ["complete"] == summ["requests"] == 10
    assert summ["open_chains"] == [] and summ["dropped"] == 0
    by = summ["spans_by_name"]
    assert by["device/device-dispatch"] == by["device/pad/stage"]
    assert by["ingest/ingest-decode"] >= 1
    rep = s.metrics.report()
    assert summ["device_span_s"] == pytest.approx(rep["device_wall_s"],
                                                  rel=0.05)


def test_traced_dispatch_has_one_span_per_stage(served, model):
    """Each ``device-dispatch`` holds one ``gather``, ``pad/stage``,
    ``launch`` and ``readback``, in order, covering at least 90 % of it;
    each batch has one ``scheduler/complete`` after it; per-request
    events carry no args, and ``pad/stage`` no request ids."""
    p, ladder = served
    tracer = sv.Tracer()
    with _sched(ladder, tracer=tracer) as s:
        s.warmup(kinds=("coefficients",))
        reqs = [s.submit(model[4][i % 6]) for i in range(11)]
        s.drain(timeout=120)
    assert all(r.result() is not None for r in reqs)
    evs = tracer.events()
    spans = [(f"{tk}/{nm}", ts, ts + d, args)
             for ph, tk, _, nm, ts, d, args in evs if ph == "X"]
    dispatches = [sp for sp in spans if sp[0] == "device/device-dispatch"]
    completes = sorted(sp for sp in spans if sp[0] == "scheduler/complete")
    assert dispatches and len(completes) == len(dispatches)
    stages = ("device/gather", "device/pad/stage", "device/launch",
              "device/readback")
    for k, (_, a, b, args) in enumerate(dispatches):
        inside = sorted((t0, name, t1) for name, t0, t1, _ in spans
                        if name in stages and a <= t0 and t1 <= b)
        assert [name for _, name, _ in inside] == list(stages)
        assert all(x[2] <= y[0] for x, y in zip(inside, inside[1:]))
        assert sum(t1 - t0 for t0, _, t1 in inside) >= 0.9 * (b - a)
        done = completes[k]
        assert done[1] >= b and done[3] == {"n": args["n"]}
        if k + 1 < len(dispatches):
            assert done[2] <= dispatches[k + 1][1]
    for ph, tk, _, nm, _, _, args in evs:
        if tk == "request":
            assert args is None, (ph, nm, args)
        if nm == "pad/stage":
            assert "rids" not in args


def test_traced_unhappy_paths_keep_their_chains(served, model, monkeypatch):
    """Admission rows are written as requests leave the queue: a shed
    and a poisoned request still close their chains (as the reference's
    ``test_traced_shed_and_fail_close_their_chains``), and requests a
    non-draining close fails while queued keep an admission row and no
    terminal, as before, and so do byte requests the ingest thread holds
    when such a close comes."""
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder = served
    tracer = sv.Tracer()
    with _sched(ladder, tracer=tracer) as s:
        ok = s.submit(model[4][0])
        expired = s.submit(model[4][1], deadline_s=-0.001)
        bad = s.submit(b"not a jpeg scan", kind="bytes")
        assert np.isfinite(ok.result(timeout=60)).all()
        with pytest.raises(sv.DeadlineExceeded):
            expired.result(timeout=60)
        with pytest.raises(sv.RequestFailed):
            bad.result(timeout=60)
        s.drain(timeout=60)
    obj = tracer.export()
    summ = sv.validate_trace(obj)
    assert summ == ref_sv.validate_trace(obj)
    assert summ["open_chains"] == []
    assert (summ["complete"], summ["shed"], summ["failed"]) == (1, 1, 1)

    tracer = sv.Tracer()
    s = _sched(ladder, batch=2, tracer=tracer)
    with s._lock:
        queued = []
        for i in range(3):
            r = sv.ServeRequest(900 + i, "coefficients", model[4][0], None)
            r.t_sub = r.t_enq = tracer.now()
            s._queues["coefficients"].append(r)
            queued.append(r)
        s._stop, s._drain = True, False
        s._work.notify_all()
    s.close(drain=False)
    summ = sv.validate_trace(tracer.export(), require_closed=False)
    assert summ["open_chains"] == [900, 901, 902]
    assert summ["spans_by_name"] == {"request/admission": 3}

    entered, release = threading.Event(), threading.Event()

    class Hold:
        """Keeps the ingest thread on its popped batch until released."""

        def on_ingest(self, reqs):
            entered.set()
            release.wait(60)

        def on_execute(self, seq, reqs):
            pass

    tracer = sv.Tracer()
    s = _sched(ladder, batch=2, tracer=tracer, faults=Hold())
    held = [s.submit(d, kind="bytes") for d in _traffic(2)]
    assert entered.wait(60)
    with s._lock:
        assert not s._queues["bytes"]  # popped, not yet decoded
        s._stop, s._drain = True, False
        s._work.notify_all()
    release.set()
    s.close(drain=False)
    for r in held:
        with pytest.raises(sv.SchedulerClosed):
            r.result(timeout=60)
    summ = sv.validate_trace(tracer.export(), require_closed=False)
    assert summ["open_chains"] == sorted(r.rid for r in held)
    assert summ["spans_by_name"]["request/admission"] == 2
    assert "request/queue" not in summ["spans_by_name"]


# --------------------------------------------------------------------------
# The launch window (a fake asynchronous card over the CPU cells)
# --------------------------------------------------------------------------


class _LateCard:
    """Stands in for the card: each grid dispatch runs the real CPU cell
    at once but hands back a handle that completes later, after ``delay``
    seconds or, with ``hold``, when :meth:`release` d.  Records every
    launch ``(seq, n)``, the order of readbacks and the most batches
    launched and not yet read back; ``fail_launch`` / ``fail_wait`` map a
    dispatch ``seq`` to how many times its launch / readback raises."""

    def __init__(self, monkeypatch, *, delay=0.01, hold=False,
                 fail_launch=None, fail_wait=None):
        self.delay, self.hold = delay, hold
        self.fail_launch = dict(fail_launch or {})
        self.fail_wait = dict(fail_wait or {})
        self.lock = threading.Lock()
        self.launches, self.waited, self.held = [], [], []
        self.in_flight = self.most_in_flight = 0
        real = grid_mod.GridColumn.dispatch
        card = self

        def dispatch(col, kind, rows, seq=0):
            with card.lock:
                card.launches.append((seq, len(rows)))
                if card.fail_launch.get(seq, 0) > 0:
                    card.fail_launch[seq] -= 1
                    raise RuntimeError(f"injected launch fault {seq}")
                card.in_flight += 1
                card.most_in_flight = max(card.most_in_flight,
                                          card.in_flight)
            return _Late(card, seq, real(col, kind, rows, seq))

        monkeypatch.setattr(grid_mod.GridColumn, "dispatch", dispatch)

    def release(self):
        """Let every held batch, and every later one, leave the card."""
        with self.lock:
            self.hold = False
            held, self.held = self.held, []
        for ev in held:
            ev.set()

    def launched(self, count, timeout=30.0):
        """Wait until ``count`` launches were made."""
        end = time.monotonic() + timeout
        while len(self.launches) < count and time.monotonic() < end:
            time.sleep(0.002)
        return len(self.launches) >= count


class _Late:
    asynchronous = True

    def __init__(self, card, seq, inner):
        self.card, self.seq, self.inner = card, seq, inner
        self.n = inner.n
        self._ready = threading.Event()
        with card.lock:
            if card.hold:
                card.held.append(self._ready)
            else:
                threading.Timer(card.delay, self._ready.set).start()

    def synchronize(self):
        assert self._ready.wait(60)

    def wait(self):
        self.synchronize()
        card = self.card
        with card.lock:
            card.in_flight -= 1
            card.waited.append(self.seq)
            if card.fail_wait.get(self.seq, 0) > 0:
                card.fail_wait[self.seq] -= 1
                raise RuntimeError(f"injected readback fault {self.seq}")
        return self.inner.wait()

    def device_s(self):
        return 1e-3


def _queue(s, payloads, base=600):
    """Put ``payloads`` in the coefficient queue at once (one take sees
    them all), as requests ``base``, ``base + 1`` ..."""
    with s._lock:
        reqs = [sv.ServeRequest(base + i, "coefficients", pay, None)
                for i, pay in enumerate(payloads)]
        s._queues["coefficients"].extend(reqs)
        s._work.notify_all()
    return reqs


def _completion_order(monkeypatch):
    order = []
    real = sv.ServeRequest._complete

    def complete(self, logits, tier):
        order.append(self.rid)
        real(self, logits, tier)

    monkeypatch.setattr(sv.ServeRequest, "_complete", complete)
    return order


def test_window_completes_in_order_with_at_most_two_launched(
        served, model, monkeypatch):
    p, ladder = served
    card = _LateCard(monkeypatch, delay=0.02)
    order = _completion_order(monkeypatch)
    with _sched(ladder, batch=2) as s:
        s.warmup(kinds=("coefficients",))
        reqs = _queue(s, [model[4][i % 6] for i in range(12)])
        assert s.drain(timeout=120)
        health = s.health()
    assert all(r.result() is not None for r in reqs)
    assert order == sorted(order) == [r.rid for r in reqs]
    assert card.waited == list(range(6))
    assert card.most_in_flight == 2 and card.in_flight == 0
    assert health["overlapped_batches"] == 5 and health["in_flight"] == 0


def test_window_answers_are_bit_identical_to_the_serial_path(
        served, model, monkeypatch):
    """The same full batches, at the same tiers (two tiers in flight at
    once), through the window and through the eager serial path."""
    p, ladder = served
    payloads = [model[4][i % 6] for i in range(12)]
    got = []
    for late in (False, True):
        with monkeypatch.context() as mp:
            if late:
                card = _LateCard(mp, delay=0.01)
            with _sched(ladder) as s:
                s.selector = _Forced(len(ladder.tiers),
                                     tier_names=s.tier_names,
                                     on_switch=s._on_switch)
                s.warmup(kinds=("coefficients",))
                reqs = _queue(s, payloads)
                assert s.drain(timeout=120)
        got.append([(r.tier, r.result()) for r in reqs])
    assert card.most_in_flight == 2
    assert len({t for t, _ in got[1]}) == 3
    for (ta, a), (tb, b) in zip(*got):
        assert ta == tb and np.array_equal(a, b)


@pytest.mark.parametrize("where", ["launch", "readback"])
@pytest.mark.parametrize("times", [1, 2])
def test_window_failure_touches_only_its_own_batch(served, model,
                                                    monkeypatch, where,
                                                    times):
    """Batch 1 of 3 fails at its launch or at its readback, once (retried:
    everything served) or twice (the retry budget of one runs out: batch 1
    alone fails, stage ``executor``); the batches around it are served,
    in order."""
    p, ladder = served
    fault = {1: times}
    card = _LateCard(monkeypatch, delay=0.02,
                     fail_launch=fault if where == "launch" else None,
                     fail_wait=fault if where == "readback" else None)
    order = _completion_order(monkeypatch)
    with _sched(ladder, batch=2, executor_retries=1) as s:
        s.warmup(kinds=("coefficients",))
        reqs = _queue(s, [model[4][i] for i in range(6)])
        assert s.drain(timeout=120)
        health = s.health()
    bad = reqs[2:4] if times == 2 else []
    for r in reqs:
        if r in bad:
            with pytest.raises(sv.RequestFailed) as ei:
                r.result(timeout=1)
            assert ei.value.stage == "executor"
        else:
            assert r.result(timeout=1) is not None
    assert order == [r.rid for r in reqs if r not in bad]
    assert health["failures_total"] == ({"executor": 2} if bad else {})
    assert health["in_flight"] == 0 and card.in_flight == 0
    assert card.most_in_flight <= 2


@pytest.mark.parametrize("drain", [True, False])
def test_close_with_two_batches_in_flight(served, model, monkeypatch,
                                          drain):
    """Two batches launched and held on the card, a third queued:
    ``drain()`` times out while they are held; ``close()`` finishes both
    once they leave the card, and serves the queued one (``drain=True``)
    or fails it (``drain=False``)."""
    p, ladder = served
    card = _LateCard(monkeypatch, hold=True)
    s = _sched(ladder, batch=2)
    s.warmup(kinds=("coefficients",))
    reqs = _queue(s, [model[4][i] for i in range(6)])
    assert card.launched(2)
    time.sleep(0.05)
    assert len(card.launches) == 2 and card.in_flight == 2
    assert s.health()["in_flight"] == 4
    assert s.drain(timeout=0.1) is False
    closer = threading.Thread(target=s.close, kwargs={"drain": drain})
    closer.start()
    time.sleep(0.05)
    assert closer.is_alive()
    card.release()
    closer.join(60)
    assert not closer.is_alive()
    assert all(r.result(timeout=1) is not None for r in reqs[:4])
    for r in reqs[4:]:
        if drain:
            assert r.result(timeout=1) is not None
        else:
            with pytest.raises(sv.SchedulerClosed):
                r.result(timeout=1)
    assert s.health()["in_flight"] == 0 and card.in_flight == 0


def test_take_waits_for_a_whole_batch_while_one_is_on_the_card(
        served, model, monkeypatch):
    """With batch 0 held on the card, requests submitted one by one are
    not taken until a whole batch is pending; once the card runs dry, a
    partial batch is taken at once."""
    p, ladder = served
    card = _LateCard(monkeypatch, hold=True)
    with _sched(ladder, batch=4) as s:
        s.warmup(kinds=("coefficients",))
        first = [s.submit(model[4][i]) for i in range(4)]
        assert card.launched(1)
        nxt = []
        for i in range(3):
            nxt.append(s.submit(model[4][i]))
            time.sleep(0.02)
        time.sleep(0.05)
        assert card.launches == [(0, 4)]
        nxt.append(s.submit(model[4][3]))
        assert card.launched(2)
        assert card.launches == [(0, 4), (1, 4)]
        tail = s.submit(model[4][5])
        time.sleep(0.05)
        assert len(card.launches) == 2
        card.release()
        assert tail.result(timeout=60) is not None
        assert s.drain(timeout=60)
    assert card.launches == [(0, 4), (1, 4), (2, 1)]
    assert all(r.result() is not None for r in first + nxt)


def test_eager_cpu_cell_keeps_a_window_of_one(served, model):
    """A CPU cell's dispatch has computed its logits when it returns: no
    batch is launched behind another, and each batch is completed before
    the next is gathered."""
    p, ladder = served
    tracer = sv.Tracer()
    with _sched(ladder, tracer=tracer) as s:
        s.warmup(kinds=("coefficients",))
        assert not any(c.asynchronous for c in s.grid_engine.cells())
        reqs = [s.submit(model[4][i % 6]) for i in range(11)]
        assert s.drain(timeout=120)
        assert s.health()["overlapped_batches"] == 0
    assert all(r.result() is not None for r in reqs)
    spans = [(f"{tk}/{nm}", ts, ts + d, args) for ph, tk, _, nm, ts, d, args
             in tracer.events() if ph == "X"]
    dispatches = [sp for sp in spans if sp[0] == "device/device-dispatch"]
    gathers = sorted(sp[1] for sp in spans if sp[0] == "device/gather")
    completes = sorted(sp[2] for sp in spans if sp[0] == "scheduler/complete")
    assert [d[3]["seq"] for d in dispatches] == list(range(len(dispatches)))
    assert all(d[3]["behind"] == 0 for d in dispatches)
    assert all(c <= g for c, g in zip(completes, gathers[1:]))


def test_traced_window_has_one_span_per_stage_and_seq(served, model,
                                                      monkeypatch):
    """Through the window each ``seq`` has one ``gather``, ``pad/stage``,
    ``launch`` and ``readback``, in order, inside its ``device-dispatch``
    (which now also holds the next batch's launch); one
    ``scheduler/complete`` a batch, in order; ``behind`` is 0 for the
    first batch and 1 for each launched before the last was read back;
    and the trace's chains close."""
    p, ladder = served
    _LateCard(monkeypatch, delay=0.02)
    tracer = sv.Tracer()
    with _sched(ladder, tracer=tracer) as s:
        s.warmup(kinds=("coefficients",))
        _queue(s, [model[4][i % 6] for i in range(12)])
        assert s.drain(timeout=120)
    spans = [(f"{tk}/{nm}", ts, ts + d, args) for ph, tk, _, nm, ts, d, args
             in tracer.events() if ph == "X"]
    dispatches = sorted((sp for sp in spans
                         if sp[0] == "device/device-dispatch"),
                        key=lambda sp: sp[3]["seq"])
    assert [d[3]["seq"] for d in dispatches] == [0, 1, 2]
    assert [d[3]["behind"] for d in dispatches] == [0, 1, 1]
    stages = ("device/gather", "device/pad/stage", "device/launch",
              "device/readback")
    for _, a, b, args in dispatches:
        mine = sorted((t0, name, t1) for name, t0, t1, sa in spans
                      if name in stages and sa["seq"] == args["seq"])
        assert [name for _, name, _ in mine] == list(stages)
        assert all(x[2] <= y[0] for x, y in zip(mine, mine[1:]))
        assert a <= mine[0][0] and mine[-1][2] <= b
    completes = sorted(sp for sp in spans if sp[0] == "scheduler/complete")
    assert [c[3]["n"] for c in completes] == [4, 4, 4]
    for (_, _, b, _), done in zip(dispatches, completes):
        assert done[1] >= b
    later = dispatches[1]
    assert any(name == "device/launch" and sa["seq"] == 2
               and later[1] <= t0 <= later[2]
               for name, t0, _, sa in spans)
    summ = sv.validate_trace(tracer.export())
    assert summ["open_chains"] == [] and summ["complete"] == 12


def test_window_under_contention(served, model, monkeypatch):
    """Eight client threads submit and wait at a short switch interval
    while the fake card completes batches after random delays: every
    request is answered once, with its own payload's logits, and the
    window never holds more than two batches."""
    p, ladder = served
    card = _LateCard(monkeypatch, delay=0.003)
    want = {}
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _sched(ladder, max_pending=256) as s:
            s.warmup(kinds=("coefficients",))
            for i in range(6):
                want[i] = s.submit(model[4][i]).result(timeout=60)

            def client(k):
                try:
                    for j in range(25):
                        i = (k + j) % 6
                        got = s.submit(model[4][i]).result(timeout=60)
                        _close(got, want[i], SERVE_RTOL)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            assert s.drain(timeout=60)
            health = s.health()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert card.most_in_flight <= 2 and card.in_flight == 0
    assert health["in_flight"] == 0
    assert s.images_served == 6 + 8 * 25


def test_metrics_report_has_the_references_keys():
    """The same events into both recorders: the same report keys (nested
    too) and the same Prometheus exposition."""
    t = [50.0]
    ms = [sv.ServeMetrics(clock=lambda: t[0]),
          ref_sv.ServeMetrics(clock=lambda: t[0])]
    stats = ing.IngestStats(4, 64, 1000, np.linspace(1, 0, 64),
                            np.linspace(1, 0, 64))
    for m in ms:
        m.record_request(0.010, tier="top")
        m.record_request(0.030, tier="b32", deadline_missed=True)
        m.record_batch("top", 3, 0.02, queue_depth=5, ingest_s=0.01,
                       slots=4, cell="top/bytes/b4")
        m.record_batch("b32", 1, 0.01, slots=1, cell="b32/bytes/b1")
        m.record_compile("top/bytes/b4")
        m.record_compile("b32/bytes/b1", post_warmup=True)
        m.record_switch(1, "top", "b32", "queue depth")
        m.record_failure("codec", 2)
        m.record_rejected()
        m.record_deadline_shed()
        m.record_pool_restarts(1)
        m.record_breaker("closed", "open", "executor")
        m.record_ingest(stats)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    got, want = ms[0].report(), ms[1].report()
    assert keys(got) == keys(want)
    assert got == want
    assert ms[0].metrics_text() == ms[1].metrics_text()


# --------------------------------------------------------------------------
# The command line
# --------------------------------------------------------------------------


def test_serve_qos_restores_plan_and_ladder(scratch):
    """``serve --qos --plan-dir`` twice: the first run builds and saves
    the plan, its schedule and the ladder; the second restores them and
    reports the same top-1 classes."""
    d = str(scratch / "plan")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "jpeg-resnet", "--reduced", "--device", "cpu", "--qos",
           "--ingest", "bytes", "--batch", "4", "--requests", "8",
           "--plan-dir", d]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               JPEG_INGEST_WORKERS="2")
    reports = []
    for i in range(2):
        out = str(scratch / f"report{i}.json")
        proc = subprocess.run(
            cmd + ["--report-out", out, "--trace-out",
                   str(scratch / f"trace{i}.json")], env=env,
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(out) as f:
            reports.append(json.load(f))
        assert reports[-1] == json.loads(proc.stdout.strip().splitlines()[-1])
    first, second = reports
    assert first["plan"]["built"] and not second["plan"]["built"]
    assert not first["qos"]["ladder"]["restored"]
    assert second["qos"]["ladder"]["restored"]
    for r in reports:
        assert r["completed"] == 8 and r["device"] == "cpu"
        assert r["qos"]["compiles_post_warmup"] == 0
        assert r["qos"]["ingest_pool"]["workers"] == 2
        assert [t["name"] for t in r["qos"]["tiers"]] == [
            "top", "b48", "b32", "b24"]
        assert r["meta"]["band_tiers"][0]["bands"] == [64]
    assert first["labels"] == second["labels"]
    assert None not in first["labels"]
    for i in range(2):
        with open(scratch / f"trace{i}.json") as f:
            assert sv.validate_trace(json.load(f))["complete"] == 8


def test_serve_scopes_its_dispatch_flags_and_writes_no_plan_by_default(
        scratch, monkeypatch):
    """Two differences from the reference's entry point: ``--dispatch`` /
    ``--bands`` hold for the run only (``dispatch.override``; the
    reference calls ``configure``), and without ``--plan-dir`` the plan is
    built in-process and nothing is written (the reference saves to
    ``plans/<arch>``)."""
    from repro_torch.launch import serve

    monkeypatch.chdir(scratch)
    monkeypatch.setattr(dsp, "_CONFIG", None)
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    before = dsp.get_config()
    args = serve.parse_args(["--arch", "jpeg-resnet", "--reduced",
                             "--device", "cpu", "--dispatch", "pallas",
                             "--bands", "16", "--batch", "2",
                             "--requests", "2", "--max-new", "1"])
    out = serve.serve_jpeg_resnet(args)
    assert out["dispatch"] == "cuda" and out["plan"]["dir"] is None
    assert set(out["plan"]["bands"].values()) == {16}
    assert dsp.get_config() == before
    assert os.listdir(scratch) == []
