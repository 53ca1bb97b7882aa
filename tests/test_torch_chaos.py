"""The port's fault injection (``repro_torch.serving.faults``) and the
chaos contract of ``tests/test_chaos.py``, on the CPU.

* ``FaultInjector.corrupt`` is byte-identical to the reference's for the
  same (seed, index), in every mode; the guaranteed-fail modes raise the
  port's typed ``CodecError``;
* in the scheduler: corrupt requests fail alone (stage ``codec``) and the
  healthy ones keep an unfaulted run's logits (within 1e-5); an executor
  fault burns the retry and fails only its batch, a transient one
  succeeds on retry; infrastructure dying under a decode batch fails only
  that batch; the breaker walks closed → open → half-open → closed; a
  killed decode worker is respawned (``pool_restarts``); ``close`` returns
  when the worker dies while the decoded queue is full;
* ``serve --qos --chaos`` (reduced, CPU) completes every healthy request
  and reports the reference's ``chaos`` keys; ``--metrics-out`` holds the
  reference's metric families, ``--jax-profile`` a trace file; the
  parser takes every flag of the reference's, with its defaults;
  ``--chaos`` without byte traffic raises; ``--profile-grid`` (with and
  without ``--hw-profile``) writes the report's ``profile_grid``.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.serving import faults as ref_faults
from repro.serving import metrics as ref_metrics
from repro_torch import serving as sv
from repro_torch.codec import CodecError, decode_bytes
from repro_torch.codec import encode as enc
from repro_torch.codec import ingest as ing
from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan
from repro_torch.core import resnet
from repro_torch.serving.faults import FaultInjector, FaultSpec, InjectedFault
from repro_torch.serving.qos import QosPolicy
from test_torch_plan import numpy_params

torch.set_num_threads(1)

SPEC = resnet.ResNetSpec(widths=(6, 8), num_classes=10)
#: healthy logits in a faulted run against an unfaulted one (the same
#: tier's executable; the batch-mates differ)
ATOL = 1e-5
CHAOS_KEYS = {"corrupted", "corrupt_modes", "killed_worker_pid",
              "failed_by_stage", "healthy_total", "healthy_completed"}


@pytest.fixture(scope="module")
def setup():
    params, state = numpy_params(SPEC)
    tparams, tstate = resnet.params_from_numpy(params, state, device="cpu")
    coef = np.random.default_rng(1).normal(
        size=(6, 2, 2, 3, 64)).astype(np.float32)
    p = plan.build_plan(tparams, tstate, SPEC,
                        dispatch=dsp.DispatchConfig(path="reference"))
    return p, sv.build_ladder(p, caps=(None, 16)), coef


@pytest.fixture(scope="module")
def two_workers():
    """One decode pool of two workers for the module's tests that kill
    one (a killed worker's pool is respawned by the supervisor)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JPEG_INGEST_WORKERS", "2")
        try:
            yield
        finally:
            ing.shutdown_pool()


def _sched(ladder, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("grid", (2, 2))
    kw.setdefault("channels", 3)
    return sv.BandElasticScheduler(ladder, **kw)


def _jpeg_traffic(n, seed=0):
    rng = np.random.default_rng(seed)
    qt = np.rint(dctlib.quantization_table(
        75, dc_is_mean=False)).astype(np.int64)
    return [enc.encode_pixels(
        np.clip(rng.normal(0, 0.3, (3, 16, 16)), -1.0, 127.0 / 128.0),
        qtable=qt) for _ in range(n)]


def _lenient():
    """A breaker that never trips: for tests of containment."""
    return sv.BreakerPolicy(max_consecutive=10_000, min_samples=10_000)


# --------------------------------------------------------------------------
# Deterministic placement, byte for byte the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("modes,rate", [(("truncate",), 1.0),
                                        (("marker",), 1.0),
                                        (("bitflip",), 1.0),
                                        (("truncate", "marker"), 0.4)])
def test_corrupt_is_byte_identical_to_the_references(modes, rate):
    datas = _jpeg_traffic(24, seed=6)
    port = FaultInjector(FaultSpec(seed=11, corrupt_rate=rate,
                                   corrupt_modes=modes))
    ref = ref_faults.FaultInjector(ref_faults.FaultSpec(
        seed=11, corrupt_rate=rate, corrupt_modes=modes))
    got = [port.corrupt(i, d) for i, d in enumerate(datas)]
    want = [ref.corrupt(i, d) for i, d in enumerate(datas)]
    assert got == want and port.corrupted == ref.corrupted
    assert port.corrupted
    again = FaultInjector(port.spec)
    assert [again.corrupt(i, d) for i, d in enumerate(datas)] == got
    for i, d in enumerate(datas):
        if i not in port.corrupted:
            assert got[i] == d


def test_guaranteed_fail_modes_raise_the_typed_codec_error():
    datas = _jpeg_traffic(8, seed=8)
    inj = FaultInjector(FaultSpec(seed=5, corrupt_rate=1.0))
    for i, d in enumerate(datas):
        mutated = inj.corrupt(i, d)
        assert mutated != d
        with pytest.raises(CodecError):
            decode_bytes(mutated, quality=75, grid=(2, 2))
    assert sorted(inj.corrupted) == list(range(8))


# --------------------------------------------------------------------------
# Containment in the scheduler
# --------------------------------------------------------------------------


def test_corrupt_requests_contained_healthy_parity(setup, monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder, coef = setup
    datas = _jpeg_traffic(8, seed=10)
    calm = QosPolicy(high_depth=1e9, low_depth=0.5)  # stay at the top tier
    with _sched(ladder, breaker=_lenient(), policy=calm) as s:
        want = [s.submit(d, kind="bytes").result(timeout=60) for d in datas]
    inj = FaultInjector(FaultSpec(seed=21, corrupt_rate=0.4))
    sent = [inj.corrupt(i, d) for i, d in enumerate(datas)]
    assert inj.corrupted and len(inj.corrupted) < len(datas)
    with _sched(ladder, breaker=_lenient(), policy=calm, faults=inj) as s:
        reqs = [s.submit(d, kind="bytes") for d in sent]
        for i, r in enumerate(reqs):
            if i in inj.corrupted:
                with pytest.raises(sv.RequestFailed) as ei:
                    r.result(timeout=60)
                assert ei.value.stage == "codec"
                assert isinstance(ei.value.__cause__, CodecError)
            else:
                got = r.result(timeout=60)
                np.testing.assert_allclose(got, want[i], atol=ATOL)
                assert int(np.argmax(got)) == int(np.argmax(want[i]))
        health = s.health()
    assert health["worker_alive"] and health["ingest_alive"]
    assert health["breaker"]["state"] == "closed"  # codec never feeds it
    assert s.metrics.failures_total()["codec"] == len(inj.corrupted)


def test_executor_fault_contained_and_retried(setup):
    p, ladder, coef = setup
    inj = FaultInjector(FaultSpec(executor_fail_batches=(0, 1)))
    s = _sched(ladder, breaker=_lenient(), faults=inj, executor_retries=1)
    try:
        doomed = s.submit(coef[0])  # dispatch 0: in the window
        with pytest.raises(sv.RequestFailed) as ei:
            doomed.result(timeout=60)
        assert ei.value.stage == "executor"
        assert isinstance(ei.value.__cause__, InjectedFault)
        ok = s.submit(coef[1])      # dispatch 1: outside it
        assert np.isfinite(ok.result(timeout=60)).all()
        assert s.metrics.failures_total()["executor"] == 1
        assert s.health()["worker_alive"]
    finally:
        s.close()


def test_transient_executor_fault_retry_succeeds(setup):
    p, ladder, coef = setup
    calls = []

    class Flaky:
        def on_ingest(self, reqs):
            pass

        def on_execute(self, seq, reqs):
            calls.append(seq)
            if len(calls) == 1:
                raise InjectedFault("first attempt only")

    with _sched(ladder, breaker=_lenient(), faults=Flaky(),
                executor_retries=1) as s:
        assert np.isfinite(s.submit(coef[0]).result(timeout=60)).all()
    assert calls == [0, 0]  # the same dispatch, attempted twice
    assert s.metrics.failures_total().get("executor", 0) == 0


def test_ingest_infra_failure_contained(setup, monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder, coef = setup
    datas = _jpeg_traffic(4, seed=12)
    boom = RuntimeError("decode infrastructure down")
    real = ing.ingest_batch
    fails = [True]

    def flaky(batch_datas, **kw):
        if fails and fails.pop():
            raise boom
        return real(batch_datas, **kw)

    with _sched(ladder, breaker=_lenient()) as s:
        monkeypatch.setattr(ing, "ingest_batch", flaky)
        for r in [s.submit(d, kind="bytes") for d in datas[:2]]:
            with pytest.raises(sv.RequestFailed) as ei:
                r.result(timeout=60)
            assert ei.value.stage == "ingest" and ei.value.__cause__ is boom
        for r in [s.submit(d, kind="bytes") for d in datas[2:]]:
            assert np.isfinite(r.result(timeout=60)).all()
        health = s.health()
    assert health["ingest_alive"] and health["worker_alive"]
    assert s.metrics.failures_total()["ingest"] == 2


def test_breaker_trips_fast_rejects_then_recovers(setup):
    p, ladder, coef = setup
    policy = sv.BreakerPolicy(max_consecutive=1, min_samples=10_000,
                              open_s=0.2, half_open_successes=1)
    inj = FaultInjector(FaultSpec(executor_fail_batches=(0, 1)))
    s = _sched(ladder, breaker=policy, faults=inj, executor_retries=0)
    try:
        with pytest.raises(sv.RequestFailed):
            s.submit(coef[0]).result(timeout=60)
        with pytest.raises(sv.ServiceUnavailable):
            s.submit(coef[0])
        assert s.health()["breaker"]["state"] == "open"
        assert s.metrics.failures_total()["rejected-open-breaker"] == 1
        time.sleep(0.25)  # the open timer runs out
        assert np.isfinite(s.submit(coef[0]).result(timeout=60)).all()
        deadline = time.monotonic() + 5.0
        while (s.health()["breaker"]["state"] != "closed"
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert s.health()["breaker"]["state"] == "closed"
        hops = [(e["from"], e["to"]) for e in s.metrics.breaker_timeline()]
        assert hops == [("closed", "open"), ("open", "half_open"),
                        ("half_open", "closed")]
    finally:
        s.close()


def test_pool_kill_supervised_respawn(setup, two_workers):
    p, ladder, coef = setup
    datas = _jpeg_traffic(8, seed=14)
    ing.ingest_batch(datas[:2], quality=75, grid=(2, 2))  # a live pool
    assert ing._POOL is not None
    before = ing.pool_restarts()
    inj = FaultInjector(FaultSpec(kill_worker_before_batch=1))
    with _sched(ladder, breaker=_lenient(), faults=inj, batch=4) as s:
        for r in [s.submit(d, kind="bytes") for d in datas]:
            assert np.isfinite(r.result(timeout=120)).all()
        assert s.health()["pool_restarts"] >= 1
    assert inj.killed_pid is not None
    assert ing.pool_restarts() > before
    assert s.metrics.failures_total().get("ingest", 0) == 0


class _Die(BaseException):
    """Not an Exception: no retry, no containment, the worker dies."""


def test_close_survives_worker_death_with_full_decoded_queue(setup,
                                                             monkeypatch):
    monkeypatch.setenv("JPEG_INGEST_WORKERS", "1")
    p, ladder, coef = setup
    datas = _jpeg_traffic(10, seed=16)
    release = threading.Event()

    class Poison:
        def on_ingest(self, reqs):
            pass

        def on_execute(self, seq, reqs):
            release.wait(timeout=30)  # hold dispatch until the queue jams
            raise _Die("worker killed by the chaos harness")

    s = _sched(ladder, batch=1, breaker=_lenient(), faults=Poison())
    try:
        reqs = [s.submit(d, kind="bytes") for d in datas]
        # let the ingest thread fill the decoded queue to its cap (it then
        # stalls for room), and only then kill the worker
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with s._lock:
                if len(s._decoded) >= s._decoded_cap:
                    break
            time.sleep(0.005)
        with s._lock:
            assert len(s._decoded) >= s._decoded_cap
        release.set()
        for r in reqs:
            with pytest.raises(BaseException):
                r.result(timeout=30)
            assert r.error() is not None
        done = threading.Event()

        def closer():
            try:
                s.close()
            except BaseException:
                pass  # close re-raises the worker's death
            done.set()

        t = threading.Thread(target=closer, daemon=True)
        t.start()
        assert done.wait(timeout=30), "close() deadlocked"
        t.join(timeout=5)
        assert not s._ingest_thread.is_alive()
        assert not s._worker.is_alive()
    finally:
        release.set()


# --------------------------------------------------------------------------
# serve --qos --chaos
# --------------------------------------------------------------------------


def test_serve_qos_chaos_with_metrics_and_profile(tmp_path, two_workers):
    """The drill at the reduced config: every healthy request completes,
    every corrupted one fails at the codec stage, the report's ``chaos``
    entry has the reference's keys; the metrics file and the profiler
    trace are written."""
    from repro_torch.launch import serve

    metrics, prof = str(tmp_path / "metrics.prom"), str(tmp_path / "prof")
    args = serve.parse_args([
        "--arch", "jpeg-resnet", "--reduced", "--device", "cpu", "--qos",
        "--ingest", "bytes", "--bands", "16", "--tiers", "auto,8",
        "--batch", "4", "--requests", "16", "--chaos", "--metrics-out",
        metrics, "--metrics-interval", "0.2", "--jax-profile", prof])
    out = serve.serve_jpeg_resnet(args)
    chaos = out["chaos"]
    assert set(chaos) == CHAOS_KEYS
    assert chaos["corrupted"] > 0
    assert chaos["healthy_completed"] == chaos["healthy_total"] \
        == 16 - chaos["corrupted"]
    assert chaos["failed_by_stage"] == {"codec": chaos["corrupted"]}
    assert chaos["killed_worker_pid"] is not None
    assert out["qos"]["pool_restarts"] >= 1
    assert out["qos"]["compiles_post_warmup"] == 0
    hops = [(e["from"], e["to"]) for e in out["qos"]["breaker_timeline"]]
    assert hops[:3] == [("closed", "open"), ("open", "half_open"),
                        ("half_open", "closed")]
    assert out["health"]["breaker"]["state"] == "closed"
    assert sum(lb is None for lb in out["labels"]) == chaos["corrupted"]
    # the snapshot file: the reference's metric families
    with open(metrics) as f:
        families = {ln for ln in f.read().splitlines()
                    if ln.startswith("# TYPE")}
    want = {ln for ln in ref_metrics.ServeMetrics().metrics_text()
            .splitlines() if ln.startswith("# TYPE")}
    assert families == want
    assert out["metrics_writes"] >= int(out["metrics_window_s"] / 0.2)
    assert out["profile"].startswith(prof) and os.listdir(prof)
    with open(out["profile"]) as f:
        assert json.load(f)["traceEvents"]


def test_chaos_needs_byte_traffic():
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", "jpeg-resnet", "--reduced",
                             "--device", "cpu", "--qos", "--chaos"])
    with pytest.raises(ValueError, match="--ingest bytes"):
        serve.serve_jpeg_resnet(args)


def test_serve_takes_every_flag_of_the_references():
    import re

    from repro_torch.launch import serve

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "src", "repro", "launch", "serve.py")) as f:
        want = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', f.read()))
    with open(serve.__file__) as f:
        got = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', f.read()))
    assert want and want <= got, sorted(want - got)
    args = serve.parse_args(["--arch", "jpeg-resnet", "--chaos",
                             "--no-chaos-kill-worker"])
    assert (args.chaos_rate, args.chaos_seed, args.chaos_exec_faults,
            args.metrics_interval) == (0.2, 1234, 2, 1.0)
    assert not args.chaos_kill_worker and not args.autotune_bands


@pytest.mark.parametrize("flag", [["--profile-grid"],
                                  ["--profile-grid", "--hw-profile", "cpu"]])
def test_unported_grid_profile_flags_raise(flag, tmp_path):
    """Named for what the flags did before they were ported: now each run
    sweeps every warmed cell into the report's ``profile_grid`` (written
    to ``--report-out``), with no capture after warmup."""
    from repro_torch import introspect
    from repro_torch.launch import serve

    path = str(tmp_path / "report.json")
    out = serve.main(["--arch", "jpeg-resnet", "--reduced", "--device",
                      "cpu", "--qos", "--bands", "16", "--tiers", "auto,8",
                      "--batch", "2", "--requests", "4", "--report-out",
                      path] + flag)
    with open(path) as f:
        pg = json.load(f)["profile_grid"]
    assert pg["hw_profile"] == introspect.resolve_profile(
        flag[2] if len(flag) > 1 else None).to_json()
    cells = {c["cell"] for c in pg["cells"]}
    assert cells == {f"{t}/coefficients/b{b}" for t in ("top", "b8")
                     for b in (1, 2)}
    assert all(c["predicted_req_s"] > 0 and c["measured_req_s"] > 0
               for c in pg["cells"])
    assert out["qos"]["compiles_post_warmup"] == 0
    assert set(out["qos"]["predicted_capacity_req_s"]) == cells
