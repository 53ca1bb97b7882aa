"""The serving runtime's CUDA-only parts, on the card: graph capture of the
compiled walk (``core.plan.capture_compiled``), pinned staging, one graph
memory pool a grid, launch counts under replay, the scheduler's worker
thread replaying graphs on the ladder's device, the spatial lowering
under a replay (bit-identical to its eager walk), ``GridCell.profile``
(bit-identical to the replay, no capture), and two batches in flight
(``GridCell.dispatch``: one cell twice, two buckets, two tiers, the pinned
slots reused, each bit for bit against the serial replay; the wall a
queued batch records).

Needs an NVIDIA GPU of compute capability 9.0 and ``nvcc``; skipped
elsewhere.  No JAX: run on the card with

    python -m pytest -q tests/test_torch_cuda_serving.py

The reduced ``jpeg-resnet`` (widths 16/32/64, 32 px) from seeded random
weights; a replay is held against the same schedule run eagerly within
1e-5 of the largest |logit| (the same kernels on the same operands).
"""
import statistics
import time

import numpy as np
import pytest
import torch

from repro_torch import kernels, serving
from repro_torch.configs import reduced_config
from repro_torch.configs.jpeg_resnet import spec_of
from repro_torch.core import dispatch as dsp
from repro_torch.core import plan as planlib
from repro_torch.core import resnet as resnetlib
from repro_torch.kernels import _build

pytestmark = pytest.mark.cuda

RTOL = 1e-5
GRID = (4, 4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (capability 9.0)")
    _build.library()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ladder(dev):
    spec = spec_of(reduced_config("jpeg-resnet"))
    params, state = resnetlib.init_resnet(torch.Generator().manual_seed(0),
                                          spec, dev)
    plan = planlib.build_plan(params, state, spec,
                              dispatch=dsp.DispatchConfig(bands=32))
    return serving.build_ladder(plan, caps=(None, 16))


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= RTOL * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("packed", [True, False])
def test_replay_matches_the_eager_walk(dev, ladder, packed):
    cp = ladder.top.compiled
    shape = ((4, *GRID, 3 * cp.stem.w_in) if packed
             else (4, *GRID, 3, 64))
    fn = planlib.capture_compiled(cp, shape, packed=packed, device=dev)
    assert isinstance(fn.graph, torch.cuda.CUDAGraph)
    apply = planlib.apply_compiled_packed if packed \
        else planlib.apply_compiled
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.inference_mode():
        for _ in range(3):
            x = torch.randn(shape, generator=gen, device=dev)
            _close(fn(x).clone(), apply(cp, x))
    with pytest.raises(ValueError, match="pinned to shape"):
        fn(torch.zeros((2, *shape[1:]), device=dev))


def test_capture_records_launches_and_launches_nothing(dev, ladder):
    """The wrappers count on the host: a capture records kernels without
    launching them, so the counts come back as they were, and
    ``graph_launches`` is what one eager forward launches."""
    cp = ladder.tiers[1].compiled
    shape = (2, *GRID, 3 * cp.stem.w_in)
    x = torch.zeros(shape, device=dev)
    with torch.inference_mode():
        planlib.apply_compiled_packed(cp, x)
        before = kernels.launch_counts()
        planlib.apply_compiled_packed(cp, x)
        eager = {k: v - before[k] for k, v in kernels.launch_counts().items()
                 if v != before[k]}
    fn = planlib.capture_compiled(cp, shape, packed=True, device=dev)
    after_capture = kernels.launch_counts()
    assert fn.graph_launches == eager and eager.get("fused_block", 0) > 0
    fn(x)
    fn(x)
    assert kernels.launch_counts() == after_capture


def test_static_output_is_overwritten_by_the_next_replay(dev, ladder):
    cp = ladder.top.compiled
    shape = (1, *GRID, 3 * cp.stem.w_in)
    fn = planlib.capture_compiled(cp, shape, packed=True, device=dev)
    a = fn(torch.ones(shape, device=dev))
    first = a.clone()
    b = fn(torch.zeros(shape, device=dev))
    torch.cuda.synchronize()
    assert a is b and not torch.equal(first, b)


def test_grid_pins_staging_shares_one_pool_and_counts_replays(dev, ladder):
    captured = []
    g = serving.PlanGrid(ladder, batch=4, grid=GRID,
                         on_compile=captured.append)
    g.warmup(kinds=("bytes",))
    assert g.pool.pin and g.graph_pool is not None
    assert len(captured) == 2 * 3 and g.summary()["cuda_graphs"]
    col = g.columns[0]
    rows = np.random.default_rng(2).normal(
        size=(3, *GRID, 3 * col.w_in)).astype(np.float32)
    out = col.packed_fn(rows)
    want = planlib.apply_compiled_packed(
        col.compiled, torch.as_tensor(rows).to(dev))
    _close(out[:3].clone(), want)
    cell = col.cells[("bytes", 4)]
    assert cell.hits == 1 and cell.replays == 2
    assert cell._pool.get((4, *GRID, 3 * col.w_in)).is_pinned()
    per = cell.graph_launches
    total = g.graph_launches()
    assert all(total[k] >= per[k] * 2 for k in per)
    assert cell.time_wall(iters=2) > 0.0


def test_scheduler_replays_graphs_from_its_worker_thread(dev, ladder):
    """Logits served through the scheduler equal each tier's eager
    schedule; every batch is a replay; no capture after warmup."""
    gen = torch.Generator(device=dev).manual_seed(4)
    coef = torch.randn((10, *GRID, 3, 64), generator=gen, device=dev)
    with serving.BandElasticScheduler(ladder, batch=4, grid=GRID,
                                      channels=3) as s:
        s.warmup(kinds=("coefficients",))
        reqs = [s.submit(coef[i].cpu().numpy()) for i in range(10)]
        s.drain(timeout=120)
    rep = s.metrics.report()
    assert rep["compiles_post_warmup"] == 0
    tiers = {t.name: t.compiled for t in ladder.tiers}
    with torch.inference_mode():
        for i, r in enumerate(reqs):
            want = planlib.apply_compiled(tiers[r.tier], coef[i:i + 1])
            _close(torch.as_tensor(r.result()).to(dev)[None], want)
    hits = sum(c.hits for c in s.grid_engine.cells())
    assert hits == sum(t["batches"] for t in rep["per_tier"].values())


@pytest.mark.parametrize("packed", [True, False])
def test_spatial_replay_is_bit_identical_to_eager(dev, packed):
    """A plan compiled on the ``reference`` path runs its stem and fused
    blocks through the spatial lowering (cuDNN convs, fp32): a CUDA graph
    replay of it equals its eager walk bit for bit (cuDNN's heuristic
    picks the same algorithm in every walk)."""
    spec = spec_of(reduced_config("jpeg-resnet"))
    params, state = resnetlib.init_resnet(torch.Generator().manual_seed(0),
                                          spec, dev)
    cp = planlib.compile_plan(planlib.build_plan(
        params, state, spec,
        dispatch=dsp.DispatchConfig(path="reference", bands=16)))
    assert cp.meta["path"] == "reference" and cp.meta["fused"]
    shape = ((4, *GRID, 3 * cp.stem.w_in) if packed
             else (4, *GRID, 3, 64))
    fn = planlib.capture_compiled(cp, shape, packed=packed, device=dev)
    apply = planlib.apply_compiled_packed if packed \
        else planlib.apply_compiled
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.inference_mode():
        for _ in range(2):
            x = torch.randn(shape, generator=gen, device=dev)
            got = fn(x).clone()
            assert torch.equal(got, apply(cp, x))
            prof = planlib.StepProfile()
            assert torch.equal(got, apply(cp, x, profile=prof))


@pytest.mark.parametrize("executor", [None, "gemm"])
def test_cell_profile_on_the_card_is_inert(dev, ladder, executor):
    """``GridCell.profile`` walks the cell's schedule eagerly: its logits
    equal the cell's graph replay bit for bit, and it captures nothing."""
    captured = []
    g = serving.PlanGrid(ladder, batch=4, grid=GRID, executor=executor,
                         on_compile=captured.append)
    g.warmup(kinds=("bytes",))
    n = len(captured)
    col = g.columns[0]
    cell = col.cells[("bytes", 4)]
    rows = np.random.default_rng(6).normal(
        size=(3, *GRID, 3 * col.w_in)).astype(np.float32)
    want = cell(rows).cpu().numpy()
    prof = cell.profile(rows, iters=2)
    assert np.array_equal(prof["logits"], want)
    assert prof["cell_wall_us"] > 0 and len(captured) == n


# --------------------------------------------------------------------------
# Two batches in flight (the scheduler's launch window)
# --------------------------------------------------------------------------


def _grid(ladder, batch=4, buckets=None):
    g = serving.PlanGrid(ladder, batch=batch, buckets=buckets, grid=GRID)
    g.warmup(kinds=("bytes",))
    return g


def _rows(col, n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, *GRID, 3 * col.w_in)).astype(np.float32)


def _serial(col, rows):
    """The serial path: ``__call__`` and a copy to the host."""
    return col.packed_fn(rows).cpu().numpy()[:len(rows)]


def test_one_cell_twice_in_flight_is_bit_identical(dev, ladder):
    col = _grid(ladder).columns[0]
    a, b = _rows(col, 4, 10), _rows(col, 4, 11)
    want = [_serial(col, a), _serial(col, b)]
    da = col.dispatch("bytes", a, 0)
    db = col.dispatch("bytes", b, 1)     # no readback in between
    assert da.asynchronous and db.asynchronous
    got = [da.wait(), db.wait()]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_two_buckets_and_two_tiers_in_flight_are_bit_identical(dev, ladder):
    g = _grid(ladder)
    top, low = g.columns[0], g.columns[1]
    assert top is not low
    cases = [(top, _rows(top, 3, 12)), (top, _rows(top, 1, 13)),
             (low, _rows(low, 4, 14)), (top, _rows(top, 2, 15))]
    want = [_serial(col, rows) for col, rows in cases]
    pending = []
    for seq, (col, rows) in enumerate(cases):
        pending.append(col.dispatch("bytes", rows, seq))
        if len(pending) > 2:          # a window of two, as the worker's
            pending[-3] = pending[-3].wait()
    got = [p if isinstance(p, np.ndarray) else p.wait() for p in pending]
    for gg, w in zip(got, want):
        assert np.array_equal(gg, w)


def test_pinned_slots_are_reused_safely(dev, ladder):
    """Forty dispatches through the two slots of one cell, each read back
    only after the next was launched: every answer is its own batch's."""
    g = _grid(ladder)
    col = g.columns[0]
    batches = [_rows(col, 4, 100 + k) for k in range(40)]
    want = [_serial(col, rows) for rows in batches]
    n_bufs = len(g.pool)
    prev = None
    for k, rows in enumerate(batches):
        d = col.dispatch("bytes", rows, k)
        if prev is not None:
            assert np.array_equal(prev[1].wait(), want[prev[0]])
        prev = (k, d)
    assert np.array_equal(prev[1].wait(), want[prev[0]])
    assert len(g.pool) == n_bufs      # warm-up allocated every slot
    assert all(b.is_pinned() for b in g.pool._bufs.values())


def test_a_batch_queued_behind_another_records_its_own_wall(dev, ladder):
    """The wall the scheduler hands the QoS selector (host staging plus
    the batch's own time between its events) for a full batch launched
    behind another stays within 10 % of the same batch run alone; the
    host clock from its launch to its logits would read about twice."""
    g = _grid(ladder, batch=256, buckets=(256,))
    col = g.columns[0]
    rows = _rows(col, 256, 20)

    def wall(behind):
        first = col.dispatch("bytes", rows, 0) if behind else None
        t0 = time.monotonic()
        d = col.dispatch("bytes", rows, 1)
        staged = time.monotonic() - t0
        if first is not None:
            first.wait()
        d.wait()
        return staged + d.device_s(), time.monotonic() - t0

    for behind in (False, True):
        wall(behind)
    alone = statistics.median(wall(False)[0] for _ in range(9))
    runs = [wall(True) for _ in range(9)]
    behind = statistics.median(w for w, _ in runs)
    host = statistics.median(h for _, h in runs)
    assert abs(behind - alone) <= 0.10 * alone, (behind, alone)
    assert host > 1.5 * alone, (host, alone)


def test_scheduler_overlaps_full_batches_bit_identically(dev, ladder):
    """Three full batches queued at once: each is launched behind the one
    before, and every answer equals its batch's serial replay bit for
    bit."""
    gen = np.random.default_rng(21)
    coef = gen.normal(size=(12, *GRID, 3, 64)).astype(np.float32)
    s = serving.BandElasticScheduler(ladder, batch=4, grid=GRID, channels=3)
    try:
        s.warmup(kinds=("coefficients",))
        with s._lock:
            reqs = [serving.ServeRequest(500 + i, "coefficients", coef[i],
                                         None) for i in range(12)]
            s._queues["coefficients"].extend(reqs)
            s._work.notify_all()
        assert s.drain(timeout=120)
        assert s.health()["overlapped_batches"] == 2
    finally:
        s.close()
    for k in range(3):
        part = reqs[4 * k: 4 * k + 4]
        tiers = {r.tier for r in part}
        assert len(tiers) == 1
        col = s._execs[s.tier_names.index(tiers.pop())]
        want = col.coef_fn(coef[4 * k: 4 * k + 4]).cpu().numpy()
        for i, r in enumerate(part):
            assert np.array_equal(r.result(), want[i])
