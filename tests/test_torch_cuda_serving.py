"""The serving runtime's CUDA-only parts, on the card: graph capture of the
compiled walk (``core.plan.capture_compiled``), pinned staging, one graph
memory pool a grid, launch counts under replay, and the scheduler's
worker thread replaying graphs on the ladder's device.

Needs an NVIDIA GPU of compute capability 9.0 and ``nvcc``; skipped
elsewhere.  No JAX: run on the card with

    python -m pytest -q tests/test_torch_cuda_serving.py

The reduced ``jpeg-resnet`` (widths 16/32/64, 32 px) from seeded random
weights; a replay is held against the same schedule run eagerly within
1e-5 of the largest |logit| (the same kernels on the same operands).
"""
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
