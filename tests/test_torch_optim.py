"""The port's optimizers, schedules, gradient clipping and checkpoint
manager against the reference package's, on trees drawn by numpy.

Tolerances: one optimizer update 1e-6 relative (the same float32
operations; ``pow`` and ``sqrt`` may round differently by an ulp); the
schedules and norms 1e-6 relative.  Checkpoints are compared bit for bit.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import global_norm as ref_global_norm
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import make_schedule as ref_make_schedule
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import OptState, clip_by_global_norm, global_norm, \
    make_optimizer, make_schedule
from repro_torch.tree import leaves, leaves_with_paths, tree_map

# one intra-op thread: the suite runs in parallel workers beside
# wall-clock tests of the reference package
torch.set_num_threads(1)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {"params": {"stem": {"kernel": a(4, 3, 3, 3)},
                       "head": {"w": a(4, 5), "b": a(5)}},
            "bn_state": {"stem_bn": {"mean": a(4), "var": a(4)}}}


def _torch(tree):
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(got, want, rtol, atol=0.0):
    got_l = leaves_with_paths(got)
    want_l = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_l] == \
        ["/".join(str(k) for k in p) for p, _ in want_l]
    for (_, g), (_, w) in zip(got_l, want_l):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


def test_tree_paths_follow_jax():
    tree = {"b": {"z": 1, "a": 2}, "a": [3, 4],
            "o": OptState(np.float32(0), {"m": 5}), "n": None}
    want = [("/".join(str(k) for k in p), v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert leaves_with_paths(tree) == want
    assert leaves(tree) == [v for _, v in want]


@pytest.mark.parametrize("name,kw", [
    ("adamw", {"weight_decay": 0.1}),
    ("sgd", {"momentum": 0.9, "weight_decay": 0.01}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("lion", {"weight_decay": 0.1}),
])
def test_optimizer_updates_match_reference(name, kw):
    params = _tree(0)
    ref_opt = ref_make_optimizer(name, **kw)
    opt = make_optimizer(name, **kw)
    rp, rs = _jax(params), ref_opt.init(_jax(params))
    tp, ts = _torch(params), opt.init(_torch(params))
    for step in range(3):
        grads = _tree(10 + step, scale=0.3)
        lr = 1e-2 * (step + 1)
        rp, rs = ref_opt.update(_jax(grads), rs, rp, jnp.float32(lr))
        tp, ts = opt.update(_torch(grads), ts, tp,
                            torch.tensor(lr, dtype=torch.float32))
        _assert_trees_close(tp, rp, rtol=1e-6, atol=1e-7)
        _assert_trees_close(ts.inner, rs.inner, rtol=1e-6, atol=1e-7)
        assert int(ts.step) == int(rs.step) == step + 1
        assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("name", ["cosine", "linear", "constant"])
def test_schedules_match_reference(name):
    ref = ref_make_schedule(name, 1e-3, 5, 40)
    port = make_schedule(name, 1e-3, 5, 40)
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 55):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(jnp.int32(step))),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(port(step)), float(got), rtol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(3)
    want, want_norm = ref_clip(_jax(grads), max_norm)
    got, norm = clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(_torch(grads))),
                               float(ref_global_norm(_jax(grads))),
                               rtol=1e-6)
    _assert_trees_close(got, want, rtol=1e-6)


def _opt_tree(seed):
    params = _torch(_tree(seed))
    return {"params": params, "opt": make_optimizer("adamw").init(params)}


def test_checkpoint_round_trip_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    trees = {s: _opt_tree(s) for s in (1, 2, 3)}
    for s, tree in trees.items():
        mgr.save(s, tree, extra={"data_state": {"seed": 0, "step": s}},
                 blocking=s != 2)
    mgr.wait()
    assert mgr.steps() == [2, 3]
    step, tree, extra = mgr.restore_latest(_opt_tree(99))
    assert step == 3 and extra == {"data_state": {"seed": 0, "step": 3}}
    for a, b in zip(leaves(tree), leaves(trees[3])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tree["opt"].step.dtype == torch.int32


def test_corrupt_newest_checkpoint_is_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _opt_tree(1))
    mgr.save(2, _opt_tree(2))
    path = tmp_path / "step_2" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    step, tree, _ = mgr.restore_latest(_opt_tree(99))
    assert step == 1
    assert torch.equal(tree["params"]["params"]["head"]["w"],
                       _opt_tree(1)["params"]["params"]["head"]["w"])
    with pytest.raises(FileNotFoundError):
        mgr.restore_tree(2)
    # a half-written step (no rename yet) is not a step
    os.makedirs(tmp_path / "step_7.tmp")
    assert mgr.steps() == [1, 2]


def test_checkpoints_cross_read_with_reference(tmp_path):
    """Same on-disk layout and leaf paths: each package restores the
    other's arrays bit for bit."""
    tree = _opt_tree(5)
    CheckpointManager(str(tmp_path / "port")).save(
        4, tree, extra={"data_state": {"seed": 1, "step": 4}})
    step, by_path, extra = RefManager(str(tmp_path / "port")).restore_tree()
    assert step == 4 and extra["data_state"]["step"] == 4
    want = dict(leaves_with_paths(tree))
    assert set(by_path) == set(want)
    for p, arr in by_path.items():
        np.testing.assert_array_equal(arr, want[p].numpy())

    ref_tree = {"params": _jax(_tree(6))}
    RefManager(str(tmp_path / "ref")).save(3, ref_tree)
    step, got, _ = CheckpointManager(str(tmp_path / "ref")).restore_latest(
        {"params": _torch(_tree(0))})
    assert step == 3
    _assert_trees_close(got, ref_tree, rtol=0)
    manifest = json.loads((tmp_path / "ref" / "step_3" /
                           "manifest.json").read_text())
    assert {m["path"] for m in manifest["leaves"].values()} == \
        {p for p, _ in leaves_with_paths(got)}
