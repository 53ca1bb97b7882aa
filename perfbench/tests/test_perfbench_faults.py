"""With the timed path broken underneath, a run's ``correct`` comes out
false: once for each fault a cell can have.  (Its cells run on one card,
so none has an exchange between cards to leave out.)"""
from __future__ import annotations

import time

import numpy as np
import torch

from conftest import SEED, tiny


def _run(name):
    from perfbench import run

    return run.run_cell(tiny(name), SEED, 1.0, False, torch.device("cpu"),
                        t_start=time.monotonic())


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serving import scheduler

    real = scheduler._to_host
    count = {"n": 0}

    def altered(logits):
        out = real(logits).copy()
        count["n"] += 1
        if count["n"] % 3 == 0:       # one answer in every third batch
            out[0, int(np.argmax(out[0]))] += 0.01 * np.abs(out[0]).max()
        return out

    monkeypatch.setattr(scheduler, "_to_host", altered)
    res = _run("jpeg-resnet-cifar.coef-closed")
    assert count["n"] > 3
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] \
        > res["checks"]["logit_gap"]["limit"]


def _broken_step(monkeypatch, fault):
    from repro_torch.launch import train

    real = train.make_step

    def make_step(model, optimizer, schedule, clip):
        step = real(model, optimizer, schedule, clip)

        def broken(params, opt_state, batch):
            if fault == "half_batch":
                half = len(batch["labels"]) // 2
                return step(params, opt_state,
                            {k: v[:half] for k, v in batch.items()})
            _, new_state, loss, gnorm = step(params, opt_state, batch)
            return params, new_state, loss, gnorm       # state unchanged

        return broken

    monkeypatch.setattr(train, "make_step", make_step)


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    _broken_step(monkeypatch, "unchanged")
    res = _run("jpeg-resnet-cifar.train-b1024")
    assert not res["correct"]
    c = res["checks"]["change_norm_gap"]
    assert c["value"] > c["limit"]


def test_half_of_the_batch_left_out(monkeypatch):
    _broken_step(monkeypatch, "half_batch")
    res = _run("jpeg-resnet-cifar.train-b1024")
    assert not res["correct"]
