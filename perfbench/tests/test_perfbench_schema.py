"""``BENCHMARK.json`` keeps to the benchmark's contract, and everything it
names is found by name."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    n = len(bench["workloads"])
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 or n < 24


def test_names_units_and_text(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    from perfbench.lib import spec

    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]


def test_each_layer_metric_moves_what_its_cells_report(bench):
    from perfbench.lib import spec

    for m in bench["per_layer"]:
        for name in m["workloads"]:
            cell = spec.cell(name, bench)
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_everything_named_is_there(bench):
    from perfbench.lib import spec

    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
    for w in bench["workloads"]:
        wl = spec.cell(w["name"], bench)["workload"]
        assert wl["config"] == w["config"]
        for kind, name in (("drivers", wl["driver"]),
                           ("traffic", wl["traffic"]["kind"])):
            assert (ROOT / "perfbench" / kind / f"{name}.py").is_file()
    for m in bench["per_layer"]:
        mod = spec.load_module("metrics", m["name"])
        assert callable(mod.read)
