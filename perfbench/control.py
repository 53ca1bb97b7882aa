"""The readings a cell's correctness limits are set from, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 3] [--no-program]

For each seed, in one process: the program's reading (the cell run once
with a short window, as ``run.py`` runs it: the lower reading), then the
control's (the plain reference in TF32 in the program's place, held
against the reference in float32: the upper reading).  A training cell
also reads its planted faults: half of each batch left out, the mean taken
over the rest (a step that returns its state unchanged reads 1 by the
change's measure and needs no run).  One JSON line a reading.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]


def serve_control(cell: dict, seed: int, device) -> dict:
    """The logit gap of the TF32 reference against the float32 one on the
    cell's own images and weights."""
    from perfbench.drivers import serve_qos
    from perfbench.lib import weights

    cfg, wl = cell["config_data"], cell["workload"]
    bands = int(wl["serve"]["bands"])
    params, state = weights.resnet(cfg, seed, device)
    _, ref_in = serve_qos._payloads(cfg, wl["traffic"], seed, device)
    exact = serve_qos.reference_logits(params, state, cfg, ref_in, bands,
                                       device)
    low = serve_qos.reference_logits(params, state, cfg, ref_in, bands,
                                     device, precision="tf32")
    return {"logit_gap": float(serve_qos.logit_gaps(low, exact).max())}


def train_readings(cell: dict, seed: int, device, *, precision="fp32",
                   half_batch=False) -> dict:
    """The training checks of the reference put in the program's place:
    in ``precision``, or on the first half of each batch."""
    import torch

    from perfbench.drivers.train_step import CHECKED_STEPS
    from perfbench.lib import spec, weights
    from perfbench.reference import jpeg
    from perfbench.reference import train as reftrain

    cfg, wl = cell["config_data"], cell["workload"]
    hp = wl["train"]
    params, state = weights.resnet(cfg, seed, device)
    bundle = {"params": params, "bn_state": state}
    gen = spec.load_module("traffic", wl["traffic"]["kind"])
    batches = gen.batches(cfg, wl["traffic"], seed, device)[:CHECKED_STEPS]
    q = torch.as_tensor(jpeg.canonical_table(cfg["quality"]),
                        dtype=torch.float32, device=device)
    data = [(b["coefficients"] * q, b["labels"]) for b in batches]
    kw = dict(widths=cfg["widths"], blocks_per_stage=cfg["blocks_per_stage"],
              lr=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
              weight_decay=hp["weight_decay"], clip=hp["clip"])
    ref = reftrain.steps(bundle, data, **kw)
    if half_batch:
        data = [(c[: len(c) // 2], lab[: len(lab) // 2]) for c, lab in data]
    got = reftrain.steps(bundle, data, precision=precision, **kw)
    start = dict(reftrain.leaves(bundle))
    return reftrain.checks(
        (got["losses"][0], ref["losses"][0]), (got["grad1"], ref["grad1"]),
        ({p: got["params"][p] - start[p] for p in start},
         {p: ref["params"][p] - start[p] for p in start}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from perfbench import run
    from perfbench.lib import spec

    spec.set_cache_env()
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    training = cell["workload"]["driver"] == "train_step"
    for seed in args.seeds:
        if not args.no_program:
            res = run.run_cell(cell, seed, args.seconds, False, dev,
                               t_start=time.monotonic())
            print(json.dumps({"seed": seed, "reading": "program",
                              "correct": res["correct"],
                              "checks": res["checks"],
                              "metrics": res["metrics"]}), flush=True)
        if training:
            readings = {"control": train_readings(cell, seed, dev,
                                                  precision="tf32"),
                        "half_batch": train_readings(cell, seed, dev,
                                                     half_batch=True)}
        else:
            readings = {"control": serve_control(cell, seed, dev)}
        for name, r in readings.items():
            print(json.dumps({"seed": seed, "reading": name, **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
