"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its workload file names the
driver (``perfbench/drivers/<driver>.py``) that sets the program up from
the seed, runs the traffic (``perfbench/traffic/<kind>.py``) for
``--seconds``, and checks the answers against the plain reference
(``perfbench/reference/``).  With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the result holds its per-layer metrics, each read by
``perfbench/metrics/<metric>.py``, with the device's busy time and a
breakdown.  The numbers that decide ``correct`` are printed beside their
limits, last, on standard error and under ``checks``.

Exits 2 without a result when the card, or as many cards as the cell asks
for, is missing, and 3 when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: top-level module names no run may load: JAX, its relatives, and the
#: JAX package this port was made from (``repro``; ``repro_torch`` is the
#: port, a different top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class GcPauses:
    """The garbage collector's full passes over the run, on the host's
    clock: a host-bound cell's stalls show here."""

    def __init__(self):
        self.n, self.total_s, self.max_s, self._t = 0, 0.0, 0.0, None

    def __call__(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            d = time.perf_counter() - self._t
            self.n, self.total_s = self.n + 1, self.total_s + d
            self.max_s = max(self.max_s, d)

    def summary(self) -> dict:
        return {"full_passes": self.n, "total_s": self.total_s,
                "max_s": self.max_s}


class Run:
    """One run's parameters and its set-up clock, handed to the driver."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.setup_s: float | None = None
        self.clock = time.monotonic

    def setup_done(self) -> None:
        """Set-up ends: the next thing the driver does is timed."""
        self.setup_s = self.clock() - self.t_start


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None) -> dict:
    """Run ``cell`` once on ``device``; returns the result object."""
    import torch

    from perfbench.lib import spec

    ctx = Run(cell, seed, seconds, trace, device,
              T_START if t_start is None else t_start)
    driver = spec.load_module("drivers", cell["workload"]["driver"])
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        out = driver.run(ctx)
    finally:
        gc.callbacks.remove(pauses)
    rec = out["record"]
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = spec.load_module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        tr = rec["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown(out["host_spans"])
    if out.get("setup_parts"):
        result["setup_parts"] = out["setup_parts"]
    result["gc_pauses"] = pauses.summary()
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in out["checks"].items()}
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.lib import spec

    cell = spec.cell(args.workload)
    spec.set_cache_env()
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
