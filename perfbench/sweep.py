"""Find the highest rate a serving cell's open-loop traffic sustains.

    python3 perfbench/sweep.py --workload <cell> --seeds 1 2 --seconds 60 \\
        --rates 500 1000 2000

For each seed the cell is set up once, then each rate is offered for
``--seconds``; one JSON line a seed and rate says what came back: answers a
second, the requests still unanswered when the window closed (the
backlog), the median latency of the window's first and last thirds (a
growing queue raises the second), the 95th percentile, and the busy share
of the server's two threads over the window (the ingest thread's
``ingest/ingest-decode`` spans, the worker's ``device/device-dispatch``
spans).  The cell's workload file records the rate chosen from this; the
benchmark's own runs never sweep.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]


def busy_share(spans: list, track: str, name: str, t0: float,
               t1: float) -> float:
    """The share of ``[t0, t1]`` covered by the ``track/name`` spans (one
    thread's, so they do not overlap), clipped to the window."""
    got = sum(max(0.0, min(b, t1) - max(a, t0))
              for tk, nm, a, b in spans if tk == track and nm == name)
    return got / (t1 - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    import time

    import torch

    from perfbench.drivers import serve_qos
    from perfbench.lib import spec
    from repro_torch import serving

    spec.set_cache_env()
    cell = spec.cell(args.workload)
    traffic = dict(cell["workload"]["traffic"])
    gen = spec.load_module("traffic", traffic["kind"])
    for seed in args.seeds:
        t_anchor = []

        def clock():
            t = time.monotonic()
            if not t_anchor:
                t_anchor.append(t)
            return t

        tracer = serving.Tracer(capacity=1 << 23, clock=clock)
        server = serve_qos.Server(cell, seed, torch.device("cuda", 0),
                                  tracer)
        try:
            for rate in args.rates:
                rec = gen.run(server.send, dict(traffic, rate_per_s=rate),
                              seed, args.seconds)
                t0, t1 = rec["t0"], rec["t1"]
                e2e = serve_qos.summarize(rec, args.seconds, gen.GRACE_S)
                thirds = [[d - u for u, d in zip(rec["due"], rec["done"])
                           if d is not None
                           and t0 + i * (t1 - t0) / 3 <= u
                           < t0 + (i + 1) * (t1 - t0) / 3] for i in (0, 2)]
                spans = [(tk, nm, t_anchor[0] + ts, t_anchor[0] + ts + d)
                         for ph, tk, _tid, nm, ts, d, _ in tracer.events()
                         if ph == "X"]
                print(json.dumps({
                    "seed": seed, "rate_per_s": rate,
                    "sent": len(rec["due"]),
                    "answered_per_s": e2e["images_per_s"],
                    "backlog_at_close": sum(1 for d in rec["done"]
                                            if d is None or d > t1),
                    "p50_ms_first_third": float(np.median(thirds[0])) * 1e3,
                    "p50_ms_last_third": float(np.median(thirds[1])) * 1e3,
                    "latency_p95_ms": e2e["latency_p95_ms"],
                    "ingest_busy": busy_share(spans, "ingest",
                                              "ingest-decode", t0, t1),
                    "dispatch_busy": busy_share(spans, "device",
                                                "device-dispatch", t0, t1),
                    "tracer_dropped": tracer.dropped}), flush=True)
        finally:
            server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
