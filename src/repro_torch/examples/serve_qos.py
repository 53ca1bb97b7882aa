"""Band-elastic QoS serving walkthrough (``repro_torch.serving``).

Builds the reduced jpeg-resnet's convert-once plan, compiles it into a
ladder of band tiers, and serves a saturating burst of single-image
requests through the async scheduler, watching the QoS policy degrade
bands as the queue builds and recover as it drains.  The port of the
reference's ``examples/serve_qos.py``:

    python -m repro_torch.examples.serve_qos [--device cpu]
    python -m repro_torch.examples.serve_qos --ingest bytes --requests 64

Everything here is the code path ``launch/serve.py --qos`` drives; this
module narrates the report.
"""
from __future__ import annotations

import argparse

from repro_torch.examples import add_device, run
from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=48,
                    help="single-image requests, submitted as one burst")
    ap.add_argument("--tiers", default=None,
                    help="ladder caps, e.g. 'auto,48,32,24' (default)")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--ingest", default="coefficients",
                    choices=("coefficients", "bytes"))
    ap.add_argument("--plan-dir", default=None)
    ap.add_argument("--chaos", action="store_true",
                    help="fault-drill the run (needs --ingest bytes): "
                         "corrupt 20%% of requests, kill an ingest "
                         "worker, fail two executor dispatches")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable Chrome trace of the run")
    ap.add_argument("--metrics-out", default=None,
                    help="periodically snapshot Prometheus-style metrics")
    add_device(ap)
    args = ap.parse_args(argv)
    flags = ["--arch", "jpeg-resnet", "--reduced", "--qos", "--batch",
             str(args.batch), "--requests", str(args.requests),
             "--max-new", "1", "--seed", "0", "--ingest", args.ingest]
    for flag, value in (("--tiers", args.tiers),
                        ("--deadline-ms", args.deadline_ms),
                        ("--plan-dir", args.plan_dir),
                        ("--trace-out", args.trace_out),
                        ("--metrics-out", args.metrics_out),
                        ("--device", args.device)):
        if value is not None:
            flags += [flag, str(value)]
    if args.chaos:
        flags.append("--chaos")
    out = serve.serve_jpeg_resnet(serve.parse_args(flags))
    qos = out["qos"]
    lat = out["latency_ms"]
    lines = [f"served {out['images']} requests at "
             f"{out['images_per_s']:.1f} img/s "
             f"(p50 {lat['p50_ms']:.0f}ms / p95 {lat['p95_ms']:.0f}ms / "
             f"p99 {lat['p99_ms']:.0f}ms), {out['rejected']} rejected"]
    for t in qos["tiers"]:
        stats = qos["per_tier"].get(t["name"])
        if stats:
            lines.append(f"  tier {t['name']:<4} (bands {t['bands']}): "
                         f"{stats['images']} images in {stats['batches']} "
                         f"batches at {stats['images_per_s']:.1f} img/s")
    for sw in qos["tier_switches"]:
        lines.append(f"  switch @batch {sw['batch']}: {sw['from']} -> "
                     f"{sw['to']} ({sw['reason']})")
    lines.append(f"  top-tier top-1 agreement vs plan walk: "
                 f"{qos['top1_agree_top_tier']}")
    health = out["health"]
    lines.append(f"  health: breaker {health['breaker']['state']}, "
                 f"failures {qos['failures_total'] or '{}'}, "
                 f"pool restarts {qos['pool_restarts']}")
    for ev in qos["breaker_timeline"]:
        lines.append(f"  breaker @{ev['seq']}: {ev['from']} -> {ev['to']} "
                     f"({ev['reason']})")
    if "trace" in out:
        tr = out["trace"]
        lines.append(f"  trace: {tr['events']} events -> {tr['path']} "
                     f"({tr['dropped']} dropped of {tr['capacity']} "
                     "capacity); open in https://ui.perfetto.dev")
    healthy_total, healthy = args.requests, out["completed"]
    if "chaos" in out:
        ch = out["chaos"]
        healthy_total, healthy = ch["healthy_total"], ch["healthy_completed"]
        lines.append(f"  chaos: {ch['corrupted']} corrupted "
                     f"({ch['corrupt_modes']}), worker kill pid "
                     f"{ch['killed_worker_pid']}, failed by stage "
                     f"{ch['failed_by_stage']}, healthy "
                     f"{healthy}/{healthy_total} completed")
    print("\n" + "\n".join(lines), flush=True)
    return {"device": out["device"], "images": out["images"],
            "completed": out["completed"], "rejected": out["rejected"],
            "images_per_s": out["images_per_s"], "latency_ms": lat,
            "tier_switches": qos["tier_switches"],
            "breaker": health["breaker"]["state"],
            "healthy_completed": healthy, "healthy_total": healthy_total,
            # the kernels' launches in the grid's CUDA graph replays, which
            # the wrappers' counters do not see
            "graph_launches": qos["graph_launches"],
            "narration": lines, "ok": healthy == healthy_total}


if __name__ == "__main__":
    run(main)
