"""Plan introspection CLI: per-step predicted-vs-measured attribution.

Restores (or builds, convert-once, through the serving entry point's own
``serve.prepare_plan``) the compiled plan of ``--plan-dir``, runs
:func:`repro_torch.introspect.predicted_vs_measured` on one deterministic
coefficient batch (``data.pipeline.jpeg_iterator``), prints the per-step
table, validates the report (``introspect.validate_report``, the
reference's schema) and writes it to ``--report-out``.

    PYTHONPATH=src python -m repro_torch.launch.inspect --arch jpeg-resnet \\
        --plan-dir /tmp/plan --batch 8 --executor auto --hw-profile h100 \\
        --report-out report.json
    PYTHONPATH=src python -m repro_torch.launch.inspect --arch jpeg-resnet \\
        --reduced --device cpu --batch 4 --report-out report.json

Runs on the CUDA device unless ``--device cpu`` is given; without CUDA it
raises.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch import introspect, resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import dispatch as dispatchlib
from repro_torch.data.pipeline import jpeg_iterator
from repro_torch.launch import serve as servelib

__all__ = ["main", "resolve_executor", "run_inspect"]


def resolve_executor(spec: str | None, device: torch.device) -> str | None:
    """``--executor`` → ``apply_compiled``'s ``executor``.  ``auto``
    mirrors the serving scheduler: the compiled schedule's own paths (the
    kernels) on a CUDA device, the packed-GEMM lowering on the CPU."""
    tok = (spec or "auto").strip().lower()
    if tok == "auto":
        return None if device.type == "cuda" else "gemm"
    if tok in ("plan", "dispatch", "none"):
        return None
    if tok == "gemm":
        return "gemm"
    raise SystemExit(f"unknown --executor {spec!r} "
                     "(expected auto | gemm | plan)")


def run_inspect(args) -> dict:
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    with dispatchlib.override(**servelib._dispatch_changes(args)):
        plan, compiled, plan_info = servelib.prepare_plan(args, cfg, device)
    it = jpeg_iterator(args.seed, args.batch, cfg.image_size,
                       cfg.in_channels, cfg.num_classes, device=device)
    coef = next(it)["coefficients"]
    executor = resolve_executor(args.executor, device)
    hw = introspect.resolve_profile(args.hw_profile)
    print(f"[inspect] plan {plan_info['dir']} "
          f"({'built' if plan_info['built'] else 'restored'}), "
          f"{len(plan_info.get('fused_blocks', []))} fused blocks, "
          f"executor={executor or 'plan'}, hw={hw.name}", flush=True)
    report = introspect.predicted_vs_measured(
        compiled, coef, executor=executor, hw=hw, iters=args.iters,
        warmup=args.warmup)
    report["meta"]["plan"] = plan_info
    print(introspect.render_text(report), flush=True)
    summary = introspect.validate_report(report)  # raises on violations
    if args.report_out:
        with open(args.report_out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[inspect] report written to {args.report_out} "
              f"({summary['blocks']} blocks, reconciliation "
              f"{summary['reconciliation']:.3f})", flush=True)
    return report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="per-step cost attribution for a compiled plan")
    ap.add_argument("--arch", default="jpeg-resnet", choices=["jpeg-resnet"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5,
                    help="profiled/unprofiled timing iterations (medians)")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-dir", default=None,
                    help="plan checkpoint directory (restored when "
                         "present, built and saved once otherwise)")
    ap.add_argument("--dispatch", default=None,
                    help="operator path when the plan must be built "
                         "(reference | cuda (or pallas) | factored)")
    ap.add_argument("--bands", type=int, default=None,
                    help="band truncation when the plan must be built")
    ap.add_argument("--autotune-bands", action="store_true")
    ap.add_argument("--executor", default="auto",
                    help="schedule executor: auto (the kernels on the "
                         "card, gemm on the CPU) | gemm | plan")
    ap.add_argument("--hw-profile", default=None,
                    help="roofline hardware profile: registry name "
                         f"({', '.join(sorted(introspect.PROFILES))}), "
                         "'peak_flops,hbm_bw,link_bw' triple, or unset "
                         "for $JPEG_HW_PROFILE / the detected device")
    ap.add_argument("--report-out", default=None,
                    help="write the validated JSON report here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    # prepare_plan reads these off the serve namespace: the compiled
    # schedule (attribution needs its step list) and coefficient ingest
    args.compiled = True
    args.ingest = "coefficients"
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    try:
        return run_inspect(args)
    except ValueError as e:
        print(f"[inspect] INVALID: {e}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
