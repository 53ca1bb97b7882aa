"""Introspection report schema: validation and text rendering.

The JSON report ``introspect.predicted_vs_measured`` produces (and
``launch.inspect --report-out`` writes) is the reference package's
versioned schema (this module is the port's own copy of its
``introspect/report.py``): :func:`validate_report` is the one checker the
CLI, the tests and ``chip_smoke.py`` call, as
``serving.trace.validate_trace`` is for traces.
"""
from __future__ import annotations

import math

from repro_torch.introspect.attribution import REPORT_KIND, \
    REPORT_VERSION

__all__ = [
    "validate_report",
    "worst_ratio",
    "render_text",
]

_TERMS = ("compute", "memory", "collective")

_BLOCK_NUMERIC = ("flops", "bytes", "collective_bytes", "transcendentals",
                  "predicted_us")
_BLOCK_KEYS = _BLOCK_NUMERIC + (
    "name", "kind", "executor", "bands_in", "bands_out", "layer_bands",
    "energy_kept", "vmem_bytes", "measured_us", "ratio", "term", "warnings")
_TOTAL_KEYS = ("flops", "bytes", "predicted_us", "measured_us",
               "unprofiled_wall_us", "reconciliation", "logits_match")


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def validate_report(obj: dict) -> dict:
    """Validate an introspection report; raise ``ValueError`` with every
    violation listed, else return a summary dict.

    Checks: kind/version header; non-empty ``blocks`` with all schema
    keys, non-negative static costs, strictly positive predicted and
    (when present) measured walls, a known roofline ``term``, and a
    consistent ``ratio``; ``totals`` with positive walls and a
    ``reconciliation`` that matches the per-block measured sum against
    the unprofiled wall; a ``meta.hw_profile`` with positive peaks.
    """
    problems: list[str] = []
    if not isinstance(obj, dict):
        raise ValueError("report is not an object")
    if obj.get("kind") != REPORT_KIND:
        problems.append(f"kind {obj.get('kind')!r} != {REPORT_KIND!r}")
    if obj.get("version") != REPORT_VERSION:
        problems.append(f"unsupported version {obj.get('version')!r}")

    meta = obj.get("meta")
    if not isinstance(meta, dict):
        problems.append("meta missing")
    else:
        hw = meta.get("hw_profile")
        if not isinstance(hw, dict) or not all(
                _num(hw.get(k)) and hw.get(k) > 0
                for k in ("peak_flops", "hbm_bw", "link_bw")):
            problems.append("meta.hw_profile missing or non-positive peaks")

    blocks = obj.get("blocks")
    measured_sum = 0.0
    any_measured = False
    if not isinstance(blocks, list) or not blocks:
        problems.append("blocks missing or empty")
        blocks = []
    for i, b in enumerate(blocks):
        if not isinstance(b, dict):
            problems.append(f"block {i}: not an object")
            continue
        tag = f"block {i} ({b.get('name')})"
        for key in _BLOCK_KEYS:
            if key not in b:
                problems.append(f"{tag}: missing {key}")
        for key in _BLOCK_NUMERIC:
            v = b.get(key)
            if key in b and (not _num(v) or v < 0):
                problems.append(f"{tag}: {key} not a finite non-negative "
                                f"number ({v!r})")
        if _num(b.get("predicted_us")) and b["predicted_us"] <= 0:
            problems.append(f"{tag}: predicted_us must be > 0")
        mu = b.get("measured_us")
        if mu is not None:
            if not _num(mu) or mu <= 0:
                problems.append(f"{tag}: measured_us must be > 0 ({mu!r})")
            else:
                any_measured = True
                measured_sum += mu
                r = b.get("ratio")
                pu = b.get("predicted_us")
                if _num(pu) and pu > 0:
                    want = mu / pu
                    if not _num(r) or abs(r - want) > 1e-6 * max(1.0, want):
                        problems.append(
                            f"{tag}: ratio {r!r} != measured/predicted "
                            f"({want:.6g})")
        if b.get("term") not in _TERMS:
            problems.append(f"{tag}: term {b.get('term')!r} not in {_TERMS}")

    totals = obj.get("totals")
    if not isinstance(totals, dict):
        problems.append("totals missing")
        totals = {}
    for key in _TOTAL_KEYS:
        if key not in totals:
            problems.append(f"totals: missing {key}")
    if not isinstance(totals.get("logits_match"), bool):
        problems.append("totals.logits_match is not a bool")
    wall = totals.get("unprofiled_wall_us")
    if _num(wall) and wall > 0 and any_measured:
        want = measured_sum / wall
        rec = totals.get("reconciliation")
        if not _num(rec) or abs(rec - want) > 1e-6 * max(1.0, want):
            problems.append(
                f"totals.reconciliation {rec!r} != per-block measured sum "
                f"/ unprofiled wall ({want:.6g})")
    elif "unprofiled_wall_us" in totals and not (_num(wall) and wall > 0):
        problems.append(
            f"totals.unprofiled_wall_us must be > 0 ({wall!r})")

    if problems:
        raise ValueError("invalid introspect report:\n  "
                         + "\n  ".join(problems[:20]))
    return {
        "blocks": len(blocks),
        "predicted_us": totals.get("predicted_us"),
        "measured_us": totals.get("measured_us"),
        "unprofiled_wall_us": totals.get("unprofiled_wall_us"),
        "reconciliation": totals.get("reconciliation"),
        "worst_ratio": worst_ratio(obj),
        "logits_match": totals.get("logits_match"),
    }


def worst_ratio(report: dict, *, min_frac: float = 0.01) -> float | None:
    """The worst per-block predicted-vs-measured disagreement: max over
    blocks of ``max(ratio, 1/ratio)`` — 1.0 means the roofline model
    nailed every block, in either direction.

    Blocks contributing under ``min_frac`` of the total measured wall
    are skipped: a microsecond-scale head step is pure dispatch
    overhead, and its ratio says nothing about the cost model.
    """
    total = 0.0
    for b in report.get("blocks", []):
        mu = b.get("measured_us")
        if isinstance(mu, (int, float)):
            total += mu
    worst = None
    for b in report.get("blocks", []):
        r = b.get("ratio")
        mu = b.get("measured_us")
        if isinstance(mu, (int, float)) and mu < min_frac * total:
            continue
        if isinstance(r, (int, float)) and r > 0:
            w = max(r, 1.0 / r)
            worst = w if worst is None else max(worst, w)
    return worst


def _fmt_flops(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if v >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def render_text(report: dict) -> str:
    """Human-readable table of the per-block predicted-vs-measured rows."""
    meta = report.get("meta", {})
    hw = meta.get("hw_profile", {})
    lines = [
        f"plan introspection — backend={meta.get('backend')} "
        f"hw={hw.get('name')} executor={meta.get('executor') or 'auto'} "
        f"input={tuple(meta.get('input_shape', ()))}",
        f"{'step':<10} {'kind':<7} {'exec':<10} {'bands':>6} "
        f"{'energy':>7} {'flops':>9} {'bytes':>10} {'pred us':>9} "
        f"{'meas us':>9} {'ratio':>6}  term",
    ]
    for b in report.get("blocks", []):
        energy = b.get("energy_kept")
        mu = b.get("measured_us")
        ratio = b.get("ratio")
        lines.append(
            f"{b['name']:<10} {b['kind']:<7} {b['executor']:<10} "
            f"{b['bands_out']:>6} "
            f"{'' if energy is None else f'{energy:.3f}':>7} "
            f"{_fmt_flops(b['flops']):>9} {int(b['bytes']):>10} "
            f"{b['predicted_us']:>9.1f} "
            f"{'' if mu is None else f'{mu:.1f}':>9} "
            f"{'' if ratio is None else f'{ratio:.2f}':>6}  {b['term']}")
    t = report.get("totals", {})
    lines.append(
        f"{'total':<10} {'':<7} {'':<10} {'':>6} {'':>7} "
        f"{_fmt_flops(t.get('flops', 0.0)):>9} "
        f"{int(t.get('bytes', 0)):>10} {t.get('predicted_us', 0.0):>9.1f} "
        f"{t.get('measured_us', 0.0):>9.1f}")
    lines.append(
        f"unprofiled wall {t.get('unprofiled_wall_us', 0.0):.1f}us — "
        f"profiled walls sum to {100 * t.get('reconciliation', 0.0):.1f}% "
        f"of it; logits bit-identical under profiling: "
        f"{t.get('logits_match')}")
    wr = worst_ratio(report)
    if wr is not None:
        lines.append(f"worst per-block |predicted vs measured| ratio: "
                     f"{wr:.2f}x")
    return "\n".join(lines)
