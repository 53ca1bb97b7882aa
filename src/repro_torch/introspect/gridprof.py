"""Profile a warmed serving plan grid: per-cell predicted capacity.

``serve --profile-grid`` runs this sweep right after grid warmup, before
traffic: for every *warmed* (tier × bucket × kind) cell it produces a
predicted latency (roofline over the column's per-step counted costs) and
a measured wall (the cell's own captured executable, a CUDA graph on the
card, already captured, so the sweep adds **no** capture after warmup),
turned into per-cell capacities in requests/second.

Per (column, kind) the per-step attribution is computed once at the
largest warmed bucket (the *reference* cell, which also gets a per-step
measured profile from :meth:`GridCell.profile`); other buckets scale the
predicted cost linearly in the bucket size (exact for the FLOP term,
whose every product's batch dimension scales with the bucket; approximate
for the byte term, whose weight bytes do not) and measure their own
whole-cell wall directly.  The port's copy of the reference's
``introspect/gridprof.py``.
"""
from __future__ import annotations

from repro_torch.introspect.attribution import block_costs
from repro_torch.introspect.roofline import HardwareProfile, \
    resolve_profile

__all__ = ["profile_plan_grid"]


def profile_plan_grid(grid, *, hw: HardwareProfile | None = None,
                      iters: int = 3, warmup: int = 1) -> dict:
    """Sweep every warmed cell of a ``serving.grid.PlanGrid``.

    Returns ``{"hw_profile", "columns", "cells"}``: per (tier, kind) a
    reference-bucket per-block predicted-vs-measured table, and per cell
    ``{"cell", "tier", "kind", "bucket", "flops", "predicted_us",
    "measured_us", "predicted_req_s", "measured_req_s"}``.  Feed the
    ``cells`` rows to ``PlanGrid.annotate_costs`` /
    ``ServeMetrics.record_predicted_capacity`` to surface them on trace
    spans and the ``serve_predicted_capacity`` gauge family.
    """
    hw = resolve_profile() if hw is None else hw
    columns = []
    cells = []
    for col in grid.distinct:
        by_kind: dict[str, list] = {}
        for (kind, bucket), cell in sorted(col.cells.items(),
                                           key=lambda kv: kv[0][1]):
            by_kind.setdefault(kind, []).append(cell)
        for kind, kind_cells in by_kind.items():
            ref = kind_cells[-1]  # largest warmed bucket
            packed = kind == "bytes"
            blocks, _ = block_costs(
                col.compiled, (ref.bucket, *ref.item_shape),
                executor=col.executor, packed=packed, hw=hw,
                cross_check=False)
            ref_prof = ref.profile(iters=iters, warmup=warmup)
            measured_steps = {s["name"]: s["measured_us"]
                              for s in ref_prof["steps"]}
            for b in blocks:
                mu = measured_steps.get(b.name)
                if mu is not None:
                    b.measured_s = mu / 1e6
            pred_ref_us = sum(b.predicted_s for b in blocks) * 1e6
            flops_ref = sum(b.flops for b in blocks)
            columns.append({
                "tier": col.tier_name,
                "kind": kind,
                "ref_bucket": ref.bucket,
                "blocks": [b.to_json() for b in blocks],
            })
            for cell in kind_cells:
                scale = cell.bucket / ref.bucket
                pred_us = pred_ref_us * scale
                wall_us = (ref_prof["cell_wall_us"] if cell is ref
                           else cell.time_wall(iters=iters) * 1e6)
                cells.append({
                    "cell": cell.name,
                    "tier": col.tier_name,
                    "kind": kind,
                    "bucket": cell.bucket,
                    "flops": flops_ref * scale,
                    "predicted_us": pred_us,
                    "measured_us": wall_us,
                    "predicted_req_s": (cell.bucket / (pred_us / 1e6)
                                        if pred_us > 0 else 0.0),
                    "measured_req_s": (cell.bucket / (wall_us / 1e6)
                                       if wall_us > 0 else 0.0),
                })
    return {"hw_profile": hw.to_json(), "columns": columns, "cells": cells}
