"""Plan introspection: where each microsecond and each FLOP of a compiled
plan goes, and whether the cost model agrees.

Built on ``core.plan.compiled_steps`` (the compiled schedule as an
explicit step list, the same closures the production walk folds):

* **counted attribution** (:mod:`~repro_torch.introspect.attribution`,
  :mod:`~repro_torch.introspect.opcount`): each step run once under a
  dispatch-mode counter, the hand-written kernels adding their analytic
  work, joined with band budgets, retained energy, lowering and shared
  memory into a :class:`BlockCost` table, cross-checked against one
  counted whole walk;
* **roofline prediction** (:mod:`~repro_torch.introspect.roofline`):
  :class:`HardwareProfile` peaks (``h100`` among them; ``JPEG_HW_PROFILE``
  or a CLI flag override) turn each step's FLOPs and bytes into a
  predicted latency and its dominant term;
* **measured attribution**: ``core.plan.StepProfile`` (per-step walls,
  bit-identical logits) and ``serving.grid.GridCell.profile`` /
  :func:`profile_plan_grid` hold prediction against the card:
  :func:`predicted_vs_measured` is the report, ``launch.inspect`` the
  CLI, :func:`validate_report` its schema check.

The reference package's ``__all__``, ported without JAX.
"""
from repro_torch.core.plan import StepProfile, compiled_steps
from repro_torch.introspect.attribution import (BlockCost, block_costs,
                                                predicted_vs_measured)
from repro_torch.introspect.gridprof import profile_plan_grid
from repro_torch.introspect.report import (render_text, validate_report,
                                           worst_ratio)
from repro_torch.introspect.roofline import (PROFILES, HardwareProfile,
                                             detect_backend, resolve_profile,
                                             roofline)

__all__ = [
    "BlockCost",
    "HardwareProfile",
    "PROFILES",
    "StepProfile",
    "block_costs",
    "compiled_steps",
    "detect_backend",
    "predicted_vs_measured",
    "profile_plan_grid",
    "render_text",
    "resolve_profile",
    "roofline",
    "validate_report",
    "worst_ratio",
]
