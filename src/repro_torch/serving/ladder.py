"""Multi-tier compiled-plan ladder: one plan, several band budgets.

A *tier* is the serving plan with every layer's band assignment capped at
a budget (``min(layer_bands, cap)``), compiled into its own schedule.  As
in the reference package, truncating an exploded operator to ``b`` bands
is a prefix slice of its Ξ (``explosion_basis`` truncates the basis by
slicing), and the folded batch-norm scale and shift commute with the
slice, so a tier derives from the base plan's operators without
re-exploding them and is bit-identical to building and compiling a plan
at the capped budget with each layer on the path the base plan chose (a
factored layer stays factored where its capped Ξ would fit the
materialise limit).

One difference from the reference, because the port's kernels see the
operator as it is stored: a band prefix of Ξ ``(ndy, ndx, Cin, b, Cout,
b)`` is not contiguous, and the kernels take contiguous operands
(``kernels/_build.py``, ``check_device``); so each tier keeps its own
contiguous copy of every materialised operator the cap shrinks.
:meth:`PlanLadder.device_bytes` reports what the ladder holds against one
plan.  An operator kept factored (no materialised Ξ) only lowers its
``bands``, as in the reference: the factored apply truncates at run time,
and its kernel is shared by every tier.

Tiers whose capped assignment equals an earlier tier's share that tier's
``CompiledPlan``.  :func:`save_ladder` stores the base plan
(``core.plan.save_plan``) and a small manifest through the checkpoint
manager in the reference's ladder format; :func:`load_ladder` restores the
plan and re-derives the tiers (reading a manifest either package wrote),
and rejects a manifest whose tiers disagree with the plan.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch

from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import plan as planlib

__all__ = ["DEFAULT_CAPS", "PlanTier", "PlanLadder", "cap_operator",
           "cap_plan", "build_ladder", "save_ladder", "load_ladder"]

#: default band budgets, best quality first: ``None`` is the plan's own
#: assignment, an int caps every layer at that budget
DEFAULT_CAPS = (None, 48, 32, 24)

#: the reference's fused-block VMEM budget, written into the manifest so
#: that its loader reads the port's ladders; unused here
VMEM_BUDGET = 12 << 20

_LADDER_SUBDIR = "ladder"
_LADDER_FORMAT = 1


class PlanTier(NamedTuple):
    """One rung: the capped plan and its compiled schedule.

    ``shared_with`` is the index of the earlier tier whose ``CompiledPlan``
    this tier reuses (its cap changed nothing), else ``None``.
    """

    name: str
    cap: int | None
    bands: dict[str, int]
    plan: planlib.InferencePlan
    compiled: planlib.CompiledPlan
    shared_with: int | None = None


class PlanLadder(NamedTuple):
    """An ordered tier stack, index 0 = best quality (widest bands).

    ``buckets`` records the batch capture buckets the ladder was prepared
    to serve (``serving.grid.PlanGrid`` defaults to them; ``None`` derives
    the schedule from the batch size).  ``vmem_budget`` is the reference's
    TPU budget, kept for the manifest.
    """

    tiers: tuple[PlanTier, ...]
    base: planlib.InferencePlan
    caps: tuple[int | None, ...]
    image_size: int | None
    vmem_budget: int
    buckets: tuple[int, ...] | None = None

    @property
    def top(self) -> PlanTier:
        return self.tiers[0]

    def __len__(self) -> int:
        return len(self.tiers)

    def device_bytes(self, tiers=None) -> int:
        """Bytes of the distinct tensors the tiers (default all) hold:
        operators, packed buffers, head; a tensor shared between tiers
        counts once."""
        seen: dict[int, int] = {}

        def walk(obj):
            if isinstance(obj, torch.Tensor):
                seen[obj.untyped_storage().data_ptr()] = \
                    obj.untyped_storage().nbytes()
            elif isinstance(obj, dict):
                for v in obj.values():
                    walk(v)
            elif isinstance(obj, tuple):  # NamedTuples included
                for v in obj:
                    walk(v)

        for t in (self.tiers if tiers is None else tiers):
            walk(t.plan.operators)
            walk((t.plan.head_w, t.plan.head_b))
            walk((t.compiled.stem, t.compiled.blocks))
        return sum(seen.values())


def _tier_name(cap: int | None) -> str:
    return "top" if cap is None else f"b{cap}"


def cap_operator(op: dispatchlib.ConvOperator, cap: int
                 ) -> dispatchlib.ConvOperator:
    """Cap one operator at ``cap`` bands.

    A materialised Ξ is sliced to its band prefix and copied contiguous
    (bit-exact against exploding at the capped count); a factored operator
    just lowers its ``bands`` field — its apply path truncates at run
    time — and stays factored, as in the reference.
    """
    b = min(op.bands, cap)
    if b == op.bands:
        return op
    xi = op.xi
    if xi is not None:
        xi = xi[:, :, :, :b, :, :b].contiguous()
    return op._replace(xi=xi, bands=b)


def cap_plan(plan: planlib.InferencePlan, cap: int | None
             ) -> planlib.InferencePlan:
    """The plan at band budget ``cap`` (``None`` → the plan itself);
    operators the cap does not touch are shared."""
    if cap is None or cap >= max(plan.bands.values()):
        return plan
    if not 8 <= cap <= dctlib.NFREQ or cap % 8:
        raise ValueError(
            f"tier cap must be a multiple of 8 in [8, {dctlib.NFREQ}], "
            f"got {cap}")
    operators: dict[str, Any] = {}
    for name, entry in plan.operators.items():
        if isinstance(entry, dict):
            operators[name] = {slot: cap_operator(op, cap)
                               for slot, op in entry.items()}
        else:
            operators[name] = cap_operator(entry, cap)
    bands = {k: min(v, cap) for k, v in plan.bands.items()}
    provenance = dict(plan.provenance or {}, tier_cap=cap)
    return plan._replace(operators=operators, bands=bands,
                         provenance=provenance)


def _validate_caps(caps) -> tuple[int | None, ...]:
    caps = tuple(caps)
    if not caps:
        raise ValueError("ladder needs at least one tier")
    if caps[0] is not None and any(c is None for c in caps):
        raise ValueError("the uncapped (None) tier must come first")
    numeric = [c for c in caps if c is not None]
    if numeric != sorted(numeric, reverse=True) or len(set(caps)) != len(caps):
        raise ValueError(
            f"tier caps must be strictly decreasing (best first): {caps}")
    return caps


def build_ladder(plan: planlib.InferencePlan, *, caps=DEFAULT_CAPS,
                 image_size: int | None = None,
                 vmem_budget: int = VMEM_BUDGET,
                 buckets=None) -> PlanLadder:
    """Compile ``plan`` into a tier ladder at the given band budgets, best
    first; a cap that changes nothing shares the previous tier's
    schedule.  ``buckets`` pins the grid's batch capture buckets."""
    caps = _validate_caps(caps)
    if buckets is not None:
        from repro_torch.serving.grid import validate_buckets

        buckets = validate_buckets(buckets)
    tiers: list[PlanTier] = []
    by_bands: dict[tuple, int] = {}
    for cap in caps:
        capped = cap_plan(plan, cap)
        key = tuple(sorted(capped.bands.items()))
        shared = by_bands.get(key)
        if shared is not None:
            prev = tiers[shared]
            tiers.append(PlanTier(_tier_name(cap), cap, dict(capped.bands),
                                  prev.plan, prev.compiled, shared))
            continue
        by_bands[key] = len(tiers)
        tiers.append(PlanTier(_tier_name(cap), cap, dict(capped.bands),
                              capped, planlib.compile_plan(capped)))
    return PlanLadder(tuple(tiers), plan, caps, image_size, vmem_budget,
                      buckets)


# --------------------------------------------------------------------------
# Serialization: base plan + manifest; tiers re-derive bit-exactly
# --------------------------------------------------------------------------


def save_ladder(ladder: PlanLadder, directory: str, *,
                save_base: bool = True) -> None:
    """Persist a ladder under ``directory`` (a plan directory): the base
    plan, unless ``save_base=False`` because the caller saved it, and the
    manifest in ``directory/ladder``."""
    from repro_torch.checkpoint import CheckpointManager

    if save_base:
        planlib.save_plan(ladder.base, directory)
    extra = {
        "kind": "jpeg_plan_ladder",
        "format": _LADDER_FORMAT,
        "caps": list(ladder.caps),
        "image_size": ladder.image_size,
        "vmem_budget": int(ladder.vmem_budget),
        "buckets": (None if ladder.buckets is None
                    else [int(b) for b in ladder.buckets]),
        "tiers": [{"name": t.name, "cap": t.cap, "bands": t.bands,
                   "shared_with": t.shared_with} for t in ladder.tiers],
    }
    CheckpointManager(os.path.join(directory, _LADDER_SUBDIR)).save(
        0, {}, extra=extra)


def load_ladder(directory: str, *,
                plan: planlib.InferencePlan | None = None,
                device: str | torch.device | None = None) -> PlanLadder:
    """Restore a ladder that :func:`save_ladder` or the reference package
    saved: the base plan from ``directory`` (onto ``device``, default
    CUDA) unless ``plan`` is given, the tiers re-derived from it.  A
    manifest whose tiers' band assignments disagree with the plan (saved
    against another plan) raises ``ValueError``."""
    from repro_torch.checkpoint import CheckpointManager

    _, _, extra = CheckpointManager(
        os.path.join(directory, _LADDER_SUBDIR)).restore_tree()
    if extra.get("kind") != "jpeg_plan_ladder":
        raise ValueError(f"{directory} does not hold a plan ladder")
    if extra.get("format") != _LADDER_FORMAT:
        raise ValueError(
            f"unsupported ladder format {extra.get('format')!r}")
    if plan is None:
        plan = planlib.load_plan(directory, device=device)
    caps = tuple(None if c is None else int(c) for c in extra["caps"])
    buckets = extra.get("buckets")
    ladder = build_ladder(
        plan, caps=caps,
        image_size=(None if extra.get("image_size") is None
                    else int(extra["image_size"])),
        vmem_budget=int(extra["vmem_budget"]),
        buckets=None if buckets is None else tuple(int(b) for b in buckets))
    for tier, meta in zip(ladder.tiers, extra["tiers"]):
        saved = {k: int(v) for k, v in meta["bands"].items()}
        if saved != tier.bands:
            raise ValueError(
                f"ladder manifest is stale: tier {tier.name} was saved "
                f"with bands {saved}, the restored plan derives "
                f"{tier.bands}: rebuild the ladder for this plan")
    return ladder
