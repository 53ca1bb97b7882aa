"""Per-step cost attribution over a compiled plan.

The compiled schedule is an explicit step list (``core.plan.
compiled_steps``: stem, one step per residual block, head).  Where the
reference lowers each step alone to optimized HLO and analyses it, the
port runs each step once, eagerly, on a seeded input at its chained
activation shape, under ``introspect.opcount.count`` (aten ops through a
dispatch mode, the hand-written kernels by their wrappers' analytic
work).  Each count is joined with the schedule's own metadata (band
budgets, retained qtable energy, the lowering the step runs, its on-chip
memory estimate) into one :class:`BlockCost` row, and one counted run of
the whole walk cross-checks the sum of the steps.

:func:`predicted_vs_measured` is the headline: the attribution, a
profiled execution (``core.plan.StepProfile``: per-step walls, logits
bit-identical to the unprofiled walk's) and the unprofiled whole walk's
wall, reconciled into the reference's report schema (``REPORT_KIND``,
``REPORT_VERSION``), which ``launch.inspect`` writes and
``introspect.report.validate_report`` checks.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import plan as planlib
from repro_torch.introspect import opcount
from repro_torch.introspect.roofline import (HardwareProfile,
                                             resolve_profile, roofline)

__all__ = ["BlockCost", "block_costs", "predicted_vs_measured"]

REPORT_KIND = "introspect_report"
REPORT_VERSION = 1


@dataclass
class BlockCost:
    """One schedule step's counted cost row (plus its measured wall, when
    a profiled run has been joined in)."""

    name: str
    kind: str                   # "stem" | "fused" | "layers" | "head"
    executor: str               # the lowering the step runs
    flops: float
    bytes: float
    collective_bytes: float
    transcendentals: float
    bands_in: int
    bands_out: int
    layer_bands: dict           # per-layer band budgets inside the step
    energy_kept: float | None   # cumulative qtable energy at bands_out
    vmem_bytes: int
    predicted_s: float
    term: str                   # dominant roofline term
    measured_s: float | None = None
    warnings: list = field(default_factory=list)

    @property
    def ratio(self) -> float | None:
        """measured / predicted (>1: slower than the roofline bound)."""
        if self.measured_s is None or self.predicted_s <= 0:
            return None
        return self.measured_s / self.predicted_s

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "executor": self.executor,
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "transcendentals": self.transcendentals,
            "bands_in": self.bands_in,
            "bands_out": self.bands_out,
            "layer_bands": dict(self.layer_bands),
            "energy_kept": self.energy_kept,
            "vmem_bytes": self.vmem_bytes,
            "predicted_us": self.predicted_s * 1e6,
            "measured_us": (None if self.measured_s is None
                            else self.measured_s * 1e6),
            "ratio": self.ratio,
            "term": self.term,
            "warnings": list(self.warnings),
        }


def _step_executor(cp, step_name: str, executor: str | None,
                   device: torch.device) -> tuple[str, str]:
    """(kind, lowering) of one step: ``gemm``, ``spatial``, ``layers``,
    ``head``, or ``cuda`` for a fused block on the kernels."""
    if step_name == "stem":
        if planlib._packed_stem_runs(cp, executor):
            return "stem", "gemm"
        return "stem", "spatial" if cp.stem.kind == "packed" else "layers"
    if step_name == "head":
        return "head", "head"
    blk = next(b for b in cp.blocks if b.name == step_name)
    if blk.kind != "fused":
        return "layers", "layers"
    return "fused", dispatchlib.fused_lowering(blk.path, cp.cfg,
                                               device=device,
                                               executor=executor)


def _step_bands(cp, step_name: str,
                lowering: str) -> tuple[int, int, dict, int]:
    """(bands_in, bands_out, per-layer bands, on-chip memory estimate).

    The schema's ``vmem_bytes`` carries the port's estimate of on-chip
    memory: a fused step on the kernels reports its largest launch's
    dynamic shared memory per CTA (``kernels.fused_block.
    fused_smem_bytes``); every other step 0."""
    if step_name == "stem":
        st = cp.stem
        return st.bands_out, st.bands_out, {"stem": st.bands_out}, 0
    if step_name == "head":
        last = cp.blocks[-1].bands_out if cp.blocks else cp.stem.bands_out
        return last, last, {}, 0
    blk = next(b for b in cp.blocks if b.name == step_name)
    layer_bands = {slot: int(op.bands) for slot, op in (blk.ops or {}).items()}
    smem = 0
    if lowering == "cuda":
        from repro_torch.kernels import fused_block as kfb

        smem = kfb.fused_smem_bytes(blk.asm_mid, blk.asm_out, blk.proj)
    return blk.bands_in, blk.bands_out, layer_bands, int(smem)


def _seeded_input(shape, device: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)
    return (0.5 * torch.randn(tuple(int(s) for s in shape),
                              generator=gen)).to(device)


def block_costs(cp, shape, *, executor: str | None = None,
                packed: bool = False, hw: HardwareProfile | None = None,
                cross_check: bool = True):
    """Counted per-step cost attribution for a compiled plan.

    ``shape`` is the full input batch shape (``(N, bh, bw, C, 64)``, or
    the tile-packed ``(N, bh, bw, C·w_in)`` with ``packed=True``).  Each
    step of ``core.plan.compiled_steps`` runs once under
    ``opcount.count`` on a seeded input (normals from a CPU generator
    seeded 0, moved to the plan's device) chained from the step before;
    roofline terms come from ``hw`` (default: the resolved profile).

    Returns ``(blocks, whole)``: the :class:`BlockCost` list in schedule
    order and the ``opcount.OpCost`` of one counted whole walk (None with
    ``cross_check=False``).
    """
    hw = resolve_profile() if hw is None else hw
    device = cp.head_w.device
    lowered = planlib.plan_executor(cp, executor)
    quality = getattr(cp.stem.op, "quality", None)
    energy = None if quality is None else planlib.qtable_band_energy(quality)
    x = _seeded_input(shape, device)
    blocks: list[BlockCost] = []
    whole = None
    with torch.inference_mode():
        h = x
        for name, fn in planlib.compiled_steps(cp, executor=executor,
                                               packed=packed):
            with opcount.count() as cost:
                h = fn(h)
            kind, lowering = _step_executor(cp, name, lowered, device)
            bands_in, bands_out, layer_bands, vmem = _step_bands(
                cp, name, lowering)
            roof = roofline(cost.flops, cost.bytes, cost.collective_bytes,
                            hw)
            blocks.append(BlockCost(
                name=name, kind=kind, executor=lowering, flops=cost.flops,
                bytes=cost.bytes, collective_bytes=cost.collective_bytes,
                transcendentals=cost.transcendentals, bands_in=bands_in,
                bands_out=bands_out, layer_bands=layer_bands,
                energy_kept=(None if energy is None or kind == "head"
                             else float(energy[bands_out - 1])),
                vmem_bytes=vmem, predicted_s=roof["predicted_s"],
                term=roof["term"], warnings=list(cost.warnings)))
        if cross_check:
            apply_fn = (planlib.apply_compiled_packed if packed
                        else planlib.apply_compiled)
            with opcount.count() as whole:
                apply_fn(cp, x, executor=executor)
    return blocks, whole


def predicted_vs_measured(cp, x, *, executor: str | None = None,
                          packed: bool = False,
                          hw: HardwareProfile | None = None,
                          iters: int = 5, warmup: int = 1) -> dict:
    """The headline report: per-step predicted against measured latency.

    :func:`block_costs` joined with a profiled execution (per-step walls
    by ``core.plan.StepProfile``, medians over ``iters`` calls after
    ``warmup`` discarded ones) and the *unprofiled* whole walk's wall
    (host clock around a call that ends in a device synchronise, median
    over ``iters``).  ``totals.reconciliation`` is the sum of the
    per-step walls over the unprofiled wall (``chip_smoke.py`` holds it
    within ±10 % on the card), and ``totals.logits_match`` says the
    profiled logits were bit-identical to the unprofiled ones.  The
    count never runs inside a timed wall.
    """
    hw = resolve_profile() if hw is None else hw
    x = torch.as_tensor(x, dtype=torch.float32).to(cp.head_w.device)
    blocks, whole = block_costs(cp, x.shape, executor=executor,
                                packed=packed, hw=hw)
    apply_fn = (planlib.apply_compiled_packed if packed
                else planlib.apply_compiled)
    cuda = x.device.type == "cuda"

    def fence():
        if cuda:
            torch.cuda.synchronize(x.device)

    prof = planlib.StepProfile()
    walls = []
    with torch.inference_mode():
        for _ in range(max(1, warmup)):
            apply_fn(cp, x, executor=executor, profile=prof)
        prof.reset()
        for _ in range(max(1, iters)):
            profiled = apply_fn(cp, x, executor=executor, profile=prof)
        unprofiled = apply_fn(cp, x, executor=executor)
        fence()
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            apply_fn(cp, x, executor=executor)
            fence()
            walls.append(time.perf_counter() - t0)
    measured = prof.summary()
    unprofiled_wall = statistics.median(walls)
    logits_match = bool(torch.equal(profiled, unprofiled))

    by_name = {b.name: b for b in blocks}
    for name, s in measured.items():
        by_name[name].measured_s = s
    measured_total = sum(measured.values())
    sum_flops = sum(b.flops for b in blocks)
    sum_bytes = sum(b.bytes for b in blocks)
    return {
        "kind": REPORT_KIND,
        "version": REPORT_VERSION,
        "meta": {
            "backend": x.device.type,
            "device": (torch.cuda.get_device_name(x.device) if cuda
                       else "cpu"),
            "device_count": torch.cuda.device_count() if cuda else 1,
            "input_shape": list(x.shape),
            "packed": bool(packed),
            "executor": executor,
            "iters": int(iters),
            "hw_profile": hw.to_json(),
        },
        "blocks": [b.to_json() for b in blocks],
        "totals": {
            "flops": sum_flops,
            "bytes": sum_bytes,
            "predicted_us": sum(b.predicted_s for b in blocks) * 1e6,
            "measured_us": measured_total * 1e6,
            "unprofiled_wall_us": unprofiled_wall * 1e6,
            "reconciliation": (measured_total / unprofiled_wall
                               if unprofiled_wall > 0 else float("inf")),
            "whole_flops": whole.flops,
            "whole_bytes": whole.bytes,
            "static_flops_ratio": (None if whole.flops == 0
                                   else sum_flops / whole.flops),
            "logits_match": logits_match,
        },
    }
