"""Convert-once inference: the plan and its compiled schedule.

:func:`build_plan` folds every inference batch norm into the adjacent
conv's Ξ (scale into the output-channel axis, β/μ as a DC shift), explodes
each conv once at its band count and resolves its apply path;
:func:`apply_plan` walks the plan layer by layer (matmuls and ASM only).
:func:`build_operators`/:func:`apply_operators` are the unfused walk with
per-step batch norm (``resnet.precompute_operators`` /
``resnet.jpeg_apply_precomputed``), the parity baseline of the fused plan.

``bands="auto"`` autotunes the band count per layer
(:func:`autotune_bands`): an energy budget over the quantization table's
``1/q²`` (or over an empirical profile, ``codec.IngestStats.energy``)
picks the start, and with a probe batch a parity sweep against the
64-band reference path escalates, then tightens layer by layer.

:func:`compile_plan` lowers a plan into a static schedule: a packed stem,
then per residual block either one **fused** step over tile-packed banded
operators (``kernels.tiling``; the CUDA kernels of ``kernels.fused_block``
on the ``cuda`` path) or the per-layer walk for blocks with a factored
operator, then a head that reads the DC lanes.  Activations between steps
stay in the packed ``(N, bh, bw, C·w)`` layout.  Unlike the reference
package, which demotes blocks whose operands do not fit a TPU core's VMEM,
every materialised block is fused here: the kernels stream Ξ from device
memory, so ``meta["smem"]`` records each fused block's per-CTA shared
memory instead.  A fused step runs one of three lowerings
(``dispatch.fused_lowering``): the kernels on a ``cuda`` plan, the
spatial-resident lowering on a ``reference`` plan (as the reference
serves off-TPU), or, under ``executor="gemm"``, the packed GEMM.
:func:`compiled_steps` is the schedule as a step list, which both apply
functions fold, and :class:`StepProfile` times it step by step.

:func:`capture_compiled` pins the schedule to one input shape: on a CUDA
device one ``torch.cuda.CUDAGraph`` over static input and output buffers,
so a served batch costs one graph replay instead of issuing every kernel
of the walk from Python.

:func:`save_plan`/:func:`load_plan` and :func:`save_compiled_plan`/
:func:`load_compiled_plan` store both through the checkpoint manager
(arrays in the checksummed store, the static structure in the manifest's
``extra``); a restored plan gives bit-identical logits.  They write the
reference package's formats (plan format 2, compiled format 1, with
``pallas`` for the port's ``cuda`` path), so either package reads a plan
directory the other wrote; the port also reads its earlier format
``repro_torch/1``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device

from repro_torch.core import batchnorm as bnlib
from repro_torch.core import dct as dctlib
from repro_torch.core import dispatch as dispatchlib
from repro_torch.core import pooling as poollib
from repro_torch.core import resnet as resnetlib
from repro_torch.core.conv import pad_bands
from repro_torch.kernels import tiling

__all__ = ["BAND_LADDER", "qtable_band_energy", "bands_for_budget",
           "bands_for_profile", "autotune_bands", "operator_keys",
           "build_operators", "apply_operators", "InferencePlan",
           "build_plan", "apply_plan", "CompiledStem", "CompiledBlock",
           "CompiledPlan", "compile_plan", "plan_executor", "compiled_steps",
           "apply_compiled", "apply_compiled_packed", "StepProfile",
           "capture_compiled", "save_plan", "load_plan",
           "save_compiled_plan", "load_compiled_plan"]


#: candidate band counts the autotuner moves along (multiples of 8, the
#: packed widths of the compiled schedule)
BAND_LADDER = (8, 16, 24, 32, 40, 48, 56, 64)


# --------------------------------------------------------------------------
# Per-layer band autotuning
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def qtable_band_energy(quality: int = 50) -> np.ndarray:
    """Cumulative retained-energy fraction per zigzag prefix length (a
    read-only array).

    Quantization divides coefficient ``k`` by ``q[k]``, so under a flat
    spectral prior the energy that survives it scales as ``1/q[k]²``;
    ``out[b-1]`` is the share of that energy in the first ``b`` zigzag
    coefficients (non-decreasing).
    """
    q = dctlib.quantization_table(quality)
    w = 1.0 / (q * q)
    out = np.cumsum(w) / np.sum(w)
    out.setflags(write=False)
    return out


def _bands_from_cum(cum: np.ndarray, budget: float) -> int:
    if not 0.0 < budget <= 1.0:
        raise ValueError(f"budget must be in (0, 1], got {budget}")
    b = int(np.searchsorted(cum, budget - 1e-12) + 1)
    return min(dctlib.NFREQ, ((b + 7) // 8) * 8)


def bands_for_budget(quality: int, budget: float) -> int:
    """Smallest band count whose cumulative qtable energy reaches
    ``budget``, rounded up to a multiple of 8; monotone in ``budget``."""
    return _bands_from_cum(qtable_band_energy(quality), budget)


def _profile_cum(profile: np.ndarray) -> np.ndarray:
    p = np.asarray(profile, np.float64).reshape(dctlib.NFREQ)
    if np.any(p < 0):
        raise ValueError("energy profile must be non-negative")
    total = p.sum()
    if total <= 0:
        raise ValueError("energy profile is all zero")
    return np.cumsum(p) / total


def bands_for_profile(profile: np.ndarray, budget: float) -> int:
    """:func:`bands_for_budget` over an empirical per-zigzag energy profile
    (``codec.IngestStats.energy`` of real traffic) instead of the ``1/q²``
    prior."""
    return _bands_from_cum(_profile_cum(profile), budget)


def autotune_bands(params: Any, state: Any, spec: resnetlib.ResNetSpec, *,
                   budget: float = 0.95,
                   probe_coef: torch.Tensor | None = None,
                   tol: float = 5e-2, ladder: tuple[int, ...] = BAND_LADDER,
                   phi: int | None = None,
                   profile: np.ndarray | None = None,
                   occupancy: np.ndarray | None = None) -> dict[str, int]:
    """Per-layer band assignment: an energy budget, refined by a parity
    sweep when a probe batch is given.

    Every conv starts at :func:`bands_for_budget` (or
    :func:`bands_for_profile` over ``profile``).  With ``probe_coef``
    (``(N, bh, bw, C, 64)`` coefficients on the parameters' device) the
    assignment is held against the 64-band plan on the ``reference`` path
    (the kernels' plain versions): parity is logits within ``tol`` and the
    same top-1 on every probe image.

    1. While parity fails, every layer moves one ``ladder`` step up.
    2. Then, last layer to first, each layer moves down while parity
       holds.

    Trial plans are assembled from a cache of operators keyed by (layer,
    band), so a trial explodes only the layer it changes; the cache keeps
    no more than the accepted assignment and the trial in hand (a 40-band
    stage 0 at full width is ~1 GB of Ξ).  With ``profile`` each layer's
    choice is printed beside the energy it keeps and the nonzero
    coefficients (``occupancy``) it drops.
    """
    base = (bands_for_profile(profile, budget) if profile is not None
            else bands_for_budget(spec.quality, budget))
    keys = operator_keys(params, spec)
    bands = {k: base for k in keys}
    if probe_coef is None:
        _log_band_choice(bands, keys, profile, occupancy)
        return bands

    phi = spec.phi if phi is None else phi
    ref_cfg = dispatchlib.DispatchConfig(path="reference",
                                         bands=dctlib.NFREQ)
    head_w, head_b = params["head"]["w"], params["head"]["b"]
    probe = torch.as_tensor(probe_coef, device=head_w.device)
    folds = _fold_all(params, state, spec)
    convs = _convs(params, spec)
    cache: dict[tuple[str, int], dispatchlib.ConvOperator] = {}

    def op(key: str, b: int) -> dispatchlib.ConvOperator:
        if (key, b) not in cache:
            kernel, stride, kw = convs[key]
            scale, shift = folds.get(key, (None, None))
            cache[(key, b)] = dispatchlib.precompute_conv(
                kernel, stride, bands=b, scale=scale, shift=shift,
                cfg=ref_cfg, **kw)
        return cache[(key, b)]

    def forward(assign: dict[str, int]) -> torch.Tensor:
        ops: dict[str, Any] = {}
        for key in keys:
            if "/" in key:
                name, slot = key.split("/")
                ops.setdefault(name, {})[slot] = op(key, assign[key])
            else:
                ops[key] = op(key, assign[key])
        with torch.inference_mode():
            return apply_plan(InferencePlan(ops, head_w, head_b, spec, phi,
                                            ref_cfg, dict(assign)), probe)

    def keep_only(assign: dict[str, int]) -> None:
        for k in [k for k in cache if assign[k[0]] != k[1]]:
            del cache[k]

    ref = forward({k: dctlib.NFREQ for k in keys})
    ref_top1 = ref.argmax(-1)
    keep_only(bands)

    def parity(assign: dict[str, int]) -> bool:
        got = forward(assign)
        return (float((got - ref).abs().max()) <= tol
                and bool((got.argmax(-1) == ref_top1).all()))

    def bump(b: int) -> int:
        nxt = [v for v in ladder if v > b]
        return nxt[0] if nxt else dctlib.NFREQ

    while not parity(bands) and any(v < dctlib.NFREQ
                                    for v in bands.values()):
        bands = {k: bump(v) for k, v in bands.items()}
        keep_only(bands)

    for k in reversed(keys):
        while True:
            lower = [v for v in ladder if v < bands[k]]
            if not lower:
                break
            trial = dict(bands)
            trial[k] = lower[-1]
            ok = parity(trial)
            if ok:
                bands = trial
            keep_only(bands)
            if not ok:
                break
    cache.clear()
    _log_band_choice(bands, keys, profile, occupancy)
    return bands


def _log_band_choice(bands: dict[str, int], keys: list[str],
                     profile: np.ndarray | None,
                     occupancy: np.ndarray | None) -> None:
    """Per layer, the empirical energy its cutoff keeps and the share of
    nonzero coefficients it drops (only with a profile)."""
    if profile is None:
        return
    cum = _profile_cum(profile)
    occ_total = float(np.sum(occupancy)) if occupancy is not None else 0.0
    for k in keys:
        b = bands[k]
        line = f"[autotune] {k}: bands={b} energy_kept={cum[b - 1]:.4f}"
        if occupancy is not None and occ_total > 0:
            dropped = float(np.sum(occupancy[b:])) / occ_total
            line += f" occupancy_dropped={dropped:.2%}"
        print(line, flush=True)


# --------------------------------------------------------------------------
# Operators and the two walks
# --------------------------------------------------------------------------


def operator_keys(params: Any, spec: resnetlib.ResNetSpec) -> list[str]:
    """Flat conv-operator keys in forward order: ``stem``, ``s0b0/conv1``…"""
    keys = ["stem"]
    for name, s, cin, w in resnetlib._stages(spec):
        if "proj" in params[name]:
            keys.append(f"{name}/proj")
        keys.append(f"{name}/conv1")
        keys.append(f"{name}/conv2")
    return keys


def _resolve_bands(bands: Any, key: str,
                   cfg: dispatchlib.DispatchConfig) -> int:
    if bands is None:
        return cfg.bands
    if isinstance(bands, int):
        return bands
    return int(bands.get(key, cfg.bands))


def build_operators(params: Any, spec: resnetlib.ResNetSpec,
                    cfg: dispatchlib.DispatchConfig, *,
                    folds: dict[str, tuple] | None = None,
                    bands: Any = None) -> dict[str, Any]:
    """Explode every convolution once → ``{"stem": op, "s0b0": {...}}``.

    ``folds`` maps operator keys to ``(scale, shift)``; ``bands`` is None
    (``cfg.bands``), an int, or a per-key dict.
    """
    folds = folds or {}
    ops: dict[str, Any] = {}
    for key, (kernel, stride, kw) in _convs(params, spec).items():
        scale, shift = folds.get(key, (None, None))
        op = dispatchlib.precompute_conv(
            kernel, stride, bands=_resolve_bands(bands, key, cfg),
            scale=scale, shift=shift, cfg=cfg, **kw)
        if "/" in key:
            name, slot = key.split("/")
            ops.setdefault(name, {})[slot] = op
        else:
            ops[key] = op
    return ops


def _convs(params: Any, spec: resnetlib.ResNetSpec
           ) -> dict[str, tuple[torch.Tensor, int, dict[str, Any]]]:
    """``{key: (kernel, stride, precompute_conv arguments)}`` of every
    conv; a block's slots in the order conv1, conv2, proj."""
    out = {"stem": (params["stem"]["kernel"], 1,
                    {"in_scaled": True, "quality": spec.quality})}
    for name, s, cin, w in resnetlib._stages(spec):
        blk = params[name]
        out[f"{name}/conv1"] = (blk["conv1"], s, {})
        out[f"{name}/conv2"] = (blk["conv2"], 1, {})
        if "proj" in blk:
            out[f"{name}/proj"] = (blk["proj"], s, {})
    return out


def apply_operators(params: Any, state: Any, ops: dict[str, Any],
                    coef: torch.Tensor, *, spec: resnetlib.ResNetSpec,
                    phi: int | None = None,
                    cfg: dispatchlib.DispatchConfig | None = None
                    ) -> torch.Tensor:
    """Precomputed-operator inference with per-step batch norm from the
    live ``state``: the unfused walk, the parity baseline of
    :func:`apply_plan`.

    Operators that carry a fused batch norm (built by :func:`build_plan`)
    raise ``ValueError``: batch norm would run twice.
    """
    phi = spec.phi if phi is None else phi
    cfg = dispatchlib.resolve_config(cfg)
    stem = ops["stem"]
    if any(v is not None for v in (stem.scale, stem.shift, stem.bn_scale)):
        raise ValueError(
            "operators carry a fused batch norm (built by build_plan); "
            "applying per-step batch norm on top would run BN twice — "
            "serve them through plan.apply_plan, or build unfused "
            "operators with resnet.precompute_operators")

    def bn(name, h):
        h, _ = dispatchlib.batchnorm(h, *resnetlib._bn_args(params, state,
                                                            name),
                                     training=False)
        return h

    def relu(h):
        return dispatchlib.asm_relu(h, phi, cfg=cfg)

    h = relu(bn("stem_bn", dispatchlib.apply_conv(coef, stem, cfg=cfg)))
    for name, s, cin, w in resnetlib._stages(spec):
        op = ops[name]
        short = h
        if "proj" in op:
            short = dispatchlib.apply_conv(h, op["proj"], cfg=cfg)
        h = dispatchlib.apply_conv(h, op["conv1"], cfg=cfg)
        h = relu(bn(name + "_bn1", h))
        h = dispatchlib.apply_conv(h, op["conv2"], cfg=cfg)
        h = bn(name + "_bn2", h)
        h = relu(poollib.residual_add(h, short))
    pooled = poollib.global_avg_pool_jpeg(h)
    return pooled @ params["head"]["w"] + params["head"]["b"]


def _fold_all(params: Any, state: Any, spec: resnetlib.ResNetSpec,
              eps: float = 1e-5) -> dict[str, tuple]:
    """``(scale, shift)`` folds for every batch-normed conv (projections
    have no batch norm)."""

    def fold(bn):
        return bnlib.fold_batchnorm(params[bn]["gamma"], params[bn]["beta"],
                                    state[bn]["mean"], state[bn]["var"],
                                    eps=eps)

    folds = {"stem": fold("stem_bn")}
    for name, s, cin, w in resnetlib._stages(spec):
        folds[f"{name}/conv1"] = fold(name + "_bn1")
        folds[f"{name}/conv2"] = fold(name + "_bn2")
    return folds


class InferencePlan(NamedTuple):
    """Fused-BN operators at their band counts, plus the head weights."""

    operators: dict[str, Any]
    head_w: torch.Tensor
    head_b: torch.Tensor
    spec: resnetlib.ResNetSpec
    phi: int
    cfg: dispatchlib.DispatchConfig
    bands: dict[str, int]
    #: how the band assignment was made (``{"bands_mode": "auto" |
    #: "global" | "explicit", ...}``, the reference's keys; ladder tiers
    #: add ``tier_cap``)
    provenance: Any = None

    @property
    def device(self) -> torch.device:
        return self.head_w.device


def build_plan(params: Any, state: Any, spec: resnetlib.ResNetSpec, *,
               phi: int | None = None,
               dispatch: dispatchlib.DispatchConfig | None = None,
               bands: Any = None, budget: float | None = None,
               probe_coef: torch.Tensor | None = None,
               profile: np.ndarray | None = None,
               occupancy: np.ndarray | None = None,
               eps: float = 1e-5) -> InferencePlan:
    """Fuse batch norm and explode the model, on the parameters' device.

    ``bands``: None → ``dispatch.bands`` for every layer; an int or a
    per-key dict → explicit assignment; ``"auto"`` (or a ``budget``) →
    :func:`autotune_bands` from the quantization table, or from an
    empirical energy ``profile``, refined by the parity sweep when
    ``probe_coef`` is given.  ``provenance`` records which.
    """
    phi = spec.phi if phi is None else phi
    cfg = dispatchlib.resolve_config(dispatch)
    autotuned = (isinstance(bands, str) and bands == "auto") \
        or budget is not None
    if autotuned:
        bands = autotune_bands(params, state, spec,
                               budget=0.95 if budget is None else budget,
                               probe_coef=probe_coef, phi=phi,
                               profile=profile, occupancy=occupancy)
    provenance = {
        "bands_mode": ("auto" if autotuned
                       else "global" if bands is None else "explicit"),
        "budget": budget,
        "probe": probe_coef is not None,
        "energy": (("empirical" if profile is not None else "qtable")
                   if autotuned else None)}
    folds = _fold_all(params, state, spec, eps=eps)
    ops = build_operators(params, spec, cfg, folds=folds, bands=bands)
    resolved = {k: _resolve_bands(bands, k, cfg)
                for k in operator_keys(params, spec)}
    return InferencePlan(ops, params["head"]["w"], params["head"]["b"],
                         spec, phi, cfg, resolved, provenance)


def apply_plan(plan: InferencePlan, coef: torch.Tensor,
               cfg: dispatchlib.DispatchConfig | None = None) -> torch.Tensor:
    """The per-layer walk over ``(N, bh, bw, C, 64)`` coefficients.

    Each activation runs ASM at its producing layer's band count; the
    residual join runs at the wider of its two contributors.
    """
    cfg = plan.cfg if cfg is None else cfg
    ops = plan.operators

    def relu(h, b):
        return dispatchlib.asm_relu(h, plan.phi, cfg=cfg, bands=b)

    h = dispatchlib.apply_conv(coef, ops["stem"], cfg=cfg)
    cur = ops["stem"].bands
    h = relu(h, cur)
    for name, s, cin, w in resnetlib._stages(plan.spec):
        op = ops[name]
        short, short_bands = h, cur
        if "proj" in op:
            short = dispatchlib.apply_conv(h, op["proj"], cfg=cfg)
            short_bands = op["proj"].bands
        h = dispatchlib.apply_conv(h, op["conv1"], cfg=cfg)
        h = relu(h, op["conv1"].bands)
        h = dispatchlib.apply_conv(h, op["conv2"], cfg=cfg)
        cur = max(op["conv2"].bands, short_bands)
        h = relu(poollib.residual_add(h, short), cur)
    pooled = poollib.global_avg_pool_jpeg(h)
    return pooled @ plan.head_w + plan.head_b


# --------------------------------------------------------------------------
# Compiled schedule
# --------------------------------------------------------------------------


def _r8(bands: int) -> int:
    """Packed per-channel width for a band count (a multiple of 8)."""
    return min(dctlib.NFREQ, tiling.round_up(bands, tiling.SUBLANE))


class CompiledStem(NamedTuple):
    kind: str                  # "packed" | "layers"
    conv: Any                  # tiling.PackedConv | None
    asm: Any                   # tiling.PackedAsm | None
    op: Any                    # ConvOperator
    cin: int
    cout: int
    w_in: int                  # zigzag prefix read from the raw coefficients
    w_out: int
    bands_out: int


class CompiledBlock(NamedTuple):
    """One residual block: ``kind`` "fused" (packed operators) or "layers"
    (per-layer walk over ``ops``).  ``w_in``/``w_out`` are packed widths,
    ``bands_in``/``bands_out`` true band counts (``bands_out`` is the
    residual-join width ``max(conv2.bands, shortcut bands)``)."""

    kind: str
    name: str
    cin: int
    cout: int
    w_in: int
    w_out: int
    bands_in: int
    bands_out: int
    path: str
    conv1: Any = None
    asm_mid: Any = None
    conv2: Any = None
    proj: Any = None
    asm_out: Any = None
    ops: Any = None


class CompiledPlan(NamedTuple):
    stem: CompiledStem
    blocks: tuple
    head_w: torch.Tensor
    head_b: torch.Tensor
    spec: resnetlib.ResNetSpec
    phi: int
    cfg: dispatchlib.DispatchConfig
    bands: dict[str, int]
    meta: Any = None


def compile_plan(plan: InferencePlan) -> CompiledPlan:
    """Lower a plan into the static schedule (see the module docstring)."""
    from repro_torch.kernels import fused_block as kfb

    spec, phi, cfg, dev = plan.spec, plan.phi, plan.cfg, plan.device
    path = dispatchlib.choose_path("fused_block", cfg, device=dev)
    if path == "factored":
        path = "reference"
    meta: dict[str, Any] = {"fused": [], "layers": {}, "smem": {},
                            "path": path}

    st = plan.operators["stem"]
    cout0, cin0 = st.kernel.shape[0], st.kernel.shape[1]
    w0 = _r8(st.bands)
    if st.xi is not None:
        stem = CompiledStem(
            "packed",
            tiling.pack_conv(st.xi, st.shift, st.stride, w_in=w0, w_out=w0),
            tiling.pack_asm(phi, st.bands, w0, device=dev),
            st, cin0, cout0, w0, w0, st.bands)
    else:
        stem = CompiledStem("layers", None, None, st, cin0, cout0,
                            dctlib.NFREQ, w0, st.bands)
        meta["layers"]["stem"] = "factored operator"

    cur_b, cur_w = stem.bands_out, stem.w_out
    blocks = []
    for name, s, cin, w in resnetlib._stages(spec):
        entry = plan.operators[name]
        c1, c2 = entry["conv1"], entry["conv2"]
        pr = entry.get("proj")
        short_b = pr.bands if pr is not None else cur_b
        j_true = max(c2.bands, short_b)
        convs = [c1, c2] + ([pr] if pr is not None else [])
        if all(op.xi is not None for op in convs):
            w_mid, w_j = _r8(c1.bands), _r8(j_true)
            p1 = tiling.pack_conv(c1.xi, c1.shift, c1.stride,
                                  w_in=_r8(min(c1.bands, cur_b)),
                                  w_out=w_mid)
            a1 = tiling.pack_asm(phi, c1.bands, w_mid, device=dev)
            p2 = tiling.pack_conv(c2.xi, c2.shift, c2.stride,
                                  w_in=_r8(min(c2.bands, c1.bands)),
                                  w_out=_r8(c2.bands))
            pp = None
            if pr is not None:
                pp = tiling.pack_conv(pr.xi, pr.shift, pr.stride,
                                      w_in=_r8(min(pr.bands, cur_b)),
                                      w_out=_r8(pr.bands))
            a2 = tiling.pack_asm(phi, j_true, w_j, device=dev)
            meta["smem"][name] = kfb.fused_smem_bytes(a1, a2, pp)
            meta["fused"].append(name)
            blk = CompiledBlock("fused", name, cin, w, cur_w, w_j, cur_b,
                                j_true, path, p1, a1, p2, pp, a2,
                                dict(entry))
        else:
            meta["layers"][name] = "factored operator"
            blk = CompiledBlock("layers", name, cin, w, cur_w, _r8(j_true),
                                cur_b, j_true, path, ops=dict(entry))
        blocks.append(blk)
        cur_b, cur_w = blk.bands_out, blk.w_out
    return CompiledPlan(stem, tuple(blocks), plan.head_w, plan.head_b,
                        spec, phi, cfg, dict(plan.bands), meta)


def _packed_stem_runs(cp: CompiledPlan, executor: str | None) -> bool:
    """Whether the stem runs as the packed GEMM (``gemm``, or a ``cuda``
    plan) rather than spatial (a packed stem on the ``reference`` path)
    or per layer (a factored stem)."""
    path = (cp.meta or {}).get("path", "reference")
    return cp.stem.kind == "packed" and (executor == "gemm"
                                         or path == "cuda")


def _apply_stem(cp: CompiledPlan, coef: torch.Tensor,
                cfg: dispatchlib.DispatchConfig,
                executor: str | None) -> torch.Tensor:
    """Stem from ``(N, bh, bw, C, 64)`` coefficients → packed activation."""
    from repro_torch.kernels import fused_block as kfb

    stem, n, (bh, bw) = cp.stem, coef.shape[0], coef.shape[1:3]
    if _packed_stem_runs(cp, executor):
        h = coef[..., : stem.w_in].reshape(n, bh, bw, stem.cin * stem.w_in)
        return _packed_stem(stem, h)
    if stem.kind == "packed":
        return kfb.fused_stem_spatial(coef, stem.op, cp.phi, stem.w_out)
    h = dispatchlib.apply_conv(coef, stem.op, cfg=cfg)
    h = dispatchlib.asm_relu(h, cp.phi, cfg=cfg, bands=stem.bands_out)
    return h[..., : stem.w_out].reshape(n, bh, bw, stem.cout * stem.w_out)


def _packed_stem(stem: CompiledStem, packed: torch.Tensor) -> torch.Tensor:
    # The stem's products stay plain torch.matmul, as the reference
    # package leaves them to XLA.
    h = tiling.packed_conv_apply(packed, stem.conv)
    return tiling.packed_asm_apply(h, stem.asm)


def _apply_layers_block(blk: CompiledBlock, h: torch.Tensor, phi: int,
                        cfg: dispatchlib.DispatchConfig) -> torch.Tensor:
    """Per-layer block: unpack to 64 lanes, run the :func:`apply_plan`
    block body, repack to the scheduled output width."""
    n, bh, bw, _ = h.shape
    ops = blk.ops
    s = ops["conv1"].stride
    h64 = pad_bands(h.reshape(n, bh, bw, blk.cin, blk.w_in))
    short, short_b = h64, blk.bands_in
    if "proj" in ops:
        short = dispatchlib.apply_conv(h64, ops["proj"], cfg=cfg)
        short_b = ops["proj"].bands
    x = dispatchlib.apply_conv(h64, ops["conv1"], cfg=cfg)
    x = dispatchlib.asm_relu(x, phi, cfg=cfg, bands=ops["conv1"].bands)
    x = dispatchlib.apply_conv(x, ops["conv2"], cfg=cfg)
    x = poollib.residual_add(x, short)
    x = dispatchlib.asm_relu(x, phi, cfg=cfg,
                             bands=max(ops["conv2"].bands, short_b))
    return x[..., : blk.w_out].reshape(n, bh // s, bw // s,
                                       blk.cout * blk.w_out)


def _block_steps(cp: CompiledPlan, cfg: dispatchlib.DispatchConfig,
                 executor: str | None):
    """The post-stem schedule as ``(name, fn)`` steps: one per residual
    block, then the DC-read head."""

    def block_fn(blk, w_prev):
        def fn(h):
            if blk.w_in != w_prev:
                h = tiling.fit_width(h, blk.cin, blk.w_in)
            if blk.kind == "fused":
                return dispatchlib.fused_block(h, blk, cp.phi, path=blk.path,
                                               cfg=cfg, executor=executor)
            return _apply_layers_block(blk, h, cp.phi, cfg)

        return fn

    def head_fn(w):
        def fn(h):
            dc = h[..., 0::w]  # per-channel DC lanes of the packed layout
            pooled = dc.mean(dim=(1, 2)) / bnlib.DC_GAIN
            return pooled @ cp.head_w + cp.head_b

        return fn

    steps, cur_w = [], cp.stem.w_out
    for blk in cp.blocks:
        steps.append((blk.name, block_fn(blk, cur_w)))
        cur_w = blk.w_out
    steps.append(("head", head_fn(cur_w)))
    return steps


def plan_executor(cp: CompiledPlan, executor: str | None) -> str | None:
    """The executor ``cp`` runs under ``executor``: as asked, but always
    ``gemm`` for a plan restored from the port's earlier format
    (``meta["executor"]``), which cannot take the spatial lowering."""
    if executor not in (None, "gemm"):
        raise ValueError(f"unknown executor {executor!r} (None or 'gemm')")
    return (cp.meta or {}).get("executor") or executor


def compiled_steps(cp: CompiledPlan,
                   cfg: dispatchlib.DispatchConfig | None = None, *,
                   executor: str | None = None, packed: bool = False):
    """The whole schedule as an explicit ``(name, fn)`` step list:
    ``stem`` (coefficients, or the tile-packed stem input with
    ``packed=True``, to packed activations), one step per residual
    block, and ``head`` (packed activations to logits).

    :func:`apply_compiled` and :func:`apply_compiled_packed` fold exactly
    this list, so a per-step walk (attribution, profiled timing) runs the
    production schedule's own closures.
    """
    cfg = cp.cfg if cfg is None else cfg
    executor = plan_executor(cp, executor)
    st = cp.stem

    def stem_fn(x):
        if not packed:
            return _apply_stem(cp, x, cfg, executor)
        n, bh, bw, k = x.shape
        if k != st.cin * st.w_in:
            raise ValueError(
                f"packed input has per-channel width {k / st.cin:g}, "
                f"stem expects w_in={st.w_in} (cin={st.cin})")
        if _packed_stem_runs(cp, executor):
            return _packed_stem(st, x)
        # the spatial and per-layer stems read the 64-wide layout;
        # unpacking is a zero pad (lanes past w_in >= stem.bands are
        # dropped by the stem conv anyway)
        return _apply_stem(cp, pad_bands(x.reshape(n, bh, bw, st.cin,
                                                   st.w_in)), cfg, executor)

    return [("stem", stem_fn)] + _block_steps(cp, cfg, executor)


def _fold(steps, x: torch.Tensor) -> torch.Tensor:
    for _name, fn in steps:
        x = fn(x)
    return x


def apply_compiled(cp: CompiledPlan, coef: torch.Tensor,
                   cfg: dispatchlib.DispatchConfig | None = None, *,
                   executor: str | None = None,
                   profile: "StepProfile | None" = None) -> torch.Tensor:
    """Run the schedule on ``(N, bh, bw, C, 64)`` coefficients.

    ``executor=None`` honours each step's compile-time path: the kernels
    on a ``cuda`` plan (their plain twin under a ``reference`` config),
    the spatial-resident lowering for fused blocks and a packed stem on a
    ``reference`` plan.  ``executor="gemm"`` forces the packed-GEMM
    lowering on the stem and every fused block: the kernels on a ``cuda``
    plan with a card, ``kernels.fused_block.fused_block_reference``
    otherwise; its cost, unlike the spatial lowering's, scales with the
    packed band widths.

    ``profile`` (a :class:`StepProfile`) runs the same step closures one
    at a time, each fenced by a device synchronise, and records each
    step's wall; the logits are bit-identical to the unprofiled walk's.
    """
    steps = compiled_steps(cp, cfg, executor=executor)
    if profile is not None:
        return _apply_profiled(steps, coef, profile)
    return _fold(steps, coef)


def apply_compiled_packed(cp: CompiledPlan, packed: torch.Tensor,
                          cfg: dispatchlib.DispatchConfig | None = None, *,
                          executor: str | None = None,
                          profile: "StepProfile | None" = None
                          ) -> torch.Tensor:
    """Run the schedule on the tile-packed stem input ``(N, bh, bw,
    Cin·stem.w_in)`` (``codec.ingest_batch(pack_width=cp.stem.w_in)``);
    ``executor`` and ``profile`` as for :func:`apply_compiled`."""
    steps = compiled_steps(cp, cfg, executor=executor, packed=True)
    if profile is not None:
        return _apply_profiled(steps, packed, profile)
    return _fold(steps, packed)


class StepProfile:
    """Per-step walls of profiled compiled runs.

    Pass one as ``apply_compiled(..., profile=prof)`` (or the packed
    entry): the schedule runs step by step, each step fenced on both
    sides by ``torch.cuda.synchronize()`` on the card (nothing on the
    CPU, which runs synchronously) and timed by ``time.perf_counter``;
    one sample per step is appended per call.  The first calls pay
    one-time work (kernel builds, cached operands, cuDNN's first plans):
    call once to warm, then :meth:`reset` before the measuring calls.
    :meth:`summary` reduces the samples to per-step medians.
    """

    def __init__(self) -> None:
        self.order: list[str] = []
        self.samples: dict[str, list[float]] = {}
        self.calls = 0

    def record(self, name: str, seconds: float) -> None:
        if name not in self.samples:
            self.order.append(name)
            self.samples[name] = []
        self.samples[name].append(seconds)

    def reset(self) -> None:
        """Drop the recorded samples."""
        self.order.clear()
        self.samples.clear()
        self.calls = 0

    def summary(self) -> dict[str, float]:
        """Per-step median wall (seconds), in schedule order."""
        import statistics

        return {name: statistics.median(self.samples[name])
                for name in self.order}

    def total_s(self) -> float:
        return sum(self.summary().values())


def _apply_profiled(steps, x: torch.Tensor,
                    profile: StepProfile) -> torch.Tensor:
    import time

    def fence():
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    fence()
    for name, fn in steps:
        t0 = time.perf_counter()
        x = fn(x)
        fence()
        profile.record(name, time.perf_counter() - t0)
    profile.calls += 1
    return x


def capture_compiled(cp: CompiledPlan, shape, *, packed: bool = False,
                     executor: str | None = None,
                     device: str | torch.device | None = None, pool=None,
                     on_capture=None):
    """Pin the schedule to one input shape; returns ``call(x) -> logits``.

    ``shape`` is the whole batch: ``(N, bh, bw, C, 64)`` coefficients, or
    ``(N, bh, bw, C·stem.w_in)`` with ``packed=True``.  A call at any other
    shape raises ``ValueError``.  ``executor`` is :func:`apply_compiled`'s.

    On a CUDA device the walk runs once eagerly on a side stream, which
    builds the kernels and fills every cached operand (the kernels'
    ``lru_cache``s, ``jpeg_conv``'s SM count), then is captured into one
    ``torch.cuda.CUDAGraph`` over a static input buffer.  ``call(x)``
    copies ``x`` (device or pinned host memory, ``non_blocking``) into that
    buffer, replays the graph and returns its static output buffer: the
    next call overwrites it, so the caller copies or consumes it first.
    ``pool`` (``torch.cuda.graph_pool_handle()``) lets several captures
    share one memory pool for their intermediates; each keeps its own
    static input and output alive, and replays on one stream never
    overlap.  A failed capture raises: there is no eager fallback.

    The kernel wrappers count launches on the host, so the capture's
    calls record kernels into the graph and launch nothing: the counts
    are put back as they were, and ``call.graph_launches`` holds what one
    replay launches (kernel name → count).

    On the CPU (the path the caller asked for with ``device="cpu"``) the
    returned ``call`` runs the walk eagerly.  ``on_capture()`` fires once
    per capture, the counterpart of the reference's compile accounting.
    """
    from repro_torch import kernels

    shape = tuple(int(s) for s in shape)
    entry = apply_compiled_packed if packed else apply_compiled
    apply_fn = functools.partial(entry, executor=executor)
    dev = resolve_device(device)

    def check(x):
        if tuple(x.shape) != shape:
            raise ValueError(
                f"captured executable is pinned to shape {shape}, got "
                f"{tuple(x.shape)}: route through the grid cell for that "
                f"shape")

    if dev.type != "cuda":
        def call(x):
            check(x)
            with torch.inference_mode():
                return apply_fn(cp, x)

        call.graph, call.graph_launches = None, {}
        if on_capture is not None:
            on_capture()
        return call

    static_in = torch.zeros(shape, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.inference_mode(), torch.cuda.stream(side):
        apply_fn(cp, static_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(
            graph, pool=pool, capture_error_mode="thread_local"):
        static_out = apply_fn(cp, static_in)
    after = kernels.launch_counts()
    kernels.set_launch_counts(before)

    def call(x):
        check(x)
        static_in.copy_(x, non_blocking=True)
        graph.replay()
        return static_out

    call.graph = graph
    call.graph_launches = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
    if on_capture is not None:
        on_capture()
    return call


# --------------------------------------------------------------------------
# Serialization through the checkpoint manager
# --------------------------------------------------------------------------

_OP_ARRAYS = ("xi", "kernel", "scale", "shift", "bn_scale")
_OP_STATIC = ("stride", "bands", "quality", "in_scaled", "out_scaled", "path")
_PC_STATIC = ("stride", "ndy", "ndx", "cin", "w_in", "cout", "w_out")
_PA_STATIC = ("w", "bands", "phi")
_CFG_FIELDS = ("path", "bands", "materialize_limit")
#: the reference package's formats, which :func:`save_plan` and
#: :func:`save_compiled_plan` write; the loaders also read the port's
#: earlier ``repro_torch/1``
_PLAN_FORMAT = 2
_COMPILED_FORMAT = 1
_PORT_FORMAT = "repro_torch/1"


def _ref_path(path: str) -> str:
    """A path name as the reference package spells it (``cuda`` →
    ``pallas``), so that its loaders accept what the port saves."""
    return "pallas" if path == "cuda" else path


def _leaf_path(key: str) -> str:
    """The path the checkpoint manager records for flat-dict key ``key``."""
    return f"[{key!r}]"


def _op_save(key: str, op: dispatchlib.ConvOperator,
             arrays: dict[str, torch.Tensor]) -> dict[str, Any]:
    meta: dict[str, Any] = {f: getattr(op, f) for f in _OP_STATIC}
    meta["path"] = _ref_path(op.path)
    for f in _OP_ARRAYS:
        val = getattr(op, f)
        meta[f"has_{f}"] = val is not None
        if val is not None:
            arrays[f"{key}.{f}"] = val
    return meta


def _op_load(key: str, meta: dict[str, Any],
             arr) -> dispatchlib.ConvOperator:
    fields = {f: meta[f] for f in _OP_STATIC}
    fields["path"] = dispatchlib.canonical_path(fields["path"])
    for f in _OP_ARRAYS:  # bn_scale is absent from repro_torch/1
        fields[f] = arr(f"{key}.{f}") if meta.get(f"has_{f}") else None
    return dispatchlib.ConvOperator(**fields)


def _cfg_save(cfg: dispatchlib.DispatchConfig) -> dict[str, Any]:
    return dict(dataclasses.asdict(cfg), path=_ref_path(cfg.path))


def _cfg_load(d: dict[str, Any]) -> dispatchlib.DispatchConfig:
    # the reference's ``interpret`` forces the Pallas interpreter off-TPU;
    # it has no meaning here and is dropped
    return dispatchlib.DispatchConfig(
        **{f: d[f] for f in _CFG_FIELDS if f in d})


def _spec_json(spec: resnetlib.ResNetSpec) -> dict[str, Any]:
    return dict(spec._asdict(), widths=list(spec.widths))


def _spec_from(d: dict[str, Any]) -> resnetlib.ResNetSpec:
    return resnetlib.ResNetSpec(**dict(d, widths=tuple(d["widths"])))


def _restore(directory: str, step: int | None, kind: str, formats: tuple,
             device) -> tuple[dict[str, Any], Any]:
    from repro_torch.checkpoint import CheckpointManager

    dev = resolve_device(device)
    _, by_path, extra = CheckpointManager(directory).restore_tree(step)
    if extra.get("kind") != kind:
        raise ValueError(f"{directory} does not hold a {kind}")
    if extra.get("format") not in formats:
        raise ValueError(f"unsupported {kind} format "
                         f"{extra.get('format')!r} (want one of {formats})")

    def arr(key):
        return torch.as_tensor(np.asarray(by_path[_leaf_path(key)])).to(dev)

    return extra, arr


def _flat_ops(plan: InferencePlan) -> dict[str, dispatchlib.ConvOperator]:
    out = {}
    for name, entry in plan.operators.items():
        if isinstance(entry, dict):
            out.update({f"{name}/{slot}": op for slot, op in entry.items()})
        else:
            out[name] = entry
    return out


def save_plan(plan: InferencePlan, directory: str, step: int = 0,
              keep: int = 3) -> None:
    """Persist a plan in the reference's plan format 2: its arrays through
    the checksummed, atomic store, its static structure in the manifest's
    ``extra``."""
    from repro_torch.checkpoint import CheckpointManager

    arrays = {"head.w": plan.head_w, "head.b": plan.head_b}
    meta_ops = {key: _op_save(key, op, arrays)
                for key, op in _flat_ops(plan).items()}
    extra = {"kind": "jpeg_inference_plan", "format": _PLAN_FORMAT,
             "spec": _spec_json(plan.spec), "phi": plan.phi,
             "cfg": _cfg_save(plan.cfg), "bands": plan.bands,
             "provenance": plan.provenance, "ops": meta_ops}
    CheckpointManager(directory, keep=keep).save(step, arrays, extra=extra)


def load_plan(directory: str, step: int | None = None,
              device: str | torch.device | None = None) -> InferencePlan:
    """Restore an :class:`InferencePlan` that :func:`save_plan` or the
    reference package's ``save_plan`` wrote, onto ``device`` (default
    CUDA); ``step=None`` is the newest valid step."""
    extra, arr = _restore(directory, step, "jpeg_inference_plan",
                          (_PLAN_FORMAT, _PORT_FORMAT), device)
    operators: dict[str, Any] = {}
    for key, meta in extra["ops"].items():
        op = _op_load(key, meta, arr)
        if "/" in key:
            name, slot = key.split("/", 1)
            operators.setdefault(name, {})[slot] = op
        else:
            operators[key] = op
    return InferencePlan(operators, arr("head.w"), arr("head.b"),
                         _spec_from(extra["spec"]), int(extra["phi"]),
                         _cfg_load(extra["cfg"]),
                         {k: int(v) for k, v in extra["bands"].items()},
                         extra.get("provenance"))


def save_compiled_plan(cp: CompiledPlan, directory: str, step: int = 0,
                       keep: int = 3) -> None:
    """Persist a compiled schedule in the reference's compiled format 1:
    the packed buffers through the array store, the static schedule into
    ``extra``.  A restore serves the same buffers with no recompile.  Each
    fused block's ``vmem_bytes`` (the reference's TPU budget, which the
    port does not estimate) is written from ``meta["vmem"]`` where a
    reference plan brought one, else 0."""
    from repro_torch.checkpoint import CheckpointManager

    arrays = {"head.w": cp.head_w, "head.b": cp.head_b}

    def pc_save(prefix, pc):
        arrays[f"{prefix}.xi"] = pc.xi
        arrays[f"{prefix}.shift"] = pc.shift
        return {f: int(getattr(pc, f)) for f in _PC_STATIC}

    def pa_save(prefix, pa):
        arrays[f"{prefix}.cat"] = pa.cat
        arrays[f"{prefix}.recon_t"] = pa.recon_t
        return {f: int(getattr(pa, f)) for f in _PA_STATIC}

    meta = dict(cp.meta or {})
    vmem = meta.get("vmem", {})
    meta["path"] = _ref_path(meta.get("path", "reference"))
    st = cp.stem
    stem_meta = {"kind": st.kind, "cin": st.cin, "cout": st.cout,
                 "w_in": st.w_in, "w_out": st.w_out,
                 "bands_out": st.bands_out,
                 "op": _op_save("stem.op", st.op, arrays)}
    if st.kind == "packed":
        stem_meta["conv"] = pc_save("stem.conv", st.conv)
        stem_meta["asm"] = pa_save("stem.asm", st.asm)
    blocks_meta = []
    for blk in cp.blocks:
        m = {f: getattr(blk, f) for f in CompiledBlock._fields[:9]}
        m["path"] = _ref_path(blk.path)
        m["vmem_bytes"] = int(vmem.get(blk.name, 0))
        m["ops"] = {slot: _op_save(f"{blk.name}.ops.{slot}", op, arrays)
                    for slot, op in blk.ops.items()}
        for slot, save in (("conv1", pc_save), ("asm_mid", pa_save),
                           ("conv2", pc_save), ("proj", pc_save),
                           ("asm_out", pa_save)):
            if getattr(blk, slot) is not None:
                m[slot] = save(f"{blk.name}.{slot}", getattr(blk, slot))
        blocks_meta.append(m)
    extra = {"kind": "jpeg_compiled_plan", "format": _COMPILED_FORMAT,
             "spec": _spec_json(cp.spec), "phi": cp.phi,
             "cfg": _cfg_save(cp.cfg), "bands": cp.bands,
             "meta": meta, "stem": stem_meta, "blocks": blocks_meta}
    CheckpointManager(directory, keep=keep).save(step, arrays, extra=extra)


def load_compiled_plan(directory: str, step: int | None = None,
                       device: str | torch.device | None = None
                       ) -> CompiledPlan:
    """Restore a :class:`CompiledPlan` that :func:`save_compiled_plan` or
    the reference package's ``save_compiled_plan`` wrote, onto ``device``
    (default CUDA).  A reference block's ``vmem_bytes`` (a TPU budget) is
    kept in ``meta["vmem"]`` and ignored; ``meta["smem"]`` is filled in
    for fused blocks where the directory has none."""
    from repro_torch.kernels import fused_block as kfb

    extra, arr = _restore(directory, step, "jpeg_compiled_plan",
                          (_COMPILED_FORMAT, _PORT_FORMAT), device)

    def pc_load(prefix, meta):
        return tiling.PackedConv(arr(f"{prefix}.xi"), arr(f"{prefix}.shift"),
                                 **{f: int(meta[f]) for f in _PC_STATIC})

    def pa_load(prefix, meta):
        return tiling.PackedAsm(arr(f"{prefix}.cat"),
                                arr(f"{prefix}.recon_t"),
                                **{f: int(meta[f]) for f in _PA_STATIC})

    sm = extra["stem"]
    packed = sm["kind"] == "packed"
    stem = CompiledStem(
        sm["kind"], pc_load("stem.conv", sm["conv"]) if packed else None,
        pa_load("stem.asm", sm["asm"]) if packed else None,
        _op_load("stem.op", sm["op"], arr), int(sm["cin"]), int(sm["cout"]),
        int(sm["w_in"]), int(sm["w_out"]), int(sm["bands_out"]))
    meta = dict(extra.get("meta") or {})
    meta["path"] = dispatchlib.canonical_path(meta.get("path", "reference"))
    vmem = {}
    blocks = []
    for m in extra["blocks"]:
        name = m["name"]
        parts = {slot: load(f"{name}.{slot}", m[slot])
                 for slot, load in (("conv1", pc_load), ("asm_mid", pa_load),
                                    ("conv2", pc_load), ("proj", pc_load),
                                    ("asm_out", pa_load)) if slot in m}
        ops = {slot: _op_load(f"{name}.ops.{slot}", om, arr)
               for slot, om in m["ops"].items()}
        common = [m[f] for f in CompiledBlock._fields[:9]]
        common[8] = dispatchlib.canonical_path(common[8])
        blocks.append(CompiledBlock(*common, **parts, ops=ops))
        if "vmem_bytes" in m and m["kind"] == "fused":
            vmem[name] = int(m["vmem_bytes"])
    meta.setdefault("vmem", vmem)
    if extra["format"] == _PORT_FORMAT:
        # repro_torch/1 keeps no bn_scale, which the spatial lowering
        # re-derives each layer from: such a plan runs the packed GEMM
        meta["executor"] = "gemm"
    meta.setdefault("fused", [b.name for b in blocks if b.kind == "fused"])
    meta.setdefault("layers", {b.name: "factored operator" for b in blocks
                               if b.kind == "layers"})
    if "smem" not in meta:
        meta["smem"] = {b.name: kfb.fused_smem_bytes(b.asm_mid, b.asm_out,
                                                     b.proj)
                        for b in blocks if b.kind == "fused"}
    return CompiledPlan(stem, tuple(blocks), arr("head.w"), arr("head.b"),
                        _spec_from(extra["spec"]), int(extra["phi"]),
                        _cfg_load(extra["cfg"]),
                        {k: int(v) for k, v in extra["bands"].items()},
                        meta)
