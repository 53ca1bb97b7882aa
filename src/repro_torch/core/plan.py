"""Convert-once inference: the plan and its compiled schedule.

:func:`build_plan` folds every inference batch norm into the adjacent
conv's Ξ (scale into the output-channel axis, β/μ as a DC shift), explodes
each conv once at its band count and resolves its apply path;
:func:`apply_plan` walks the plan layer by layer (matmuls and ASM only).

:func:`compile_plan` lowers a plan into a static schedule: a packed stem,
then per residual block either one **fused** step over tile-packed banded
operators (``kernels.tiling``; the CUDA kernels of ``kernels.fused_block``
on the ``cuda`` path) or the per-layer walk for blocks with a factored
operator, then a head that reads the DC lanes.  Activations between steps
stay in the packed ``(N, bh, bw, C·w)`` layout.  Unlike the reference
package, which demotes blocks whose operands do not fit a TPU core's VMEM,
every materialised block is fused here: the kernels stream Ξ from device
memory, so ``meta["smem"]`` records each fused block's per-CTA shared
memory instead.

:func:`save_plan`/:func:`load_plan` and :func:`save_compiled_plan`/
:func:`load_compiled_plan` store both through the checkpoint manager
(arrays in the checksummed store, the static structure in the manifest's
``extra``); a restored plan gives bit-identical logits.  The format is
the port's own: reading plan directories written by the reference
package is later work.
"""
from __future__ import annotations

import dataclasses
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

__all__ = ["operator_keys", "build_operators", "InferencePlan", "build_plan",
           "apply_plan", "CompiledStem", "CompiledBlock", "CompiledPlan",
           "compile_plan", "apply_compiled", "apply_compiled_packed",
           "save_plan", "load_plan", "save_compiled_plan",
           "load_compiled_plan"]


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

    def pc(key, kernel, stride, **kw):
        scale, shift = folds.get(key, (None, None))
        return dispatchlib.precompute_conv(
            kernel, stride, bands=_resolve_bands(bands, key, cfg),
            scale=scale, shift=shift, cfg=cfg, **kw)

    ops: dict[str, Any] = {"stem": pc("stem", params["stem"]["kernel"], 1,
                                      in_scaled=True, quality=spec.quality)}
    for name, s, cin, w in resnetlib._stages(spec):
        blk = params[name]
        entry = {"conv1": pc(f"{name}/conv1", blk["conv1"], s),
                 "conv2": pc(f"{name}/conv2", blk["conv2"], 1)}
        if "proj" in blk:
            entry["proj"] = pc(f"{name}/proj", blk["proj"], s)
        ops[name] = entry
    return ops


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

    @property
    def device(self) -> torch.device:
        return self.head_w.device


def build_plan(params: Any, state: Any, spec: resnetlib.ResNetSpec, *,
               phi: int | None = None,
               dispatch: dispatchlib.DispatchConfig | None = None,
               bands: Any = None, eps: float = 1e-5) -> InferencePlan:
    """Fuse batch norm and explode the model, on the parameters' device.

    ``bands``: None → ``dispatch.bands`` for every layer; an int or a
    per-key dict → explicit assignment.
    """
    phi = spec.phi if phi is None else phi
    cfg = dispatch or dispatchlib.DispatchConfig()
    folds = _fold_all(params, state, spec, eps=eps)
    ops = build_operators(params, spec, cfg, folds=folds, bands=bands)
    resolved = {k: _resolve_bands(bands, k, cfg)
                for k in operator_keys(params, spec)}
    return InferencePlan(ops, params["head"]["w"], params["head"]["b"],
                         spec, phi, cfg, resolved)


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


def _apply_stem(stem: CompiledStem, coef: torch.Tensor, phi: int,
                cfg: dispatchlib.DispatchConfig) -> torch.Tensor:
    """Stem from ``(N, bh, bw, C, 64)`` coefficients → packed activation."""
    n, bh, bw = coef.shape[:3]
    if stem.kind == "packed":
        h = coef[..., : stem.w_in].reshape(n, bh, bw, stem.cin * stem.w_in)
        return _packed_stem(stem, h)
    h = dispatchlib.apply_conv(coef, stem.op, cfg=cfg)
    h = dispatchlib.asm_relu(h, phi, cfg=cfg, bands=stem.bands_out)
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


def _block_steps(cp: CompiledPlan, cfg: dispatchlib.DispatchConfig):
    """The post-stem schedule as ``(name, fn)`` steps: one per residual
    block, then the DC-read head."""

    def block_fn(blk, w_prev):
        def fn(h):
            if blk.w_in != w_prev:
                h = tiling.fit_width(h, blk.cin, blk.w_in)
            if blk.kind == "fused":
                return dispatchlib.fused_block(h, blk, path=blk.path,
                                               cfg=cfg)
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


def _run_blocks(cp: CompiledPlan, h: torch.Tensor,
                cfg: dispatchlib.DispatchConfig) -> torch.Tensor:
    for _name, fn in _block_steps(cp, cfg):
        h = fn(h)
    return h


def apply_compiled(cp: CompiledPlan, coef: torch.Tensor,
                   cfg: dispatchlib.DispatchConfig | None = None
                   ) -> torch.Tensor:
    """Run the schedule on ``(N, bh, bw, C, 64)`` coefficients."""
    cfg = cp.cfg if cfg is None else cfg
    return _run_blocks(cp, _apply_stem(cp.stem, coef, cp.phi, cfg), cfg)


def apply_compiled_packed(cp: CompiledPlan, packed: torch.Tensor,
                          cfg: dispatchlib.DispatchConfig | None = None
                          ) -> torch.Tensor:
    """Run the schedule on the tile-packed stem input ``(N, bh, bw,
    Cin·stem.w_in)`` (``codec.ingest_batch(pack_width=cp.stem.w_in)``)."""
    cfg = cp.cfg if cfg is None else cfg
    st = cp.stem
    n, bh, bw, k = packed.shape
    if k != st.cin * st.w_in:
        raise ValueError(
            f"packed input has per-channel width {k / st.cin:g}, "
            f"stem expects w_in={st.w_in} (cin={st.cin})")
    if st.kind == "packed":
        h = _packed_stem(st, packed)
    else:
        coef = pad_bands(packed.reshape(n, bh, bw, st.cin, st.w_in))
        h = _apply_stem(st, coef, cp.phi, cfg)
    return _run_blocks(cp, h, cfg)


# --------------------------------------------------------------------------
# Serialization through the checkpoint manager
# --------------------------------------------------------------------------

_OP_ARRAYS = ("xi", "kernel", "scale", "shift")
_OP_STATIC = ("stride", "bands", "quality", "in_scaled", "out_scaled", "path")
_PC_STATIC = ("stride", "ndy", "ndx", "cin", "w_in", "cout", "w_out")
_PA_STATIC = ("w", "bands", "phi")
_PLAN_FORMAT = "repro_torch/1"
_COMPILED_FORMAT = "repro_torch/1"


def _leaf_path(key: str) -> str:
    """The path the checkpoint manager records for flat-dict key ``key``."""
    return f"[{key!r}]"


def _op_save(key: str, op: dispatchlib.ConvOperator,
             arrays: dict[str, torch.Tensor]) -> dict[str, Any]:
    meta: dict[str, Any] = {f: getattr(op, f) for f in _OP_STATIC}
    for f in _OP_ARRAYS:
        val = getattr(op, f)
        meta[f"has_{f}"] = val is not None
        if val is not None:
            arrays[f"{key}.{f}"] = val
    return meta


def _op_load(key: str, meta: dict[str, Any],
             arr) -> dispatchlib.ConvOperator:
    fields = {f: meta[f] for f in _OP_STATIC}
    for f in _OP_ARRAYS:
        fields[f] = arr(f"{key}.{f}") if meta[f"has_{f}"] else None
    return dispatchlib.ConvOperator(**fields)


def _spec_json(spec: resnetlib.ResNetSpec) -> dict[str, Any]:
    return dict(spec._asdict(), widths=list(spec.widths))


def _spec_from(d: dict[str, Any]) -> resnetlib.ResNetSpec:
    return resnetlib.ResNetSpec(**dict(d, widths=tuple(d["widths"])))


def _restore(directory: str, step: int | None, kind: str, fmt: str,
             device) -> tuple[dict[str, Any], Any]:
    from repro_torch.checkpoint import CheckpointManager

    dev = resolve_device(device)
    _, by_path, extra = CheckpointManager(directory).restore_tree(step)
    if extra.get("kind") != kind:
        raise ValueError(f"{directory} does not hold a {kind}")
    if extra.get("format") != fmt:
        raise ValueError(f"unsupported {kind} format "
                         f"{extra.get('format')!r} (want {fmt!r})")

    def arr(key):
        return torch.as_tensor(np.asarray(by_path[_leaf_path(key)])).to(dev)

    return extra, arr


def save_plan(plan: InferencePlan, directory: str, step: int = 0,
              keep: int = 3) -> None:
    """Persist a plan: its arrays through the checksummed, atomic store,
    its static structure in the manifest's ``extra``."""
    from repro_torch.checkpoint import CheckpointManager

    arrays = {"head.w": plan.head_w, "head.b": plan.head_b}
    meta_ops = {}
    for name, entry in plan.operators.items():
        ops = entry.items() if isinstance(entry, dict) else [(None, entry)]
        for slot, op in ops:
            key = name if slot is None else f"{name}/{slot}"
            meta_ops[key] = _op_save(key, op, arrays)
    extra = {"kind": "jpeg_inference_plan", "format": _PLAN_FORMAT,
             "spec": _spec_json(plan.spec), "phi": plan.phi,
             "cfg": dataclasses.asdict(plan.cfg), "bands": plan.bands,
             "ops": meta_ops}
    CheckpointManager(directory, keep=keep).save(step, arrays, extra=extra)


def load_plan(directory: str, step: int | None = None,
              device: str | torch.device | None = None) -> InferencePlan:
    """Restore an :class:`InferencePlan` saved by :func:`save_plan` onto
    ``device`` (default CUDA); ``step=None`` is the newest valid step."""
    extra, arr = _restore(directory, step, "jpeg_inference_plan",
                          _PLAN_FORMAT, device)
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
                         dispatchlib.DispatchConfig(**extra["cfg"]),
                         {k: int(v) for k, v in extra["bands"].items()})


def save_compiled_plan(cp: CompiledPlan, directory: str, step: int = 0,
                       keep: int = 3) -> None:
    """Persist a compiled schedule: the packed buffers through the array
    store, the static schedule into ``extra``.  A restore serves the same
    buffers with no recompile."""
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
             "cfg": dataclasses.asdict(cp.cfg), "bands": cp.bands,
             "meta": cp.meta, "stem": stem_meta, "blocks": blocks_meta}
    CheckpointManager(directory, keep=keep).save(step, arrays, extra=extra)


def load_compiled_plan(directory: str, step: int | None = None,
                       device: str | torch.device | None = None
                       ) -> CompiledPlan:
    """Restore a :class:`CompiledPlan` saved by :func:`save_compiled_plan`
    onto ``device`` (default CUDA)."""
    extra, arr = _restore(directory, step, "jpeg_compiled_plan",
                          _COMPILED_FORMAT, device)

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
    blocks = []
    for m in extra["blocks"]:
        name = m["name"]
        parts = {slot: load(f"{name}.{slot}", m[slot])
                 for slot, load in (("conv1", pc_load), ("asm_mid", pa_load),
                                    ("conv2", pc_load), ("proj", pc_load),
                                    ("asm_out", pa_load)) if slot in m}
        ops = {slot: _op_load(f"{name}.ops.{slot}", om, arr)
               for slot, om in m["ops"].items()}
        blocks.append(CompiledBlock(
            *(m[f] for f in CompiledBlock._fields[:9]), **parts, ops=ops))
    return CompiledPlan(stem, tuple(blocks), arr("head.w"), arr("head.b"),
                        _spec_from(extra["spec"]), int(extra["phi"]),
                        dispatchlib.DispatchConfig(**extra["cfg"]),
                        {k: int(v) for k, v in extra["bands"].items()},
                        extra["meta"])
