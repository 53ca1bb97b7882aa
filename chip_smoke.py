#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, then the kernels' build
   (``nvcc`` for ``sm_90a`` into ``build/kernels/``) with its time;
2. every kernel of the serving and training paths against its plain
   PyTorch version on the card, at the paths' own shapes (full
   ``jpeg-resnet``; the serving kernels at 16 bands and batch 4, the block
   transforms at the training batch of 8: the data encode and stage 0's
   factored decode and encode): error, kernel ms, plain ms, the least
   time the card could take (bound) and, where one PyTorch call computes
   the same function, that call's ms (``library_ms``, a yardstick the
   port never calls);
3. the compiled server: full ``jpeg-resnet`` from JPEG bytes (the
   synthetic mixed-quality stream) at 16 bands, batch 4; every batch's
   logits are held against the same plan run on the plain path;
4. the per-layer walk (``--no-compiled``), held the same way;
5. one full-width training step (batch 8, 64 bands) on the kernel path
   against the same step on the plain path, from the same weights and
   batch: the loss and every gradient tensor;
6. the trainer (``launch/train.py``'s ``train_loop``) at full width, batch
   8, four steps, a checkpoint after step 2 and at the end, and the plan
   export; then one batch served from the exported plan through the
   compiled path, held against the plain path;
7. one ``{"kernels": [...]}`` line, with each kernel's launches in phases
   3, 4 and 6 (each path driven with the counts set to 0 just before it
   and read just after), then the ``{"ok": true, ...}`` line last.

It imports neither JAX nor the reference package, exits non-zero without
CUDA, and needs one card.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_SRC = os.path.join(ROOT, "src")

#: published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores — the kernels use no TF32 — and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BANDS, BATCH = 16, 4
#: the training batch (the reference trainer's default)
TRAIN_BATCH = 8
#: kernel vs plain: fp32 sums in another order over up to 18,432 terms
CONV_RTOL = 1e-4
#: ASM: 64- and 128-term sums
ASM_RTOL = 2e-5
#: block DCT/IDCT: 64-term sums
BLOCK_RTOL = 1e-5
#: served logits vs the plain path, relative to the largest logit
LOGIT_RTOL = 1e-4
#: training step, kernel path vs plain path: the loss (relative), and each
#: gradient tensor by relative norm — fp32 sums in another order through
#: 20 layers, and ASM masks that may flip on pre-activations within
#: rounding of zero; a tensor may exceed TRAIN_GRAD_RTOL only within
#: TRAIN_FLOOR_FACTOR × the plain path's own change under rounding-level
#: input noise (see train_step_check)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_FLOOR_FACTOR = 10.0
KERNELS = ("fused_block", "jpeg_conv", "asm_relu", "block_dct", "block_idct")


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int = 10, trials: int = 3, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, so the host's dispatch overlaps the device's work;
    the median of ``trials`` such runs, over ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem \
        else "bytes"


def compare(name: str, got, want, rtol: float) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
             f"or non-finite output")
    err = float((got - want).abs().max())
    tol = rtol * max(1.0, float(want.abs().max()))
    if not err <= tol:
        fail(f"{name}: max abs err {err:.3e} > tolerance {tol:.3e}")
    return err


def conv_work(x_rows: int, cin: int, w_read: int, noff: int, w_in: int,
              cout: int, w_b: int, w_o: int, out_rows: int):
    """(flops, bytes) of one banded conv: the GEMM and each operand once."""
    flops = 2.0 * out_rows * noff * cin * w_in * cout * w_b
    nbytes = 4.0 * (x_rows * cin * w_read + noff * cin * w_in * cout * w_b
                    + out_rows * cout * w_o)
    return flops, nbytes


def asm_flops(pairs: int, w: int) -> float:
    return 2.0 * pairs * (w * 128 + 64 * w)


def counts() -> dict[str, int]:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import asm_relu, block_dct, fused_block, \
        jpeg_conv

    return {"fused_block": fused_block.LAUNCHES,
            "jpeg_conv": jpeg_conv.LAUNCHES, "asm_relu": asm_relu.LAUNCHES,
            **block_dct.LAUNCHES}


def reset_counts() -> None:
    from repro_torch.kernels import asm_relu, block_dct, fused_block, \
        jpeg_conv

    fused_block.LAUNCHES = jpeg_conv.LAUNCHES = asm_relu.LAUNCHES = 0
    for k in block_dct.LAUNCHES:
        block_dct.LAUNCHES[k] = 0


def drive(path: str, required, launches: dict, fn):
    """Run one path of the port with the counts set to 0 just before it,
    add its counts to ``launches`` and fail if a kernel in ``required``
    was not launched."""
    reset_counts()
    out = fn()
    got = counts()
    for k, v in got.items():
        launches[k] += v
    missing = [k for k in required if got[k] <= 0]
    if missing:
        fail(f"{path}: kernels {missing} were never launched ({got})")
    log(f"{path}: launches {got}")
    return out


def hold_logits(phase: str, seen, classes: int, plain_fn):
    """Hold every served batch's logits against ``plain_fn`` on the same
    input; returns the errors and the top-1 agreement (fails below 1.0)."""
    import torch

    errs, agree, n = [], 0, 0
    with torch.inference_mode():
        for x, lg in seen:
            ref = plain_fn(x)
            if lg.shape != (lg.shape[0], classes):
                fail(f"{phase}: logits shape {tuple(lg.shape)}")
            errs.append(compare(f"{phase} logits", lg, ref, LOGIT_RTOL))
            agree += int((lg.argmax(-1) == ref.argmax(-1)).sum())
            n += lg.shape[0]
    top1 = agree / n
    if top1 != 1.0:
        fail(f"{phase}: top-1 agreement {top1} < 1.0")
    return errs, top1


def train_step_check(cfg, dev) -> None:
    """Phase 5: one full-width step's loss and gradients, kernel path
    against plain path, from the same weights and batch.

    Every ReLU's gradient is a 0/1 mask, so a pre-activation within
    rounding of zero passes its gradient on one path and not on the other;
    a batch-norm vector's gradient sums ~500k such terms per channel with
    much cancellation.  So beside the kernel-vs-plain error the phase
    measures the plain path's own sensitivity: the same step on the batch
    times (1 + 1e-6·noise), rounding-level.  A gradient tensor fails if
    its kernel-vs-plain error exceeds both ``TRAIN_GRAD_RTOL`` and
    ``TRAIN_FLOOR_FACTOR`` times that floor."""
    import torch

    from repro_torch.core import dispatch as dsp
    from repro_torch.data.pipeline import jpeg_iterator
    from repro_torch.models.registry import build_model
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths

    kernel_model = build_model(cfg)
    plain_model = build_model(
        cfg, dispatch=dsp.DispatchConfig(path="reference"))
    bundle = kernel_model.init_params(torch.Generator().manual_seed(0), dev)
    batch = next(jpeg_iterator(0, TRAIN_BATCH, cfg.image_size,
                               cfg.in_channels, cfg.num_classes, device=dev))
    coef = batch["coefficients"]
    noise = torch.randn(coef.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    nudged = dict(batch, coefficients=coef * (1 + 1e-6 * noise))
    out = {}
    for name, model, b in (("kernel", kernel_model, batch),
                           ("plain", plain_model, batch),
                           ("plain, nudged batch", plain_model, nudged)):
        def step():
            return value_and_grad(lambda p, bt: model.loss_fn(p, bt)[0],
                                  bundle, b)
        step()  # warm-up: allocator and cuDNN's choices
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        out[name] = (float(loss), grads, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated() / 2 ** 30)
    (lk, gk, tk, mk), (lp, gp, tp, mp), (_, gq, _, _) = out.values()
    if not (abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp) and lk == lk):
        fail(f"training step: loss {lk} (kernel path) vs {lp} (plain)")

    def rel(a, b):
        nb = float(b.norm())
        return float((a - b).norm()) / nb if nb else float(a.norm())

    worst = (0.0, 0.0, "")
    worst_floor = (0.0, "")
    for (path, a), (_, b), (_, q) in zip(leaves_with_paths(gk),
                                         leaves_with_paths(gp),
                                         leaves_with_paths(gq)):
        if not bool(torch.isfinite(a).all()):
            fail(f"training step: non-finite gradient at {path}")
        err, floor = rel(a, b), rel(q, b)
        if err > max(TRAIN_GRAD_RTOL, TRAIN_FLOOR_FACTOR * floor):
            fail(f"training step: gradient at {path} differs by {err:.3e} "
                 f"relative norm (> {TRAIN_GRAD_RTOL} and > "
                 f"{TRAIN_FLOOR_FACTOR} × the plain path's own "
                 f"{floor:.3e})")
        worst = max(worst, (err, floor, path))
        worst_floor = max(worst_floor, (floor, path))
    log(f"training step, full width, batch {TRAIN_BATCH}: loss {lk:.6f} "
        f"(kernel) vs {lp:.6f} (plain); worst gradient relative-norm error "
        f"{worst[0]:.3e} at {worst[2]} (plain path's own floor there "
        f"{worst[1]:.3e}; largest floor {worst_floor[0]:.3e} at "
        f"{worst_floor[1]}); value_and_grad {tk * 1e3:.1f} ms kernel path, "
        f"{tp * 1e3:.1f} ms plain path; peak memory {mk:.2f} / {mp:.2f} GiB")
    del out, gk, gp, gq
    profile_step(lambda: value_and_grad(
        lambda p, bt: kernel_model.loss_fn(p, bt)[0], bundle, batch))
    torch.cuda.empty_cache()


#: device kernels grouped by name, for the training step's breakdown
#: (first match wins; cuDNN's FFT engine runs complex GEMMs and FFTs)
KERNEL_GROUPS = (("block transforms", ("block_matmul_kernel",)),
                 ("ASM kernel", ("asm_kernel",)),
                 ("jpeg_conv kernel", ("banded_conv_kernel",)),
                 ("cuDNN conv", ("cudnn", "implicit_gemm", "fprop", "dgrad",
                                 "wgrad", "fft", "cf32", "complex")),
                 ("cuBLAS GEMM", ("gemm", "cutlass")),
                 ("elementwise, copies, reductions",
                  ("elementwise", "copy", "reduce", "vectorized")))


def profile_step(step) -> None:
    """Device time of one training step by kernel group, from a
    ``torch.profiler`` trace, and the device's idle share of the step's
    wall; prints "not measured" where the trace has no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = next((v for v in (getattr(e, a, 0) for a in (
            "self_device_time_total", "device_time_total",
            "self_cuda_time_total", "cuda_time_total")) if v), 0.0)
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t
    busy = sum(per_kernel.values())
    if busy <= 0:
        log("training step profile: device time not measured (the trace "
            "holds no device events)")
        return
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, t in per_kernel.items():
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS
                  if any(k in low for k in keys)), "other")
        groups[g] += t
    log(f"training step profile (kernel path, torch.profiler): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
        f"share {max(0.0, 1 - busy / wall_us):.3f}; by group (ms, share of "
        f"busy): " + ", ".join(f"{g} {t / 1e3:.2f} ({t / busy:.3f})"
                               for g, t in groups.items()))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    for name, t in top:
        log(f"  {t / 1e3:8.3f} ms  {name[:110]}")


def train_and_serve(cfg, dev, ckpt_dir: str, launches: dict) -> None:
    """Phase 6: ``train_loop`` at full width, then one batch served from
    the exported plan through the compiled path."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib
    from repro_torch.launch import serve, train

    args = train.parse_args(
        ["--arch", "jpeg-resnet", "--steps", "4", "--batch",
         str(TRAIN_BATCH), "--ckpt-every", "2", "--log-every", "1",
         "--ckpt-dir", ckpt_dir, "--seed", "0"])
    result = drive("train", ("jpeg_conv", "asm_relu", "block_dct",
                             "block_idct"), launches,
                   lambda: train.train_loop(args))
    losses = [v for _, v in result["losses"]]
    if len(losses) != 4 or not all(v == v and abs(v) < 1e30
                                   for v in losses):
        fail(f"train: losses {losses}")
    steps = CheckpointManager(ckpt_dir).steps()
    if steps != [2, 4]:
        fail(f"train: checkpoints {steps}, want [2, 4]")
    step_ms = [t * 1e3 for t in result["step_s"]]
    steady = statistics.median(step_ms[1:])
    data_ms = [t * 1e3 for t in result["data_s"]]
    log(f"train: full jpeg-resnet, batch {TRAIN_BATCH}, 64 bands: step ms "
        f"{[round(t, 1) for t in step_ms]} (first includes warm-up), "
        f"median after the first {steady:.1f} ms = "
        f"{TRAIN_BATCH / steady * 1e3:.1f} images/s, of which the batch "
        f"(host synthesis, device encode) {[round(t, 1) for t in data_ms]} "
        f"ms; losses {losses}; "
        f"loop wall {result['wall_s']:.2f} s incl. checkpoints and export; "
        f"checkpoints {steps}; plan -> {result['plan_dir']}")

    plan = planlib.load_plan(result["plan_dir"], device=dev)
    cp = planlib.load_compiled_plan(
        os.path.join(result["plan_dir"], "compiled"), device=dev)
    sargs = serve.parse_args(["--arch", "jpeg-resnet", "--batch",
                              str(TRAIN_BATCH), "--requests",
                              str(TRAIN_BATCH), "--max-new", "1",
                              "--seed", "1"])
    seen = []
    info = {"bands": plan.bands, "compiled": True, "path": cp.meta["path"]}
    report = drive(
        "serve exported plan", ("asm_relu", "block_dct", "block_idct"),
        launches,
        lambda: serve.serve_jpeg_resnet(
            sargs, prepared=(plan, cp, info),
            on_batch=lambda x, lg: seen.append((x.clone(), lg.clone()))))
    ref_cfg = dsp.DispatchConfig(path="reference")
    errs, top1 = hold_logits(
        "exported plan", seen, cfg.num_classes,
        lambda x: planlib.apply_compiled_packed(cp, x, ref_cfg))
    log(f"exported plan (step {result['final_step']}): served "
        f"{report['images']} images in {report['batches']} batch, forward "
        f"{report['forward_s'] * 1e3:.1f} ms; logits vs plain path: max abs "
        f"err {max(errs):.3e}, top-1 agreement {top1}")
    del plan, cp
    torch.cuda.empty_cache()


def main() -> None:
    if not os.path.isdir(os.path.join(REPO_SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, REPO_SRC)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")

    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import _build
    from repro_torch.kernels import asm_relu as kasm
    from repro_torch.kernels import block_dct as kbd
    from repro_torch.kernels import fused_block as kfb
    from repro_torch.kernels import jpeg_conv as kjc
    from repro_torch.kernels import tiling
    from repro_torch.launch import serve, train

    dev = torch.device("cuda", 0)
    # --- phase 1: device and build -------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_log()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info.get('seconds', 0.0):.2f} s, cached="
        f"{info.get('cached')}) -> {_build.BUILD_DIR}")
    for line in str(info.get("ptxas", "")).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"ptxas: {line.strip()}")

    # --- phase 2: kernels against their plain versions ------------------
    cfg = get_config("jpeg-resnet")
    args = serve.parse_args(["--arch", "jpeg-resnet", "--ingest", "bytes",
                             "--bands", str(BANDS), "--batch", str(BATCH),
                             "--requests", "16", "--max-new", "2",
                             "--seed", "0"])
    t0 = time.perf_counter()
    plan, cp, plan_info = serve.prepare_plan(args, cfg, dev)
    torch.cuda.synchronize()
    log(f"plan built and compiled on the card in "
        f"{time.perf_counter() - t0:.2f} s: fused {cp.meta['fused']}, "
        f"per-layer {sorted(cp.meta['layers'])}, smem/CTA "
        f"{cp.meta['smem']}")
    if cp.meta["path"] != "cuda" or not cp.meta["fused"]:
        fail(f"compiled schedule does not run the kernels: {cp.meta}")
    gen = torch.Generator(device=dev).manual_seed(1)
    blocks = {b.name: b for b in cp.blocks}
    grid = cfg.image_size // 8
    rows: dict[str, dict] = {}

    def record(name, shape, err, ms, plain_ms, work, library_ms=None):
        bms, by = bound(*work)
        # the kernels line carries each kernel's first (largest) shape
        r = rows.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                   "plain_ms": plain_ms, "bound_ms": bms,
                                   "bound_by": by, "library_ms": library_ms,
                                   "shape": shape})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        lib = f"{library_ms:.4f}" if library_ms is not None else "null"
        log(f"{name} @ {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bms:.4f} ms ({by})  "
            f"library_ms {lib}")

    with torch.inference_mode():
        for name in ("s0b0", "s1b0"):
            blk = blocks[name]
            x = torch.randn((BATCH, grid, grid, blk.cin * blk.w_in),
                            generator=gen, device=dev)
            ops = (x, blk.conv1, blk.asm_mid, blk.conv2, blk.asm_out,
                   blk.proj)
            got = kfb.fused_block(*ops)
            want = kfb.fused_block_reference(*ops)
            err = compare(f"fused_block {name}", got, want, CONV_RTOL)
            out_rows = BATCH * (grid // blk.conv1.stride) ** 2
            convs = [pc for pc in (blk.conv1, blk.conv2, blk.proj) if pc]
            flops = sum(2.0 * out_rows * pc.xi.numel() for pc in convs)
            nbytes = 4.0 * (x.numel() + got.numel()
                            + sum(pc.xi.numel() for pc in convs))
            flops += asm_flops(out_rows * blk.cout, blk.asm_mid.w)
            flops += asm_flops(out_rows * blk.cout, blk.asm_out.w)
            record("fused_block", f"{name} x{tuple(x.shape)}", err,
                   cuda_ms(lambda: kfb.fused_block(*ops)),
                   cuda_ms(lambda: kfb.fused_block_reference(*ops)),
                   (flops, nbytes))

        for label, op, shape in (
                ("s1b0.conv1", plan.operators["s1b0"]["conv1"],
                 (BATCH, grid, grid, 64, 64)),
                ("stem", plan.operators["stem"], (BATCH, grid, grid, 3, 64))):
            coef = torch.randn(shape, generator=gen, device=dev)
            run = (coef, op.xi, op.stride)
            kw = dict(shift=op.shift, w_out=64)
            got = kjc.jpeg_conv(*run, **kw)
            want = kjc.jpeg_conv_plain(*run, **kw)
            err = compare(f"jpeg_conv {label}", got, want, CONV_RTOL)
            ndy, ndx, cin, nf_in, cout, nf_out = op.xi.shape
            s = op.stride
            out_rows = BATCH * (grid // s) ** 2
            work = conv_work(BATCH * grid * grid, cin, nf_in, ndy * ndx,
                             nf_in, cout, nf_out, 64, out_rows)
            cols = tiling.conv_slices(
                coef[..., :nf_in].reshape(BATCH, grid, grid, cin * nf_in),
                s, ndy, ndx).reshape(out_rows, -1)
            xi2 = op.xi.reshape(-1, cout * nf_out)
            record("jpeg_conv", f"{label} x{tuple(shape)}", err,
                   cuda_ms(lambda: kjc.jpeg_conv(*run, **kw)),
                   cuda_ms(lambda: kjc.jpeg_conv_plain(*run, **kw)),
                   work, cuda_ms(lambda: torch.matmul(cols, xi2)))
            del cols

        n_rows = BATCH * grid * grid * 64  # stage 0 of the per-layer walk
        t = torch.randn((n_rows, 64), generator=gen, device=dev)
        for w in (BANDS, 64):
            got = kasm.asm_relu(t, cfg.asm_phi, bands=w)
            want = kasm.asm_relu_plain(t, cfg.asm_phi, bands=w)
            err = compare(f"asm_relu w={w}", got, want, ASM_RTOL)
            record("asm_relu", f"w={w} rows={n_rows}", err,
                   cuda_ms(lambda: kasm.asm_relu(t, cfg.asm_phi, bands=w)),
                   cuda_ms(lambda: kasm.asm_relu_plain(t, cfg.asm_phi,
                                                       bands=w)),
                   (asm_flops(n_rows, w), 4.0 * n_rows * (w + 64)))
        del t

        # block transforms at the training path's shapes: stage 0's
        # factored encode and decode (batch 8, 64 channels of 32×32 blocks)
        # and the data encode (batch 8, 3 channels, quality 50)
        s0_rows = TRAIN_BATCH * grid * grid * cfg.widths[0]
        data_rows = TRAIN_BATCH * grid * grid * cfg.in_channels
        for name, label, n, q in (
                ("block_dct", "s0 factored encode", s0_rows, None),
                ("block_idct", "s0 factored decode", s0_rows, None),
                ("block_dct", "data encode q50", data_rows, 50)):
            fn = getattr(kbd, name)
            plain = getattr(kbd, name + "_plain")
            shape = (n, 8, 8) if name == "block_dct" else (n, 64)
            x = torch.randn(shape, generator=gen, device=dev)
            got = fn(x, q)
            err = compare(f"{name} {label}", got, plain(x, q), BLOCK_RTOL)
            x2, op = x.reshape(n, 64), kbd.operator(name, q, x)
            record(name, f"{label} rows={n}", err,
                   cuda_ms(lambda: fn(x, q)), cuda_ms(lambda: plain(x, q)),
                   (2.0 * n * 64 * 64, 4.0 * (2 * n * 64 + 64 * 64)),
                   cuda_ms(lambda: torch.matmul(x2, op)))
            del x, x2, got

    # --- phases 3 and 4: the server, compiled and per-layer ---------------
    launches = {k: 0 for k in KERNELS}
    ref_cfg = dsp.DispatchConfig(path="reference", bands=BANDS)
    # at 16 bands s0b0-s1b1 fuse and s2b0-s3b1 walk per layer: factored
    # convs (block transforms), the s2b0 projection (jpeg_conv), ASM
    walks = (("compiled", True, KERNELS),
             ("per-layer", False, ("jpeg_conv", "asm_relu", "block_dct",
                                   "block_idct")))
    for phase, compiled, required in walks:
        seen = []
        args.compiled = compiled
        prepared = (plan, cp if compiled else None,
                    dict(plan_info, compiled=compiled))
        report = drive(
            f"serve {phase}", required, launches,
            lambda: serve.serve_jpeg_resnet(
                args, prepared=prepared,
                on_batch=lambda x, lg: seen.append((x.clone(), lg.clone()))))
        if report["completed"] != args.requests or not seen:
            fail(f"{phase}: served {report['completed']} of {args.requests}")
        errs, top1 = hold_logits(
            phase, seen, cfg.num_classes,
            lambda x: (planlib.apply_compiled_packed(cp, x, ref_cfg)
                       if compiled else planlib.apply_plan(plan, x, ref_cfg)))
        log(f"{phase}: {report['images_per_s']:.2f} images/s (host ingest "
            f"{report['ingest_s']:.3f} s + forward {report['forward_s']:.3f} "
            f"s), latency {report['latency_ms']}, logits vs plain "
            f"path: max abs err {max(errs):.3e}, top-1 agreement {top1}")
    del plan, cp
    torch.cuda.empty_cache()

    # --- phase 5: one training step, kernel path against plain path -------
    train_step_check(cfg, dev)

    # --- phase 6: the trainer, then serving from its exported plan ---------
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train_and_serve(cfg, dev, ckpt_dir, launches)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    kernels = []
    src = {k: "src/repro_torch/csrc/jpeg_kernels.cu" for k in KERNELS}
    src["block_dct"] = src["block_idct"] = "src/repro_torch/csrc/block_dct.cu"
    replaces = {"fused_block": "src/repro/kernels/fused_block.py:143",
                "jpeg_conv": "src/repro/kernels/jpeg_conv.py:112",
                "asm_relu": "src/repro/kernels/asm_relu.py:65",
                "block_dct": "src/repro/kernels/block_dct.py:37",
                "block_idct": "src/repro/kernels/block_dct.py:37"}
    for name in KERNELS:
        r = rows[name]
        if launches[name] <= 0:
            fail(f"{name} was never launched on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": src[name],
                        "replaces": replaces[name],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
