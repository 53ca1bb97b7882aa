#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, then the kernels' build
   (one ``nvcc`` per source for ``sm_90a``, all started together, linked
   into ``build/kernels/``) with its time, and each compiled kernel's
   registers, static shared memory and spills (``-Xptxas -v``); beside
   the build, on the host, the synthetic client writes its 32
   mixed-quality JFIF files once (every serving phase reads them through
   ``--jpeg-dir``) and the decode pool's cold start is timed;
2. every kernel of the serving and training paths against its plain
   PyTorch version on the card, at the paths' own shapes (full
   ``jpeg-resnet``; the serving kernels at 16 bands and batch 4, the block
   transforms at the training batch of 8: the data encode and stage 0's
   factored decode and encode; flash attention at ``smollm-360m``'s
   prefill in bf16 and fp32, ``mistral-nemo-12b``'s heads, and a window of
   256 and a non-causal S != T case, each in bf16 (the tensor-core
   kernel) and fp32 (the FFMA kernel)): error, kernel ms, plain ms, the least
   time the card could take (bound) and, where one PyTorch call computes
   the same function, that call's ms (``library_ms``, a yardstick the
   port never calls); ASM also at the served walk's s2 and s3 row counts
   and a ragged one, where it and the q50 data encode also print the
   kernel's device time from ``torch.profiler`` beside the host's time to
   issue a call;
3. the compiled server: full ``jpeg-resnet`` from the client's JPEG bytes
   at 16 bands, batch 4, decode double-buffered against the device; every
   batch's logits are held against the same plan run on the plain path;
4. the per-layer walk (``--no-compiled``), held the same way;
5. one full-width training step (batch 8, 64 bands) on the kernel path
   against the same step on the plain path, from the same weights and
   batch: the loss and every gradient tensor;
6. the trainer (``launch/train.py``'s ``train_loop``) at full width, batch
   8, four steps, a checkpoint after step 2 and at the end, and the plan
   export; then one batch served from the exported plan through the
   compiled path, held against the plain path;
7. ``serve --qos --ingest bytes``: full ``jpeg-resnet`` built at 40 bands
   (``QOS_BANDS``) into a ``--plan-dir``, the default ladder (top, 48, 32,
   24; b48 shares the top's schedule), batch 8, buckets 1, 2, 4, 8 (one
   CUDA graph a cell), 32 single-image byte requests as one burst: every
   served request's logits held against its tier's plain path, no
   capture after warmup, a replayed graph for every tier served; each
   distinct tier's bucket-1 and bucket-8 cells of the grid that served,
   replayed (no new capture) and timed against the same forward run
   eagerly, bucket 8 on served images held against the plain path; then a
   restart from the same ``--plan-dir``, 48 requests under a deadline at
   pass 1's p95 latency, and the tier policy stepping down.  Printed:
   images/s, latency percentiles, ingest and device walls and the share
   of ingest that overlapped the device (from the flight recorder), the
   ladder's device bytes, and phases 3-4 beside them.  Launches: the
   wrappers' counts (eager runs: each cell's warm-up before its capture,
   the top-tier probe) plus each cell's per-replay launches, recorded at
   its capture, times its replays;
8. LM serving, fp32: full-width ``smollm-360m`` (random weights from seed
   0) prefills 4 prompts of 2048 tokens (cache grown to 2048 + 32) and
   decodes 32 steps, on the kernel path and on the plain path, both fed
   the plain path's greedy tokens: logits and the prefill's KV cache held
   within 1e-3 of the largest |value|, top-1 agreeing wherever the plain
   path's top-2 gap exceeds twice the logit error;
9. the same in bf16 (the published dtype) from the same weights: the
   kernel path's logit error against step 8's fp32 plain path at most 1.5×
   the bf16 plain path's; prefill and decode tokens/s, 32 kernel launches
   per prefill and none per decode step, and a ``torch.profiler``
   breakdown of one prefill and one decode step;
10. ``repro_torch.launch.serve --arch smollm-360m`` at the reference's
   defaults but 8 requests (``LM_SERVE_REQUESTS``): all completed and its
   report line;
11. one ``{"kernels": [...]}`` line, with each kernel's launches in phases
   3, 4, 6, 7, 8, 9 and 10 (each path driven with the counts set to 0
   just before it and read just after), then the ``{"ok": true, ...}``
   line last.

It imports neither JAX nor the reference package, exits non-zero without
CUDA, and needs one card.
"""
import atexit
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_SRC = os.path.join(ROOT, "src")

#: published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores — the kernels use no TF32 — bf16 dense tensor cores, and HBM3
#: bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BANDS, BATCH = 16, 4
#: the synthetic client's files, made once for every serving phase
CLIENT_IMAGES = 32
#: phase 7's plan: the widest budget at which stage 0's Ξ (64 → 64
#: channels, 9 block offsets: 36,864·b² elements) fits the materialise
#: limit of 64 Mi elements, so every tier fuses s0 and runs s1b0's
#: projection through jpeg_conv; at 48 or 64 bands every conv but the
#: stem is factored, and a tier keeps a factored layer factored
QOS_BANDS = 40
#: phase 7's bursts: pass 1, and the restart under a deadline
QOS_REQUESTS, QOS_RESTART_REQUESTS = 32, 48
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
#: flash attention against its plain version: fp32 absolute (the
#: reference's own test); bf16: the kernel's error against the plain
#: version on fp32 copies at most BF16_FACTOR × the bf16 plain version's
ATTN_ATOL = 2e-4
BF16_FACTOR = 1.5
#: LM serving (smollm-360m): batch, prompt tokens, decode steps, and the
#: fp32 kernel-vs-plain bound on logits and KV cache, relative to the
#: largest |value|
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "smollm-360m", 4, 2048, 32
LM_RTOL = 1e-3
#: phase 10's requests (the reference's default is 16)
LM_SERVE_REQUESTS = 8
JPEG_KERNELS = ("fused_block", "jpeg_conv", "asm_relu", "block_dct",
                "block_idct")
KERNELS = JPEG_KERNELS + ("flash_attention",)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with seconds since the start."""
    print(f"[chip_smoke {time.perf_counter() - _T0:6.1f}s] {msg}",
          flush=True)


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


#: device kernels of csrc/, longest name first (one contains another)
DEVICE_KERNELS = ("flash_attention_tc_kernel", "flash_attention_kernel",
                  "banded_conv_kernel", "block_matmul_kernel", "asm_kernel")


def ptxas_report(text: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: registers,
    static shared memory and spills (dynamic shared memory is set at
    launch: ``conv_smem_bytes`` and the kernels' own formulas)."""
    import re

    out, name, spill = [], None, ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = next((k for k in DEVICE_KERNELS if k in mangled), mangled)
            args = re.search(base + r"I((?:L[ib]\d+E)+)E", mangled)
            targs = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
            name = base + (f"<{', '.join(targs)}>" if targs else "")
            spill = ""
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip() if ":" in line \
                else line.strip()
        elif "Used" in line and name:
            used = line.split("Used", 1)[1].strip()
            out.append(f"{name}: used {used}; {spill}")
            name = None
    return out


def split_cost(label: str, fn, kernel: str, calls: int = 50) -> None:
    """Tell a wrapper's fixed cost from its kernel's time: the kernel's
    device time a launch from a ``torch.profiler`` trace of ``calls``
    calls, the events' time a call (``cuda_ms``), and the host's time to
    issue one call (wall clock around ``calls`` calls, no synchronise
    inside)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    event_ms = cuda_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and kernel in e.key:
            total += next((v for v in (getattr(e, a, 0) for a in (
                "self_device_time_total", "device_time_total",
                "self_cuda_time_total", "cuda_time_total")) if v), 0.0)
            n += e.count
    device = f"{total / n / 1e3:.4f} ms" if n else "not measured"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    log(f"{label}: kernel device time {device} a launch ({n} launches "
        f"traced), events {event_ms:.4f} ms a call, host {host_ms:.4f} ms "
        f"to issue a call")


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_mem = flops / peak, nbytes / PEAK_BYTES
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
    from repro_torch import kernels

    return kernels.launch_counts()


def reset_counts() -> None:
    from repro_torch import kernels

    kernels.set_launch_counts({k: 0 for k in kernels.launch_counts()})


def drive(path: str, required, launches: dict, fn, replayed=None):
    """Run one path of the port with the counts set to 0 just before it,
    add its counts to ``launches`` and fail if a kernel in ``required``
    was not launched.  ``replayed(out)`` adds the launches that CUDA graph
    replays made, which the wrappers' counters do not see."""
    reset_counts()
    out = fn()
    got = counts()
    for k, v in (replayed(out) if replayed else {}).items():
        got[k] += v
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
    profile_step("training step (kernel path)", lambda: value_and_grad(
        lambda p, bt: kernel_model.loss_fn(p, bt)[0], bundle, batch))
    torch.cuda.empty_cache()


#: device kernels grouped by name, for the training step's breakdown
#: (first match wins; cuDNN's FFT engine runs complex GEMMs and FFTs)
KERNEL_GROUPS = (("flash attention kernels", ("flash_attention",)),
                 ("block transforms", ("block_matmul_kernel",)),
                 ("ASM kernel", ("asm_kernel",)),
                 ("jpeg_conv kernel", ("banded_conv_kernel",)),
                 ("cuDNN conv", ("cudnn", "implicit_gemm", "fprop", "dgrad",
                                 "wgrad", "fft", "cf32", "complex")),
                 ("cuBLAS GEMM", ("gemm", "cutlass", "nvjet", "xmma")),
                 ("elementwise, copies, reductions",
                  ("elementwise", "copy", "reduce", "vectorized")))


def profile_step(label: str, step) -> None:
    """Device time of one call of ``step`` by kernel group, from a
    ``torch.profiler`` trace, and the device's idle share of its wall;
    prints "not measured" where the trace has no device time."""
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
        log(f"{label} profile: device time not measured (the trace holds "
            f"no device events)")
        return
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, t in per_kernel.items():
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS
                  if any(k in low for k in keys)), "other")
        groups[g] += t
    log(f"{label} profile (torch.profiler): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
        f"share {max(0.0, 1 - busy / wall_us):.3f}; by group (ms, share of "
        f"busy): " + ", ".join(f"{g} {t / 1e3:.2f} ({t / busy:.3f})"
                               for g, t in groups.items()))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    for name, t in top:
        log(f"  {t / 1e3:8.3f} ms  {name[:110]}")


def train_and_serve(cfg, dev, ckpt_dir: str, launches: dict,
                    jpeg_dir: str) -> None:
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
    sargs = serve.parse_args(["--arch", "jpeg-resnet", "--ingest", "bytes",
                              "--batch",
                              str(TRAIN_BATCH), "--requests",
                              str(TRAIN_BATCH), "--max-new", "1",
                              "--jpeg-dir", jpeg_dir, "--seed", "1"])
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


def attention_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, per batch row and head."""
    import numpy as np

    qpos = np.arange(s)
    hi = np.minimum(qpos, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_checks(dev, record) -> None:
    """Phase 2, flash attention: the kernel against its plain version at
    the LM path's shapes and the mask cases; library_ms is SDPA (GQA,
    causal flag or a boolean mask for the window)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = (  # label, b, s, t, h, kvh, hd, causal, window, dtype
        ("smollm-360m prefill bf16", 4, 2048, 2048, 15, 5, 64, True, None,
         bf16),
        ("smollm-360m prefill fp32", 4, 2048, 2048, 15, 5, 64, True, None,
         fp32),
        ("mistral-nemo-12b heads bf16 (plain: chunked)", 1, 4096, 4096, 32,
         8, 128, True, None, bf16),
        ("window 256 bf16", 2, 1000, 1000, 15, 5, 64, True, 256, bf16),
        ("window 256 fp32", 2, 1000, 1000, 15, 5, 64, True, 256, fp32),
        ("not causal, S != T, bf16", 2, 300, 1000, 24, 2, 128, False, None,
         bf16),
        ("not causal, S != T, fp32", 2, 300, 1000, 24, 2, 128, False, None,
         fp32),
    )
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, b, s, t, h, kvh, hd, causal, window, dtype in cases:
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, t, kvh, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, t, kvh, hd), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window)
        got = kfa.flash_attention(q, k, v, **kw)
        exact = kfa.attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype \
                or not bool(torch.isfinite(got).all()):
            fail(f"flash_attention {label}: shape {tuple(got.shape)}, "
                 f"dtype {got.dtype} or non-finite output")
        err = float((got.float() - exact).abs().max())
        if dtype == fp32:
            tol = ATTN_ATOL
        else:
            plain = kfa.attention_plain(q, k, v, **kw).float()
            tol = BF16_FACTOR * float((plain - exact).abs().max())
            del plain
        if not err <= tol:
            fail(f"flash_attention {label}: max abs err {err:.3e} > "
                 f"tolerance {tol:.3e}")
        del got, exact
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window is not None:
            qpos = torch.arange(s, device=dev)[:, None]
            kpos = torch.arange(t, device=dev)[None, :]
            mask = (kpos > qpos - window) & (kpos <= qpos if causal
                                              else True)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        pairs = attention_pairs(s, t, causal, window)
        nbytes = q.element_size() * 2.0 * (q.numel() + k.numel())
        record("flash_attention",
               f"{label} q{tuple(q.shape)} kv{tuple(k.shape)} (tol "
               f"{tol:.2e})", err,
               cuda_ms(lambda: kfa.flash_attention(q, k, v, **kw)),
               cuda_ms(lambda: kfa.attention_plain(q, k, v, **kw), reps=3),
               (4.0 * b * h * hd * pairs, nbytes), cuda_ms(library),
               PEAK_BF16_FLOPS if dtype == bf16 else PEAK_FP32_FLOPS)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


def lm_run(model, params, prompts, feed=None) -> dict:
    """Prefill ``prompts`` (cache grown by LM_DECODE slots), then LM_DECODE
    decode steps, each fed ``feed[:, i]`` or, without ``feed``, the greedy
    token of the step before.  Returns the logits of every position (B,
    1 + LM_DECODE, V), the prefill's KV cache (copies), the tokens fed,
    wall times and flash-attention launches of each part."""
    import torch

    from repro_torch.kernels import flash_attention as kfa

    with torch.inference_mode():
        torch.cuda.synchronize()
        n0 = kfa.LAUNCHES
        t0 = time.perf_counter()
        last, cache = model.prefill(params, {"tokens": prompts},
                                    pad_to=LM_PROMPT + LM_DECODE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n1 = kfa.LAUNCHES
        kv = {n: x[:, :, :LM_PROMPT].clone()
              for n, x in cache["pos0"].items()}
        logits, fed = [last[:, 0]], []
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(LM_DECODE):
            tok = feed[:, i] if feed is not None else logits[-1].argmax(-1)
            fed.append(tok)
            step, cache = model.decode_step(params, cache,
                                            {"tokens": tok[:, None]})
            logits.append(step[:, 0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    return {"logits": torch.stack(logits, 1), "kv": kv,
            "fed": torch.stack(fed, 1), "prefill_s": t1 - t0,
            "decode_s": t3 - t2, "prefill_launches": n1 - n0,
            "decode_launches": kfa.LAUNCHES - n1}


def lm_phases(dev, card: str, launches: dict) -> None:
    """Phases 8-10: smollm-360m prefill and decode on the kernel path
    against the plain path in fp32 and in bf16, then the LM server."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model

    cfg16 = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    plain_cfg = DispatchConfig(path="reference")
    gen = torch.Generator(device=dev).manual_seed(0)
    params32 = build_model(cfg32).init_params(gen, dev)
    prompts = torch.randint(0, cfg16.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    layers = cfg16.n_layers
    shape = (f"{LM_ARCH} full width, batch {LM_BATCH}, prompt {LM_PROMPT}, "
             f"{LM_DECODE} decode steps")

    def kernel_run(phase, cfg, params, feed):
        def fn():
            out = lm_run(build_model(cfg), params, prompts, feed)
            if out["prefill_launches"] != layers \
                    or out["decode_launches"] != 0:
                fail(f"{phase}: {out['prefill_launches']} flash_attention "
                     f"launches in the prefill (want {layers}) and "
                     f"{out['decode_launches']} in {LM_DECODE} decode steps "
                     f"(want 0)")
            return out
        return drive(phase, ("flash_attention",), launches, fn)

    def max_err(a, b) -> float:
        return float((a - b).abs().max())

    # --- phase 8: fp32, kernel path against plain path --------------------
    p32 = lm_run(build_model(cfg32, dispatch=plain_cfg), params32, prompts)
    if p32["prefill_launches"] or p32["decode_launches"]:
        fail("the plain path launched the flash-attention kernel")
    k32 = kernel_run("lm fp32 (kernel path)", cfg32, params32, p32["fed"])
    want = p32["logits"]
    if not bool(torch.isfinite(k32["logits"]).all()):
        fail("lm fp32: non-finite logits on the kernel path")
    err = max_err(k32["logits"], want)
    scale = float(want.abs().max())
    if not err <= LM_RTOL * scale:
        fail(f"lm fp32: logits differ by {err:.3e} (> {LM_RTOL} × "
             f"{scale:.3e})")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = k32["logits"].argmax(-1) == want.argmax(-1)
    if not bool(agree[decided].all()):
        fail(f"lm fp32: top-1 differs at {int((~agree & decided).sum())} "
             f"positions whose top-2 gap exceeds 2 × {err:.3e}")
    kv_errs = {}
    for n in ("k", "v"):
        e, sc = max_err(k32["kv"][n], p32["kv"][n]), \
            float(p32["kv"][n].abs().max())
        if not e <= LM_RTOL * sc:
            fail(f"lm fp32: prefill cache {n} differs by {e:.3e} (> "
                 f"{LM_RTOL} × {sc:.3e})")
        kv_errs[n] = e / sc
    log(f"lm fp32, {shape} [{card}]: logits max abs err {err:.3e} of "
        f"max |logit| {scale:.3e} ({err / scale:.2e} relative); top-1 "
        f"agrees at {int(agree.sum())} of {agree.numel()} positions "
        f"({int(decided.sum())} decided by a gap > 2 × err, all agree); "
        f"prefill cache relative err k {kv_errs['k']:.2e} v "
        f"{kv_errs['v']:.2e}; kernel path prefill "
        f"{k32['prefill_s'] * 1e3:.1f} ms, decode "
        f"{k32['decode_s'] * 1e3:.1f} ms; plain path prefill "
        f"{p32['prefill_s'] * 1e3:.1f} ms, decode "
        f"{p32['decode_s'] * 1e3:.1f} ms")
    del k32["kv"], p32["kv"]

    # --- phase 9: bf16 from the same weights ------------------------------
    params16 = T.cast_params(params32, torch.bfloat16)
    del params32
    torch.cuda.empty_cache()
    p16 = lm_run(build_model(cfg16, dispatch=plain_cfg), params16, prompts,
                 p32["fed"])
    k16 = kernel_run("lm bf16 (kernel path)", cfg16, params16, p32["fed"])
    e_k, e_p = max_err(k16["logits"], want), max_err(p16["logits"], want)
    if not (bool(torch.isfinite(k16["logits"]).all())
            and e_k <= BF16_FACTOR * e_p):
        fail(f"lm bf16: kernel path's logit error {e_k:.3e} against the "
             f"fp32 plain path > {BF16_FACTOR} × the bf16 plain path's "
             f"{e_p:.3e}")
    agree16 = int((k16["logits"].argmax(-1) == want.argmax(-1)).sum())
    log(f"lm bf16, {shape} [{card}]: logit err vs the fp32 plain path "
        f"{e_k:.3e} (kernel path) vs {e_p:.3e} (bf16 plain path); top-1 "
        f"agrees with fp32 at {agree16} of {want.shape[0] * want.shape[1]}; "
        f"kernel path prefill {k16['prefill_s'] * 1e3:.1f} ms = "
        f"{LM_BATCH * LM_PROMPT / k16['prefill_s']:.0f} tokens/s, decode "
        f"{k16['decode_s'] * 1e3:.1f} ms for {LM_DECODE} steps = "
        f"{LM_BATCH * LM_DECODE / k16['decode_s']:.1f} tokens/s "
        f"({k16['decode_s'] / LM_DECODE * 1e3:.2f} ms a step); plain path "
        f"prefill {p16['prefill_s'] * 1e3:.1f} ms, decode "
        f"{p16['decode_s'] * 1e3:.1f} ms")
    del p16, k16, p32, k32, want
    model = build_model(cfg16)
    with torch.inference_mode():
        profile_step("lm bf16 prefill (kernel path)", lambda: model.prefill(
            params16, {"tokens": prompts}, pad_to=LM_PROMPT + LM_DECODE))
        _, cache = model.prefill(params16, {"tokens": prompts},
                                 pad_to=LM_PROMPT + LM_DECODE)
        tok = prompts[:, -1:]
        profile_step("lm bf16 decode step", lambda: model.decode_step(
            params16, cache, {"tokens": tok}))
    del params16, cache, model
    torch.cuda.empty_cache()

    # --- phase 10: the LM server at the reference's defaults --------------
    report = drive("serve lm", (), launches,
                   lambda: serve.main(["--arch", LM_ARCH, "--requests",
                                       str(LM_SERVE_REQUESTS)]))
    if report["completed"] != LM_SERVE_REQUESTS \
            or report["decode_tokens"] <= 0:
        fail(f"serve lm: completed {report['completed']} of "
             f"{LM_SERVE_REQUESTS}")
    log(f"serve lm ({LM_ARCH}, bf16, batch 4, ctx 256, "
        f"{LM_SERVE_REQUESTS} requests) "
        f"[{card}]: {report['decode_tokens']} decode tokens in "
        f"{report['wall_s']:.3f} s = {report['tokens_per_s']:.1f} tokens/s")
    torch.cuda.empty_cache()

def trace_overlap(path: str) -> tuple[float, float, float]:
    """Seconds of ingest decode, of device dispatch, and of their overlap
    in a flight-recorder trace (``serve --trace-out``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def union(name):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("name") == name)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    ing, dev = union("ingest-decode"), union("device-dispatch")
    both = sum(max(0.0, min(b, d) - max(a, c)) for a, b in ing
               for c, d in dev)
    return (sum(b - a for a, b in ing) / 1e6,
            sum(b - a for a, b in dev) / 1e6, both / 1e6)


def make_client(cfg, directory: str, out: dict) -> None:
    """The synthetic client's bytes, made once for every serving phase:
    ``CLIENT_IMAGES`` mixed-quality JFIF files written to ``directory``
    (the phases serve them through ``--jpeg-dir``); then the decode pool's
    cold start, timed on a batch of them.  Runs beside the kernels'
    build; ``out`` gets the timings, or the exception."""
    try:
        from repro_torch.codec import ingest as ingestlib
        from repro_torch.launch import serve

        t0 = time.perf_counter()
        make = serve.jpeg_byte_requests(TRAIN_BATCH, cfg, 0)
        datas = []
        for step in range(CLIENT_IMAGES // TRAIN_BATCH):
            datas += make(step)
        for i, d in enumerate(datas):
            with open(os.path.join(directory, f"client_{i:03d}.jpg"),
                      "wb") as f:
                f.write(d)
        out["encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = cfg.image_size // 8
        ingestlib.ingest_batch(datas[:TRAIN_BATCH], quality=50, grid=(n, n),
                               channels=cfg.in_channels, with_stats=False)
        out["pool_start_s"] = time.perf_counter() - t0
        out["workers"] = ingestlib.ingest_workers()
    except BaseException as e:  # re-raised by the main thread
        out["error"] = e


def qos_phase(cfg, dev, launches: dict, slot_reports: dict,
              jpeg_dir: str) -> None:
    """Phase 7: ``serve --qos --ingest bytes`` at full width (see the
    module docstring), two passes over one ``--plan-dir``."""
    import numpy as np
    import torch

    from repro_torch.codec import ingest as ingestlib
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib
    from repro_torch.launch import serve

    plan_dir = tempfile.mkdtemp(prefix="chip_smoke_qos_")
    grid = cfg.image_size // 8
    plain = dsp.DispatchConfig(path="reference")
    try:
        base = ["--arch", "jpeg-resnet", "--qos", "--ingest", "bytes",
                "--bands", str(QOS_BANDS), "--batch", str(TRAIN_BATCH),
                "--batch-buckets", "1,2,4,8", "--plan-dir", plan_dir,
                "--jpeg-dir", jpeg_dir, "--seed", "0"]
        served = {}

        def run(label, extra, on_served=None):
            args = serve.parse_args(base + extra)
            t0 = time.perf_counter()
            out = drive(label, JPEG_KERNELS, launches,
                        lambda: serve.serve_jpeg_resnet(
                            args, on_served=on_served),
                        replayed=lambda r: r["qos"]["graph_launches"])
            log(f"{label}: entry point took {time.perf_counter() - t0:.2f} "
                f"s (plan and ladder "
                f"{'restored' if not out['plan']['built'] else 'built'}, "
                f"{out['qos']['grid']['cells']} graphs captured in "
                f"{out['qos']['warmup_s']:.2f} s); replay launches "
                f"{out['qos']['graph_launches']}")
            return out

        def hold(ladder, reqs, grid_engine):
            # every served request against its tier's plain path, while
            # the grid's cells are alive
            served.update(ladder=ladder, grid=grid_engine)
            errs, agree, n = [], 0, 0
            tiers = {t.name: t for t in ladder.tiers}
            with torch.inference_mode():
                for name in sorted({r.tier for _, _, r in reqs}):
                    group = [(p, r) for _, p, r in reqs if r.tier == name]
                    cp = tiers[name].compiled
                    x, _ = ingestlib.ingest_batch(
                        [p for p, _ in group],
                        quality=ladder.base.spec.quality, grid=(grid, grid),
                        channels=cfg.in_channels, pack_width=cp.stem.w_in,
                        with_stats=False)
                    want = planlib.apply_compiled_packed(
                        cp, torch.as_tensor(x).to(dev), plain)
                    got = torch.as_tensor(
                        np.stack([r.result() for _, r in group])).to(dev)
                    errs.append(compare(f"qos {name} logits vs plain", got,
                                        want, LOGIT_RTOL))
                    agree += int((got.argmax(-1) == want.argmax(-1)).sum())
                    n += len(group)
            served.update(errs=errs, agree=agree, n=n,
                          x8=[p for _, p, _ in reqs[:TRAIN_BATCH]])

        trace1 = os.path.join(plan_dir, "trace1.json")
        r1 = run("serve --qos", ["--requests", str(QOS_REQUESTS),
                                 "--trace-out", trace1], on_served=hold)
        q = r1["qos"]
        if r1["completed"] != QOS_REQUESTS or q["compiles_post_warmup"] != 0:
            fail(f"qos: {r1['completed']} of {QOS_REQUESTS} served, "
                 f"{q['compiles_post_warmup']} captures after warmup")
        # a tier that shares an earlier tier's schedule replays its cells
        column = {t.name: served["ladder"].tiers[t.shared_with].name
                  if t.shared_with is not None else t.name
                  for t in served["ladder"].tiers}
        for tier in q["per_tier"]:
            if not any(k.startswith(column[tier] + "/")
                       for k in q["cell_replays"]):
                fail(f"qos: tier {tier} served with no graph replayed")
        if served["agree"] != served["n"] or served["n"] != QOS_REQUESTS:
            fail(f"qos: top-1 agreement {served['agree']}/{served['n']} "
                 f"< 1.0")
        ing_s, dev_s, both_s = trace_overlap(trace1)
        lad = q["ladder"]
        dir_bytes = sum(os.path.getsize(os.path.join(r, f))
                        for r, _, fs in os.walk(plan_dir) for f in fs)
        log(f"qos pass 1: {r1['images_per_s']:.2f} images/s over "
            f"{r1['wall_s']:.3f} s, latency {r1['latency_ms']}; ingest "
            f"{q['ingest_wall_s']:.3f} s + device {q['device_wall_s']:.3f} s "
            f"(trace: ingest {ing_s:.3f} s, device {dev_s:.3f} s, overlap "
            f"{both_s:.3f} s = {both_s / max(ing_s, 1e-9):.3f} of ingest); "
            f"batches by tier { {k: v['batches'] for k, v in q['per_tier'].items()} }, "
            f"switches {[(e['from'], e['to'], e['reason']) for e in q['tier_switches']]}; "
            f"ladder device bytes {lad['device_bytes']} (top tier alone "
            f"{lad['top_tier_bytes']}); plan directory {dir_bytes} bytes; "
            f"tiers "
            f"{[(t['name'], t['bands'], t['fused']) for t in q['tiers']]}; "
            f"logits vs each tier's plain path: max abs err "
            f"{max(served['errs']):.3e}, top-1 agreement "
            f"{served['agree'] / served['n']}")

        # each distinct tier's bucket-1 and bucket-8 cells, replayed by the
        # grid that served (no new capture): the replay against the same
        # forward run eagerly, and bucket 8 on served images held against
        # the plain path
        ladder, grid_engine = served["ladder"], served["grid"]
        with torch.inference_mode():
            for tier, col in zip(ladder.tiers, grid_engine.columns):
                if tier.shared_with is not None:
                    continue
                cp = tier.compiled
                rows, _ = ingestlib.ingest_batch(
                    served["x8"], quality=ladder.base.spec.quality,
                    grid=(grid, grid), channels=cfg.in_channels,
                    pack_width=cp.stem.w_in, with_stats=False)
                for bucket in (1, 8):
                    cell = col.cells[("bytes", bucket)]
                    x = torch.as_tensor(rows[:bucket]).to(dev)
                    if bucket == 8:
                        compare(f"{tier.name} b8 graph vs plain",
                                cell(rows).clone(),
                                planlib.apply_compiled_packed(cp, x, plain),
                                LOGIT_RTOL)
                    graph = cell.time_wall(iters=5) * 1e3
                    eager = cuda_ms(lambda: planlib.apply_compiled_packed(
                        cp, x), reps=3, warmup=1)
                    t0 = time.perf_counter()
                    for _ in range(3):
                        planlib.apply_compiled_packed(cp, x)
                    host = (time.perf_counter() - t0) / 3 * 1e3
                    torch.cuda.synchronize()
                    log(f"{tier.name} bucket {bucket}: graph replay "
                        f"{graph:.3f} ms, eager forward {eager:.3f} ms "
                        f"(host {host:.3f} ms to issue it), "
                        f"{sum(cell.graph_launches.values())} kernel "
                        f"launches a replay {cell.graph_launches}")
        del ladder, grid_engine, served["ladder"], served["grid"]
        torch.cuda.empty_cache()

        # pass 2: restart from the same --plan-dir with a longer burst
        # under a deadline at pass 1's p95 latency: the burst's tail is
        # shed, and the policy steps down (queue depth, deadline slack)
        deadline = r1["latency_ms"]["p95_ms"]
        r2 = run("serve --qos restart",
                 ["--requests", str(QOS_RESTART_REQUESTS),
                  "--deadline-ms", f"{deadline:.1f}"])
        q2 = r2["qos"]
        if r2["plan"]["built"] or not q2["ladder"]["restored"]:
            fail("qos restart: the plan or the ladder was built again")
        if not q2["tier_switches"]:
            fail(f"qos restart: no tier switch under a {deadline:.1f} ms "
                 f"deadline")
        log(f"qos pass 2 (deadline {deadline:.1f} ms): "
            f"{r2['images_per_s']:.2f} images/s, latency "
            f"{r2['latency_ms']}, completed {r2['completed']} of "
            f"{QOS_RESTART_REQUESTS}, shed {q2['deadline_shed']}, misses "
            f"{q2['deadline_misses']}; batches by tier "
            f"{ {k: v['batches'] for k, v in q2['per_tier'].items()} }; "
            f"switches {[(e['from'], e['to'], e['reason']) for e in q2['tier_switches']]}")
        for phase in ("compiled", "per-layer"):
            r = slot_reports[phase]
            log(f"beside it, phase 3-4 {phase} (16 bands, batch 4, no "
                f"graphs): {r['images_per_s']:.2f} images/s, ingest wait "
                f"{r['ingest_s']:.3f} s + forward {r['forward_s']:.3f} s")
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
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
    # the synthetic client's files and the decode pool's cold start, on
    # the host beside the build
    cfg = get_config("jpeg-resnet")
    client_dir = tempfile.mkdtemp(prefix="chip_smoke_client_")
    atexit.register(shutil.rmtree, client_dir, True)
    client: dict = {}
    maker = threading.Thread(target=make_client,
                             args=(cfg, client_dir, client))
    maker.start()
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_log()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info.get('seconds', 0.0):.2f} s, cached="
        f"{info.get('cached')}) -> {_build.BUILD_DIR}")
    for line in ptxas_report(str(info.get("ptxas", ""))):
        log(f"ptxas: {line}")
    maker.join()
    if "error" in client:
        raise client["error"]
    log(f"client: {CLIENT_IMAGES} JFIF files encoded in "
        f"{client['encode_s']:.2f} s -> {client_dir}; decode pool of "
        f"{client['workers']} workers started (first batch of "
        f"{TRAIN_BATCH}) in {client['pool_start_s']:.2f} s, beside the "
        f"build")

    # --- phase 2: kernels against their plain versions ------------------
    args = serve.parse_args(["--arch", "jpeg-resnet", "--ingest", "bytes",
                             "--bands", str(BANDS), "--batch", str(BATCH),
                             "--requests", "16", "--max-new", "2",
                             "--jpeg-dir", client_dir, "--seed", "0"])
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

    def record(name, shape, err, ms, plain_ms, work, library_ms=None,
               peak=PEAK_FP32_FLOPS):
        bms, by = bound(*work, peak)
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

        # the s2b0 projection is the served path's one jpeg_conv with 64-row
        # tiles (kernels/jpeg_conv.py tile_rows)
        for label, op, shape in (
                ("s1b0.conv1", plan.operators["s1b0"]["conv1"],
                 (BATCH, grid, grid, 64, 64)),
                ("s2b0.proj", plan.operators["s2b0"]["proj"],
                 (BATCH, grid // 2, grid // 2, 128, 64)),
                ("stem", plan.operators["stem"], (BATCH, grid, grid, 3, 64))):
            coef = torch.randn(shape, generator=gen, device=dev)
            run = (coef, op.xi, op.stride)
            kw = dict(shift=op.shift, w_out=64)
            got = kjc.jpeg_conv(*run, **kw)
            want = kjc.jpeg_conv_plain(*run, **kw)
            err = compare(f"jpeg_conv {label}", got, want, CONV_RTOL)
            ndy, ndx, cin, nf_in, cout, nf_out = op.xi.shape
            s, (n, gh, gw) = op.stride, shape[:3]
            out_rows = n * (gh // s) * (gw // s)
            work = conv_work(n * gh * gw, cin, nf_in, ndy * ndx,
                             nf_in, cout, nf_out, 64, out_rows)
            cols = tiling.conv_slices(
                coef[..., :nf_in].reshape(n, gh, gw, cin * nf_in),
                s, ndy, ndx).reshape(out_rows, -1)
            xi2 = op.xi.reshape(-1, cout * nf_out)
            record("jpeg_conv", f"{label} x{tuple(shape)}", err,
                   cuda_ms(lambda: kjc.jpeg_conv(*run, **kw)),
                   cuda_ms(lambda: kjc.jpeg_conv_plain(*run, **kw)),
                   work, cuda_ms(lambda: torch.matmul(cols, xi2)))
            del cols

        # ASM at stage 0 of the per-layer walk (16 and 64 bands), then at
        # the served walk's s2 and s3 (16 bands) and a ragged row count; at
        # the served shapes also the kernel's device time from the profiler
        # and the wrapper's host time a call
        n_rows = BATCH * grid * grid * cfg.widths[0]
        s2_rows = BATCH * (grid // 4) ** 2 * cfg.widths[2]
        s3_rows = BATCH * (grid // 8) ** 2 * cfg.widths[3]
        t = torch.randn((n_rows, 64), generator=gen, device=dev)
        for label, n, w in (("s0", n_rows, BANDS), ("s0", n_rows, 64),
                            ("s2", s2_rows, BANDS), ("s3", s3_rows, BANDS),
                            ("ragged", s2_rows + 37, BANDS)):
            x = t[:n]

            def run(x=x, w=w):
                return kasm.asm_relu(x, cfg.asm_phi, bands=w)

            got = run()
            want = kasm.asm_relu_plain(x, cfg.asm_phi, bands=w)
            err = compare(f"asm_relu {label} w={w}", got, want, ASM_RTOL)
            record("asm_relu", f"{label} w={w} rows={n}", err,
                   cuda_ms(run),
                   cuda_ms(lambda: kasm.asm_relu_plain(x, cfg.asm_phi,
                                                       bands=w)),
                   (asm_flops(n, w), 4.0 * n * (w + 64)))
            if label in ("s2", "s3"):
                split_cost(f"asm_relu {label} w={w} rows={n}", run,
                           "asm_kernel")
        del t, x, got, want

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
            if q is not None:
                split_cost(f"{name} {label} rows={n}", lambda: fn(x, q),
                           "block_matmul_kernel")
            del x, x2, got

        attention_checks(dev, record)

    # --- phases 3 and 4: the server, compiled and per-layer ---------------
    launches = {k: 0 for k in KERNELS}
    ref_cfg = dsp.DispatchConfig(path="reference", bands=BANDS)
    # at 16 bands s0b0-s1b1 fuse and s2b0-s3b1 walk per layer: factored
    # convs (block transforms), the s2b0 projection (jpeg_conv), ASM
    walks = (("compiled", True, JPEG_KERNELS),
             ("per-layer", False, ("jpeg_conv", "asm_relu", "block_dct",
                                   "block_idct")))
    slot_reports = {}
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
        slot_reports[phase] = report
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
        train_and_serve(cfg, dev, ckpt_dir, launches, client_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # --- phase 7: serve --qos, CUDA graphs over the ladder -----------------
    qos_phase(cfg, dev, launches, slot_reports, client_dir)

    # --- phases 8-10: LM serving --------------------------------------------
    lm_phases(dev, card, launches)

    kernels = []
    src = {k: "src/repro_torch/csrc/jpeg_kernels.cu" for k in KERNELS}
    src["block_dct"] = src["block_idct"] = "src/repro_torch/csrc/block_dct.cu"
    src["flash_attention"] = "src/repro_torch/csrc/flash_attention.cu"
    replaces = {"fused_block": "src/repro/kernels/fused_block.py:143",
                "jpeg_conv": "src/repro/kernels/jpeg_conv.py:112",
                "asm_relu": "src/repro/kernels/asm_relu.py:65",
                "block_dct": "src/repro/kernels/block_dct.py:37",
                "block_idct": "src/repro/kernels/block_dct.py:37",
                "flash_attention":
                    "src/repro/kernels/flash_attention.py:96"}
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
