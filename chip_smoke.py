#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, then the kernels' build
   (``nvcc`` for ``sm_90a`` into ``build/kernels/``) with its time;
2. every kernel of the serving path against its plain PyTorch version on
   the card, at the path's own shapes (full ``jpeg-resnet`` at 16 bands,
   batch 4): error, kernel ms, plain ms, the least time the card could
   take (bound) and, where one PyTorch call computes the same product,
   that call's ms (``library_ms``, a yardstick the port never calls);
3. the compiled server: full ``jpeg-resnet`` from JPEG bytes (the
   synthetic mixed-quality stream) at 16 bands, batch 4; every batch's
   logits are held against the same plan run on the plain path;
4. the per-layer walk (``--no-compiled``), held the same way;
5. one ``{"kernels": [...]}`` line, with each kernel's launches in phases
   3 and 4, then the ``{"ok": true, ...}`` line last.

It imports neither JAX nor the reference package, exits non-zero without
CUDA, and needs one card.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_SRC = os.path.join(ROOT, "src")

#: published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores — the kernels use no TF32 — and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BANDS, BATCH = 16, 4
#: kernel vs plain: fp32 sums in another order over up to 18,432 terms
CONV_RTOL = 1e-4
#: ASM: 64- and 128-term sums
ASM_RTOL = 2e-5
#: served logits vs the plain path, relative to the largest logit
LOGIT_RTOL = 1e-4


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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
    from repro_torch.kernels import fused_block as kfb
    from repro_torch.kernels import jpeg_conv as kjc
    from repro_torch.kernels import tiling
    from repro_torch.launch import serve

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

    # --- phases 3 and 4: the server, compiled and per-layer ---------------
    counters = (kfb, kjc, kasm)
    launches = {m.__name__.rsplit(".", 1)[1]: 0 for m in counters}
    ref_cfg = dsp.DispatchConfig(path="reference", bands=BANDS)
    for phase, compiled in (("compiled", True), ("per-layer", False)):
        seen = []
        args.compiled = compiled
        prepared = (plan, cp if compiled else None,
                    dict(plan_info, compiled=compiled))
        for m in counters:
            m.LAUNCHES = 0
        report = serve.serve_jpeg_resnet(
            args, prepared=prepared,
            on_batch=lambda x, lg: seen.append((x.clone(), lg.clone())))
        counts = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
                  for m in counters}
        for k, v in counts.items():
            launches[k] += v
        if report["completed"] != args.requests or not seen:
            fail(f"{phase}: served {report['completed']} of {args.requests}")
        errs, agree, n = [], 0, 0
        with torch.inference_mode():
            for x, lg in seen:
                if compiled:
                    ref = planlib.apply_compiled_packed(cp, x, ref_cfg)
                else:
                    ref = planlib.apply_plan(plan, x, ref_cfg)
                if lg.shape != (BATCH, cfg.num_classes):
                    fail(f"{phase}: logits shape {tuple(lg.shape)}")
                errs.append(compare(f"{phase} logits", lg, ref, LOGIT_RTOL))
                agree += int((lg.argmax(-1) == ref.argmax(-1)).sum())
                n += lg.shape[0]
        top1 = agree / n
        log(f"{phase}: {report['images_per_s']:.2f} images/s (host ingest "
            f"{report['ingest_s']:.3f} s + forward {report['forward_s']:.3f} "
            f"s), latency {report['latency_ms']}, launches {counts}, "
            f"logits vs plain "
            f"path: max abs err {max(errs):.3e}, top-1 agreement {top1}")
        if top1 != 1.0:
            fail(f"{phase}: top-1 agreement {top1} < 1.0")

    kernels = []
    src = "src/repro_torch/csrc/jpeg_kernels.cu"
    replaces = {"fused_block": "src/repro/kernels/fused_block.py:143",
                "jpeg_conv": "src/repro/kernels/jpeg_conv.py:112",
                "asm_relu": "src/repro/kernels/asm_relu.py:65"}
    for name in ("fused_block", "jpeg_conv", "asm_relu"):
        r = rows[name]
        if launches[name] <= 0:
            fail(f"{name} was never launched on the serving path")
        kernels.append({"name": name, "route": "cuda", "source": src,
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
