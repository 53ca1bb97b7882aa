"""Two checkouts compared on the bf16 training and prefill paths of
``smollm-360m``.

Runs, each in a process of its own, the checkouts in the order A B B A
(a parent first and last, so drift over the call weighs on both):

* ``launch/train.py`` for ``--steps`` steps at batch 4 × 2048 (full
  depth, bf16 weights, AdamW with fp32 masters, no checkpoint until the
  final one), and the median of its step times after the first;
* one step of the trainer's step function profiled with
  ``torch.profiler`` (``chip_smoke.profile_step``): device busy time and
  each attention kernel's device ms in that step;
* CUDA-event times (``chip_smoke.cuda_ms``) of the serving prefill of
  ``chip_smoke.py`` phase 11 (bf16 weights, 4 prompts of 2048, full
  depth) and of the attention forward as
  serving calls it (``flash_attention``), as training calls it
  (``flash_attention_lse``: lse and, where the checkout's forward returns
  it, the output's bf16 rounding residual) and of its backward, at the
  model's shape: q (4, 2048, 15, 64), k and v 5 heads, causal.

    python tools/train_ab.py PARENT_DIR CHANGE_DIR [--steps 8]

Each checkout builds its own kernels into its ``build/kernels``.  Needs
one CUDA card.  Prints the card's name and power limit, every line of
each run, one JSON line a run (``{"run": ..., "dir": ..., ...}``) and a
last JSON line with each checkout's runs side by side.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, SEQ = "smollm-360m", 4, 2048
#: the attention kernels of one training step, by name
KERNELS = ("flash_attention_tc_kernel", "attn_bwd_preprocess_kernel",
           "attn_bwd_dkdv_tc_kernel", "attn_bwd_dq_tc_kernel")


def one(checkout: str, steps: int) -> dict:
    """The measurements of one checkout, in this process."""
    sys.path[:0] = [os.path.join(checkout, "src"), ROOT]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import token_iterator
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import cast_params
    from repro_torch.optim import make_optimizer, make_schedule

    dev = torch.device("cuda", 0)
    ckpt = tempfile.mkdtemp(prefix="train_ab_")
    try:
        result = train.main(["--arch", ARCH, "--seq", str(SEQ), "--batch",
                             str(BATCH), "--steps", str(steps),
                             "--ckpt-every", "0", "--log-every", "1",
                             "--ckpt-dir", ckpt, "--seed", "0"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    step_ms = [t * 1e3 for t in result["step_s"]]
    torch.cuda.empty_cache()

    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    opt = make_optimizer("adamw")
    state = opt.init(params)
    step = train.make_step(model, opt, make_schedule("cosine", 1e-3, 1,
                                                     steps), 1.0)
    batch = train.to_model_batch(cfg, next(token_iterator(
        2, BATCH, SEQ, cfg.vocab_size)), dev)
    params, state, _, _ = step(params, state, batch)  # warm-up
    _, device_us = cs.profile_step(f"{ARCH} train step",
                                   lambda: step(params, state, batch))
    kernel_ms = {k: sum(t for name, t in device_us.items() if k in name)
                 / 1e3 for k in KERNELS}
    del params, state, batch
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(4)
    params = cast_params(model.init_params(gen, dev), torch.bfloat16, dev)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)}
    with torch.inference_mode():
        prefill_ms = cs.cuda_ms(lambda: model.prefill(params, prompts),
                                reps=5)
    del params, model
    torch.cuda.empty_cache()

    q, do = (torch.randn((BATCH, SEQ, cfg.n_heads, cfg.head_dim),
                         generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((BATCH, SEQ, cfg.n_kv_heads, cfg.head_dim),
                        generator=gen, device=dev).bfloat16()
            for _ in range(2))
    out, lse, *rest = kfa.flash_attention_lse(q, k, v)
    lo = {"out_lo": rest[0]} if rest and rest[0] is not None else {}
    return {
        "dir": checkout, "step_ms": step_ms,
        "median_step_ms": statistics.median(step_ms[1:]),
        "profiled_step_busy_ms": sum(device_us.values()) / 1e3,
        "profiled_step_kernel_ms": kernel_ms,
        "serving_prefill_ms": prefill_ms,
        "attention_serving_forward_ms": cs.cuda_ms(
            lambda: kfa.flash_attention(q, k, v)),
        "attention_training_forward_ms": cs.cuda_ms(
            lambda: kfa.flash_attention_lse(q, k, v)),
        "attention_backward_ms": cs.cuda_ms(
            lambda: kfa.flash_attention_backward(q, k, v, out, do, lse,
                                                 **lo)),
        "writes_out_lo": bool(lo)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:  # in a child: args.parent is the checkout to measure
        print(json.dumps(one(os.path.abspath(args.parent), args.steps)),
              flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for i, (name, checkout) in enumerate((("parent", args.parent),
                                          ("change", args.change),
                                          ("change", args.change),
                                          ("parent", args.parent))):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), checkout, checkout,
             "--one", "--steps", str(args.steps)], capture_output=True,
            text=True, timeout=900)
        print(proc.stdout + proc.stderr[-4000:], end="", flush=True)
        if proc.returncode:
            raise SystemExit(f"run {i} ({name}) exited {proc.returncode}")
        row = {"run": i, "checkout": name,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(row), flush=True)
        runs.append(row)
    keys = ("median_step_ms", "profiled_step_busy_ms", "serving_prefill_ms",
            "attention_serving_forward_ms", "attention_training_forward_ms",
            "attention_backward_ms")
    print(json.dumps({"order": [r["checkout"] for r in runs],
                      **{k: [r[k] for r in runs] for k in keys},
                      "profiled_step_kernel_ms": [
                          r["profiled_step_kernel_ms"] for r in runs]}),
          flush=True)


if __name__ == "__main__":
    main()
