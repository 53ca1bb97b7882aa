"""Fault-tolerant training driver for ``jpeg-resnet`` and the language
models.

* data: for ``jpeg-resnet`` synthetic images JPEG-encoded on the device
  (``data.jpeg_iterator``: the block-DCT kernel on a CUDA device); for a
  language model synthetic token batches of ``--seq`` tokens
  (``data.token_iterator``, host numpy, the reference's values) moved to
  the device;
* ``jpeg-resnet``'s forward through ``core.resnet.jpeg_apply`` — the
  stem's exploded conv, every ReLU and every factored conv's block
  transforms in the hand-written kernels on a CUDA device — and the
  gradient of the whole bundle ``{"params", "bn_state"}``, as in the
  reference; a language model's next-token loss through
  ``models.transformer.loss_fn``, its attention the flash-attention kernel
  with its hand-written backward on a CUDA device (a reduced config's
  heads of a width the kernel does not take are widened to 64 there,
  :func:`card_config`);
* global-norm clipping, the optimizer (AdamW by default, fp32 master
  weights) and a warmup-cosine schedule read at the optimizer's step
  before its increment;
* auto-resume from the newest valid checkpoint (damaged ones skipped), with
  the data iterator's state inside the checkpoint; a checkpoint the
  reference's trainer wrote resumes here too (same leaf paths);
* a SIGTERM/SIGINT hook that checkpoints and exits 0;
* asynchronous checkpoint writes every ``--ckpt-every`` steps, keep-last-k;
* a straggler watchdog: steps slower than ``--straggler-factor`` × the
  step-time EWMA are logged (device steps are timed to their end; the
  report keeps each step's time and the part spent producing its batch);
* for ``jpeg-resnet``, at the end, the trained weights fused into an
  inference plan and its compiled schedule under ``<ckpt-dir>/plan``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch jpeg-resnet \\
        --reduced --device cpu --steps 4 --batch 2 --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --device cpu --seq 32 --batch 4 --steps 3

Runs on the CUDA device unless ``--device cpu`` is given; without CUDA it
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config, reduced_config
from repro_torch.data.pipeline import jpeg_iterator, token_iterator
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.models.registry import build_model, count_params, \
    jpeg_resnet_spec
from repro_torch.optim import clip_by_global_norm, make_optimizer, \
    make_schedule, value_and_grad

__all__ = ["export_plan", "build_iterator", "to_model_batch", "make_step",
           "card_config", "train_loop", "parse_args", "main"]


def export_plan(cfg, bundle, ckpt_dir: str, *, step: int = 0) -> str:
    """Fuse the bundle's weights into an ``InferencePlan`` and its compiled
    schedule under ``<ckpt_dir>/plan`` (``core.plan.load_plan`` and
    ``load_compiled_plan`` restore them)."""
    from repro_torch.core import plan as planlib

    spec = jpeg_resnet_spec(cfg)
    plan_dir = os.path.join(ckpt_dir, "plan")
    with torch.no_grad():
        plan = planlib.build_plan(bundle["params"], bundle["bn_state"], spec)
        planlib.save_plan(plan, plan_dir, step=step)
        planlib.save_compiled_plan(planlib.compile_plan(plan),
                                   os.path.join(plan_dir, "compiled"),
                                   step=step)
    print(f"[train] exported inference plan -> {plan_dir} (step {step})",
          flush=True)
    return plan_dir


def build_iterator(cfg, batch: int, seq: int, seed: int, device):
    """The training data: device-encoded JPEG coefficients for
    ``jpeg-resnet``, host token batches of ``seq`` tokens for a language
    model."""
    if cfg.family == "jpeg_resnet":
        return jpeg_iterator(seed, batch, cfg.image_size, cfg.in_channels,
                             cfg.num_classes, device=device)
    return token_iterator(seed, batch, seq, cfg.vocab_size)


def to_model_batch(cfg, host_batch: dict, device) -> dict:
    """A batch as the model takes it: every array a tensor on ``device``.
    The stubbed frontends' inputs are fp32: an audio batch gains zero
    ``frames`` (B, encoder_context_len, D), as in the reference (the
    encoder adds its positions); a VLM's batch gains ``vision_embeds``
    (B, vision_prefix_len, D), each row the sinusoidal code of its patch
    position.  The reference's are zeros: a zero row stays zero through
    every layer, each RMS norm then multiplies its gradient by
    eps^-1/2 ≈ 316, and at internvl2-1b's 24 layers that overflows fp32,
    so its gradient is NaN."""
    batch = {k: torch.as_tensor(v).to(device) for k, v in host_batch.items()}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(
            (len(batch["tokens"]), cfg.encoder_context_len, cfg.d_model),
            dtype=torch.float32, device=device)
    elif cfg.family == "vlm":
        pos = sinusoidal_positions(torch.arange(cfg.vision_prefix_len,
                                                device=device), cfg.d_model)
        batch["vision_embeds"] = pos.expand(len(batch["tokens"]), -1,
                                            -1).contiguous()
    return batch


def make_step(model, optimizer, schedule, grad_clip: float):
    """One training step ``(params, opt_state, batch) → (params, opt_state,
    loss, grad norm)``: the loss's gradient, global-norm clipping, and the
    optimizer at the schedule's rate for its step."""
    def loss_of(p, batch):
        return model.loss_fn(p, batch)[0]

    def step_fn(params, opt_state, batch):
        loss, grads = value_and_grad(loss_of, params, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = schedule(opt_state.step)
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        return params, opt_state, loss, gnorm

    return step_fn


def card_config(cfg, device: torch.device):
    """``cfg`` as :func:`train_loop` trains it on ``device``: on the card,
    attention heads of a width the flash-attention kernel does not take
    (a reduced config's, ``smollm-360m``'s 20) are widened to the
    kernel's smallest (64), so the kernel runs them; on the CPU, and for
    every full config, ``cfg`` itself."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    if device.type != "cuda" or not cfg.head_dim \
            or cfg.head_dim in HEAD_DIMS:
        return cfg
    return dataclasses.replace(cfg, head_dim=HEAD_DIMS[0])


def train_loop(args) -> dict:
    """Train as ``args`` (from :func:`parse_args`) says; returns the
    report (also written to ``--metrics-out``).  On the card the config
    passes :func:`card_config`; the report's ``head_dim`` says what
    ran."""
    device = resolve_device(args.device)
    cfg = card_config(reduced_config(args.arch) if args.reduced
                      else get_config(args.arch), device)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 1),
                     optimizer=args.optimizer, grad_clip=1.0)
    model = build_model(cfg)
    optimizer = make_optimizer(tc.optimizer, weight_decay=tc.weight_decay)
    schedule = make_schedule(tc.schedule, tc.learning_rate, tc.warmup_steps,
                             tc.total_steps)

    it = build_iterator(cfg, args.batch, args.seq, args.seed, device)
    exports_plan = cfg.family == "jpeg_resnet"
    manager = CheckpointManager(args.ckpt_dir, keep=args.keep)

    params = model.init_params(torch.Generator().manual_seed(args.seed),
                               device)
    opt_state = optimizer.init(params)
    start_step = 0
    restored = manager.restore_latest({"params": params, "opt": opt_state}) \
        if args.resume else None
    if restored is not None:
        step0, tree, extra = restored
        params, opt_state = tree["params"], tree["opt"]
        it.load_state_dict(extra["data_state"])
        start_step = step0
        print(f"[train] resumed from step {step0}", flush=True)

    step_fn = make_step(model, optimizer, schedule, tc.grad_clip)
    interrupted = {"flag": False}

    def _preempt(signum, frame):
        print(f"[train] signal {signum}: checkpoint-and-exit", flush=True)
        interrupted["flag"] = True

    old_handlers = {sig: signal.signal(sig, _preempt)
                    for sig in (signal.SIGTERM, signal.SIGINT)}

    losses, straggler_log, step_s, data_s = [], [], [], []
    ewma = None
    n_params = count_params(params)
    print(f"[train] {cfg.name} on {device}: {n_params:,} params", flush=True)
    t_loop = time.perf_counter()
    step = start_step
    saved = start_step  # the newest step already on disk
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = to_model_batch(cfg, next(it), device)
            data_s.append(time.perf_counter() - t0)
            params, opt_state, loss, gnorm = step_fn(params, opt_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            step_s.append(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                lv = float(loss)
                losses.append((step, lv))
                print(f"[train] step {step} loss {lv:.4f} "
                      f"gnorm {float(gnorm):.3f} ({dt * 1e3:.1f} ms)",
                      flush=True)
            if ewma is None:
                ewma = dt
            else:
                if dt > args.straggler_factor * ewma:
                    straggler_log.append({"step": step, "dt": dt,
                                          "ewma": ewma})
                    print(f"[train] straggler: step {step} took {dt:.2f}s "
                          f"(ewma {ewma:.2f}s)", flush=True)
                ewma = 0.9 * ewma + 0.1 * dt
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                manager.save(step + 1, {"params": params, "opt": opt_state},
                             extra={"data_state": it.state_dict()},
                             blocking=False)
                saved = step + 1
                every = args.export_plan_every
                if exports_plan and every \
                        and ((step + 1) // args.ckpt_every) % every == 0:
                    export_plan(cfg, params, args.ckpt_dir, step=step + 1)
            if interrupted["flag"]:
                break
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    manager.wait()
    final_step = step if interrupted["flag"] else step + 1
    # a step the loop just saved is not written twice
    if interrupted["flag"] or final_step != saved:
        manager.save(final_step, {"params": params, "opt": opt_state},
                     extra={"data_state": it.state_dict()})
    plan_dir = None
    if exports_plan and args.export_plan:
        plan_dir = export_plan(cfg, params, args.ckpt_dir, step=final_step)
    result = {
        "arch": cfg.name, "device": str(device),
        "steps_run": final_step - start_step, "final_step": final_step,
        "losses": losses, "step_s": step_s, "data_s": data_s,
        "stragglers": straggler_log,
        "wall_s": time.perf_counter() - t_loop,
        "interrupted": interrupted["flag"], "params": n_params,
        "plan_dir": plan_dir, "batch": args.batch,
        "head_dim": cfg.head_dim,
    }
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(result, f, indent=1)
    if interrupted["flag"]:
        sys.exit(0)
    return result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config instead of the full one")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a sequence (language models)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "sgd", "lion"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--no-resume", dest="resume", action="store_false")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--export-plan", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="jpeg-resnet: fuse the final weights into an "
                         "inference plan (+ compiled schedule) under "
                         "<ckpt-dir>/plan")
    ap.add_argument("--export-plan-every", type=int, default=0,
                    help="also export the plan at every Nth periodic "
                         "checkpoint save (0 = the final save only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    return train_loop(parse_args(argv))


if __name__ == "__main__":
    main()
