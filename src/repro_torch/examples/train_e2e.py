"""End to end: train the paper's JPEG-domain ResNet on the
synthetic corpus, with checkpointing and resume.

The port's full training path (fault-tolerant trainer, checkpoint
manager, data pipeline) pointed at the paper's own architecture; a second
run with the same ``--ckpt-dir`` resumes from its last checkpoint.  The
port of the reference's ``examples/train_e2e.py``.

    python -m repro_torch.examples.train_e2e [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.examples import add_device, run
from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "jpeg_resnet_e2e"))
    add_device(ap)
    args = ap.parse_args(argv)
    flags = ["--arch", "jpeg-resnet", "--reduced", "--steps",
             str(args.steps), "--batch", str(args.batch), "--seq", "0",
             "--lr", "3e-3", "--optimizer", "adamw", "--seed", "0",
             "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50", "--keep",
             "3", "--resume", "--log-every", "20"]
    if args.device:
        flags += ["--device", args.device]
    result = train.train_loop(train.parse_args(flags))
    losses = result["losses"]
    first = losses[0][1] if losses else float("nan")
    last = losses[-1][1] if losses else float("nan")
    resumed = result["final_step"] - result["steps_run"]
    print(f"loss {first:.3f} -> {last:.3f} over {result['steps_run']} steps "
          f"({result['wall_s']:.0f}s); resumed from step {resumed}; "
          f"stragglers logged: {len(result['stragglers'])}")
    ok = last < first
    if not ok:
        print("loss did not improve")
    return {"device": result["device"], "first_loss": first,
            "last_loss": last, "steps_run": result["steps_run"],
            "resumed_from": resumed, "final_step": result["final_step"],
            "wall_s": result["wall_s"], "plan_dir": result["plan_dir"],
            "ok": ok}


if __name__ == "__main__":
    run(main)
