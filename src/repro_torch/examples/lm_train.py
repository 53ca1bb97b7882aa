"""Train one of the reference's LM architectures (its reduced config) on
the synthetic bigram corpus: the same trainer the production mesh uses.
The port of the reference's ``examples/lm_train.py``.

    python -m repro_torch.examples.lm_train --arch mixtral-8x7b --steps 60

On the card the trainer widens heads the flash-attention kernel does not
take (``smollm-360m``'s reduced 20) to 64 (``launch.train.card_config``);
on the CPU it trains the reference's reduced config.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.examples import add_device, run
from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    add_device(ap)
    args = ap.parse_args(argv)
    flags = ["--arch", args.arch, "--reduced", "--steps", str(args.steps),
             "--batch", str(args.batch), "--seq", str(args.seq), "--lr",
             "2e-3", "--optimizer", "adamw", "--seed", "0", "--ckpt-dir",
             os.path.join(tempfile.gettempdir(), f"lm_{args.arch}"),
             "--ckpt-every", "0", "--keep", "2", "--no-resume",
             "--log-every", "10"]
    if args.device:
        flags += ["--device", args.device]
    result = train.train_loop(train.parse_args(flags))
    first, last = result["losses"][0][1], result["losses"][-1][1]
    print(f"{args.arch}: loss {first:.3f} -> {last:.3f}")
    return {"device": result["device"], "arch": args.arch,
            "head_dim": result["head_dim"], "first_loss": first,
            "last_loss": last, "steps_run": result["steps_run"],
            "wall_s": result["wall_s"], "ok": last < first}


if __name__ == "__main__":
    run(main)
