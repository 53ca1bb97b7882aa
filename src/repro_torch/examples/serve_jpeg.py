"""Batched JPEG-classification service (the paper's deployment story):
clients ship entropy-decoded JPEG coefficients; the service never
decompresses and never re-explodes: serving is plan-backed.  The first run
builds an ``InferencePlan`` (batch norm fused into the Ξ operators,
per-layer bands autotuned from the quantization table and a probe batch),
and with ``--plan-dir`` saves it; later runs restore the saved plan and
skip conversion.  The port of the reference's ``examples/serve_jpeg.py``.

    python -m repro_torch.examples.serve_jpeg [--device cpu]
    python -m repro_torch.examples.serve_jpeg --plan-dir /tmp/jpeg_plan
"""
from __future__ import annotations

import argparse

from repro_torch.examples import add_device, run
from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-images", type=int, default=4,
                    help="max images per request (random budget per slot)")
    ap.add_argument("--plan-dir", default=None,
                    help="where the serving plan is saved/restored "
                         "(default: built in-process, not saved)")
    add_device(ap)
    args = ap.parse_args(argv)
    flags = ["--arch", "jpeg-resnet", "--reduced", "--batch",
             str(args.batch), "--requests", str(args.requests),
             "--max-new", str(args.max_images), "--seed", "0",
             "--autotune-bands"]
    if args.plan_dir:
        flags += ["--plan-dir", args.plan_dir]
    if args.device:
        flags += ["--device", args.device]
    out = serve.serve_jpeg_resnet(serve.parse_args(flags))
    plan = out["plan"]
    how = ("compiled fused-block schedule" if plan["compiled"]
           else "per-layer plan walk")
    bands = sorted(set(plan["bands"].values()))
    print(f"served {out['images']} images / {out['completed']} requests at "
          f"{out['images_per_s']:.1f} img/s from "
          f"{'freshly built' if plan['built'] else 'restored'} plan in "
          f"{plan['dir']} via the {how} (bands: {bands})")
    return {"device": out["device"], "images": out["images"],
            "completed": out["completed"],
            "images_per_s": out["images_per_s"], "built": plan["built"],
            "plan_dir": plan["dir"], "compiled": plan["compiled"],
            "bands": bands, "ok": out["completed"] == args.requests}


if __name__ == "__main__":
    run(main)
