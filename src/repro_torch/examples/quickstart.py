"""Quickstart: residual-network inference directly on JPEG coefficients.

Builds the paper's small ResNet (Fig. 3), evaluates it in the spatial
domain, converts it with one call, and runs the converted network on
step-4 JPEG coefficients: the same logits, no decompression.  The port of
the reference's ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import convert, jpeg, resnet
from repro_torch.data.synthetic import image_batch
from repro_torch.examples import add_device, run

#: the reference's check: JPEG-domain logits within this of the spatial
ATOL = 1e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    spec = resnet.ResNetSpec(widths=(16, 32, 64), num_classes=10)
    params, state = resnet.init_resnet(torch.Generator().manual_seed(0),
                                       spec, device=device)
    batch = image_batch(seed=0, index=0, batch=8, size=32)
    images = torch.as_tensor(batch["images"], device=device)  # (8, 3, 32, 32)

    # --- spatial-domain network (the source model) -------------------------
    with torch.inference_mode():
        logits_spatial, _ = resnet.spatial_apply(params, state, images,
                                                 training=False, spec=spec)

    # --- model conversion (paper §4.6): one call, exact --------------------
    model, deviation = convert.convert_and_verify(params, state, spec, images)
    print(f"conversion verified: max logit deviation = {deviation:.2e}")

    # --- JPEG-domain inference: consume step-4 coefficients ----------------
    with torch.inference_mode():
        coef = jpeg.jpeg_encode(images, quality=spec.quality, scaled=True)
        coef = coef.movedim(1, 3)  # (N, bh, bw, C, 64)
        logits_jpeg = model(coef)

    spatial = logits_spatial.argmax(-1).tolist()
    jpeg_top1 = logits_jpeg.argmax(-1).tolist()
    diff = float((logits_spatial - logits_jpeg).abs().max())
    print("spatial predictions:", spatial)
    print("jpeg    predictions:", jpeg_top1)
    ok = diff <= ATOL and spatial == jpeg_top1
    print("OK — the JPEG-domain network is the spatial network." if ok else
          f"FAILED — logits differ by {diff:.2e} (limit {ATOL:.0e}) or "
          "top-1 differs")
    return {"device": str(device), "deviation": deviation,
            "max_abs_diff": diff, "spatial_top1": spatial,
            "jpeg_top1": jpeg_top1, "ok": ok}


if __name__ == "__main__":
    run(main)
