"""Training batches: JPEG coefficients of synthetic images with their
labels, made on the device from the seed and cycled.  Parameters:
``batch`` (images a step) and ``batches`` (distinct batches)."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import jpeg
from perfbench.traffic import images


def batches(cfg: dict, params: dict, seed: int, device) -> list[dict]:
    """``[{"coefficients": (B, bh, bw, C, 64) float32, "labels": (B,)
    int64}]``: each image's quantized coefficients under the canonical
    table in the network's convention (``k / 128``), as the trainer takes
    them.  Every row of every batch is a different image."""
    b, n = int(params["batch"]), int(params["batches"])
    q = np.tile(jpeg.canonical_table(cfg["quality"]), (b, 1))
    out = []
    for i in range(n):
        imgs, labels = images.synth(seed, f"train/{i}", b,
                                    cfg["image_size"], cfg["in_channels"],
                                    cfg["num_classes"], device)
        k = images.quantize(imgs, q)
        out.append({"coefficients": (k / 128.0).float(),
                    "labels": labels.to(torch.int64)})
    return out
