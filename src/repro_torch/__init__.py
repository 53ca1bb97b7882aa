"""PyTorch/CUDA port of the JPEG transform-domain ResNet (arXiv:1812.11690).

Serves ``jpeg-resnet`` from JPEG bytes to logits: the numpy codec on the
host, then the compiled plan on the device, with the hot loops in hand
written CUDA kernels (``repro_torch/csrc``); trains it; and serves and
trains every language model of the reference (prefill through the
flash-attention kernel, then decode).  The JPEG path is float32, the LMs run in their
configured dtype (bf16 or fp32): TF32 is switched off for matmuls and
convolutions when the package is imported.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise (:func:`resolve_device`).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA device; a CUDA request without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
