"""Synthetic images and their JPEG coefficients, made on the device from
the seed.

The images follow the port's synthetic corpus (``data/synthetic.py``,
frozen here and drawn in one batch): per image a Gaussian field with a
power-law spectrum whose exponent depends on the class, plus the class's
low-frequency template, so DCT energy compacts as in natural images.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.lib.spec import subseed
from perfbench.reference import jpeg

#: the 8-bit range of JPEG samples in the network's x = (p - 128) / 128
PIXEL_MIN, PIXEL_MAX = -1.0, 127.0 / 128.0


def synth(seed: int, stream: str, n: int, size: int, channels: int,
          classes: int, device: torch.device):
    """``(images (n, C, size, size) float32 in the 8-bit range, labels
    (n,) int64)``, a pure function of ``(seed, stream)``."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, stream))
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    f = torch.fft.fftfreq(size, device=device, dtype=torch.float64)
    rad = torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2) + 1.0 / size
    expo = 1.0 + labels.double() / max(classes, 1)
    shape = (n, channels, size, size)
    spec = torch.complex(
        torch.randn(shape, generator=g, device=device, dtype=torch.float64),
        torch.randn(shape, generator=g, device=device, dtype=torch.float64))
    spec = spec * rad[None, None] ** (-expo[:, None, None, None])
    img = torch.fft.ifft2(spec).real
    img = img / (img.abs().amax(dim=(-1, -2), keepdim=True) + 1e-8)
    tg = torch.Generator(device=device)
    tg.manual_seed(7777)   # the class templates do not depend on the seed
    tpl = torch.randn((classes, channels, 4, 4), generator=tg,
                      device=device, dtype=torch.float64)
    tpl = tpl[labels].repeat_interleave(size // 4, -2) \
        .repeat_interleave(size // 4, -1)
    img = 0.6 * img + 0.4 * torch.tanh(tpl)
    return img.clamp(PIXEL_MIN, PIXEL_MAX).float(), labels


def quantize(images: torch.Tensor, qtables: np.ndarray) -> torch.Tensor:
    """JPEG steps 1-5: ``(n, bh, bw, C, 64)`` integer zigzag coefficients
    of the 8-bit samples ``p = 128 x + 128`` under ``qtables`` ``(n, 64)``
    (one table an image), as float64 on the images' device."""
    x = jpeg.to_blocks(images.double())
    coef = x @ jpeg.const(jpeg.basis().T, x) * 128.0
    q = torch.as_tensor(qtables, dtype=torch.float64, device=images.device)
    return torch.round(coef / q[:, None, None, None, :])


def network_coefficients(k: torch.Tensor, qtables: np.ndarray) -> torch.Tensor:
    """The orthonormal zigzag coefficients of x that integers ``k`` under
    ``qtables`` stand for: ``k q / 128`` (float32)."""
    q = torch.as_tensor(qtables, dtype=torch.float64, device=k.device)
    return (k * q[:, None, None, None, :] / 128.0).float()


def qualities(n: int, mix) -> list[int]:
    """The quality of image ``i``: the mix, cycled."""
    return [int(mix[i % len(mix)]) for i in range(n)]

