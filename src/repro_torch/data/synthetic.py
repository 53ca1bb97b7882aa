"""Deterministic synthetic image corpora (no downloads).

Frequency-shaped Gaussian fields (power-law spectra per class) plus a
class-specific low-frequency template: statistics that resemble natural
images, so DCT energy compaction is realistic.  Everything is a pure
function of ``(seed, index)``; the same values as the reference package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["image_batch"]


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, index]))


def image_batch(seed: int, index: int, batch: int, size: int,
                channels: int = 3,
                num_classes: int = 10) -> dict[str, np.ndarray]:
    """Returns {'images': (B, C, H, W) f32 in ~[-1,1], 'labels': (B,) i32}."""
    rng = _rng(seed, index)
    labels = rng.integers(0, num_classes, size=(batch,)).astype(np.int32)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    rad = np.sqrt(fy * fy + fx * fx) + 1.0 / size
    # class templates are a global constant (independent of the data seed)
    template_rng = np.random.default_rng(np.random.SeedSequence([7777]))
    templates = template_rng.normal(
        size=(num_classes, channels, 4, 4)).astype(np.float32)
    images = np.empty((batch, channels, size, size), np.float32)
    for i in range(batch):
        y = int(labels[i])
        expo = 1.0 + y / max(num_classes, 1)
        spec = rng.normal(size=(channels, size, size)) \
            + 1j * rng.normal(size=(channels, size, size))
        spec *= rad[None] ** (-expo)
        img = np.real(np.fft.ifft2(spec, axes=(-2, -1)))
        img /= (np.abs(img).max(axis=(-1, -2), keepdims=True) + 1e-8)
        tpl = np.kron(templates[y], np.ones((size // 4, size // 4), np.float32))
        images[i] = 0.6 * img + 0.4 * np.tanh(tpl)
    return {"images": images, "labels": labels}
