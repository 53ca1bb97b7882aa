"""Deterministic synthetic corpora (no downloads).

* Token streams: zipfian unigrams with injected bigram structure, so a
  small LM can learn (its loss drops below the unigram entropy).
* Images: frequency-shaped Gaussian fields (power-law spectra per class)
  plus a class-specific low-frequency template: statistics that resemble
  natural images, so DCT energy compaction is realistic.

Everything is a pure function of ``(seed, index)``, with the reference
package's numpy draws, so both give the same values.
"""
from __future__ import annotations

import numpy as np

__all__ = ["token_batch", "unigram_entropy", "image_batch"]


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, index]))


def _zipf(vocab: int) -> np.ndarray:
    v = max(vocab - 2, 2)
    p = 1.0 / np.arange(1, v + 1, dtype=np.float64)
    return p / p.sum()


def token_batch(seed: int, index: int, batch: int, seq_len: int,
                vocab: int) -> dict[str, np.ndarray]:
    """``{'tokens': (B, S+1) int32}``, to be shifted into inputs and
    labels: zipfian unigrams over ``vocab − 2`` ids, and after token ``t``
    with probability 1/2 the token ``(7t + 3) mod (vocab − 2)``, applied
    position by position so it holds against the final previous token."""
    rng = _rng(seed, index)
    probs = _zipf(vocab)
    v = probs.size
    toks = rng.choice(v, size=(batch, seq_len + 1), p=probs).astype(np.int32)
    follow_mask = rng.random((batch, seq_len)) < 0.5
    for t in range(seq_len):
        follow = (toks[:, t] * 7 + 3) % v
        toks[:, t + 1] = np.where(follow_mask[:, t], follow, toks[:, t + 1])
    return {"tokens": toks}


def unigram_entropy(vocab: int) -> float:
    """Entropy (nats) of :func:`token_batch`'s unigram distribution."""
    p = _zipf(vocab)
    return float(-(p * np.log(p)).sum())


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
