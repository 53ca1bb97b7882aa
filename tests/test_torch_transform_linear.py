"""The port's transform-domain folding (``repro_torch.core.transform_linear``)
against the reference package's, on numpy-drawn weights and images.

* ``fold_patch_embed`` (patch 16, 3 channels, quantization-scaled at
  quality 50) applied to block-DCT coefficients laid out per patch
  (``coefficient_patches``) equals the pixel-patch
  projection within 1e-4 of the largest |value| (an exact fold; fp32 sums
  over 768 terms), and its weight equals the reference's within 1e-5;
* ``fold_frontend`` and ``unfold_patches_to_blocks`` equal the
  reference's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import transform_linear as ref_tl
from repro_torch.core import transform_linear as tl

torch.set_num_threads(1)

PATCH, CHANNELS, D = 16, 3, 32


@pytest.mark.parametrize("size", [32, 48])
def test_fold_patch_embed_on_block_dct_coefficients(size):
    rng = np.random.default_rng(size)
    imgs = rng.normal(size=(2, CHANNELS, size, size)).astype(np.float32)
    w = (rng.normal(size=(CHANNELS * PATCH * PATCH, D))
         * 0.05).astype(np.float32)
    w_jpeg = tl.fold_patch_embed(torch.as_tensor(w), PATCH, CHANNELS,
                                 quality=50, scaled=True)
    want_w = np.asarray(ref_tl.fold_patch_embed(jnp.asarray(w), PATCH,
                                                CHANNELS, scaled=True))
    assert w_jpeg.shape == want_w.shape
    assert np.abs(w_jpeg.numpy() - want_w).max() <= 1e-5 * np.abs(
        want_w).max()
    x = torch.as_tensor(imgs)
    pixel = tl.unfold_patches_to_blocks(x, PATCH) @ torch.as_tensor(w)
    got = tl.coefficient_patches(x, PATCH, 50) @ w_jpeg
    assert np.abs((got - pixel).numpy()).max() <= 1e-4 * float(
        pixel.abs().max())


def test_fold_patch_embed_rejects_a_patch_off_the_block_grid():
    with pytest.raises(ValueError, match="multiple of 8"):
        tl.fold_patch_embed(torch.zeros(3 * 12 * 12, 4), 12, 3)


def test_fold_frontend_equals_the_references():
    rng = np.random.default_rng(0)
    a = np.linalg.qr(rng.normal(size=(64, 64)))[0].astype(np.float32)
    w = rng.normal(size=(64, 8)).astype(np.float32)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    folded = tl.fold_frontend(torch.as_tensor(a), torch.as_tensor(w))
    want = np.asarray(ref_tl.fold_frontend(jnp.asarray(a), jnp.asarray(w)))
    assert np.abs(folded.numpy() - want).max() <= 1e-5
    coeffs = torch.as_tensor(x) @ torch.as_tensor(a).T
    assert np.abs((coeffs @ folded).numpy() - x @ w).max() <= 1e-4


@pytest.mark.parametrize("patch", [8, 16])
def test_unfold_patches_equals_the_references(patch):
    imgs = np.random.default_rng(patch).normal(
        size=(2, 3, 32, 48)).astype(np.float32)
    got = tl.unfold_patches_to_blocks(torch.as_tensor(imgs), patch)
    want = np.asarray(ref_tl.unfold_patches_to_blocks(jnp.asarray(imgs),
                                                      patch))
    assert np.array_equal(got.numpy(), want)
