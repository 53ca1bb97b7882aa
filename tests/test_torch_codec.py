"""The port's codec against the reference package's, bit for bit: encoded
bytes, decoded and normalized batches (64-lane and tile-packed), the
coefficient-domain chroma upsample, and the synthetic request stream."""
import glob
import os

import numpy as np
import pytest

from repro.codec import encode as ref_enc
from repro.codec import ingest as ref_ing
from repro.codec import normalize as ref_nm
from repro.core import dct as ref_dct
from repro.data import synthetic as ref_syn
from repro_torch.codec import encode as enc
from repro_torch.codec import ingest as ing
from repro_torch.codec import normalize as nm
from repro_torch.core import dct
from repro_torch.data import synthetic as syn

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "codec", "*.jpg")))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_dct_constants_identical():
    for q in (35, 50, 90):
        for mean in (True, False):
            np.testing.assert_array_equal(
                dct.quantization_table(q, dc_is_mean=mean),
                ref_dct.quantization_table(q, dc_is_mean=mean))
    np.testing.assert_array_equal(dct.reconstruction_matrix(),
                                  ref_dct.reconstruction_matrix())
    for phi in (2, 8, 14):
        np.testing.assert_array_equal(
            dct.truncated_reconstruction_matrix(phi),
            ref_dct.truncated_reconstruction_matrix(phi))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
@pytest.mark.parametrize("pack", [None, 16])
def test_fixture_ingest_bit_exact(path, pack):
    data = [_read(path)] * 2
    kw = dict(quality=50, grid=(4, 4), channels=3, pack_width=pack)
    got, st = ing.ingest_batch(data, **kw)
    want, wst = ref_ing.ingest_batch(data, parallel=False, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(st.energy, wst.energy)
    np.testing.assert_array_equal(st.occupancy, wst.occupancy)


@pytest.mark.parametrize("subsample,restart", [(False, 0), (True, 2)])
def test_encode_pixels_byte_identical_and_ingest(subsample, restart):
    rng = np.random.default_rng(3)
    img = np.clip(rng.normal(size=(3, 32, 48)) * 0.4, -1.0, 0.99)
    qt = np.rint(dct.quantization_table(75, dc_is_mean=False)).astype(
        np.int64)
    kw = dict(qtable=qt, subsample=subsample, restart_interval=restart)
    data = enc.encode_pixels(img, **kw)
    assert data == ref_enc.encode_pixels(img, **kw)
    for parallel in (False, True):
        got, _ = ing.ingest_batch([data] * 3, grid=(4, 6),
                                  parallel=parallel)
        want, _ = ref_ing.ingest_batch([data] * 3, grid=(4, 6),
                                       parallel=False)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fy,fx", [(1, 2), (2, 1), (2, 2)])
def test_upsample_coefficients_matches_reference(fy, fx):
    coef = np.random.default_rng(fy * 3 + fx).normal(
        size=(3, 2, 64)).astype(np.float32)
    np.testing.assert_array_equal(nm.upsample_coefficients(coef, fy, fx),
                                  ref_nm.upsample_coefficients(coef, fy, fx))


def test_synthetic_images_identical():
    a = syn.image_batch(5, 2, 3, 32)
    b = ref_syn.image_batch(5, 2, 3, 32)
    np.testing.assert_array_equal(a["images"], b["images"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_pack_tiles_matches_reference():
    coef = np.random.default_rng(0).normal(size=(2, 3, 3, 4, 64))
    for w in (8, 24, 64):
        np.testing.assert_array_equal(ing.pack_tiles(coef, w),
                                      ref_ing.pack_tiles(coef, w))


@pytest.mark.parametrize("pos_frac,bit", [(0.15495980410270385, 4),
                                          (0.15495980410270385, 0),
                                          (0.15234375, 1)])
def test_corrupt_frame_header_raises_codec_error(pos_frac, bit):
    """Bit-flips in the frame header that the reference decoder lets
    through as ZeroDivisionError/ValueError (zero sampling factors, a
    component count past the segment) raise a typed CodecError here."""
    from repro_torch.codec import CodecError

    data = _read(next(p for p in FIXTURES if p.endswith("gray_q80.jpg")))
    at = min(2 + int(pos_frac * (len(data) - 4)), len(data) - 3)
    arr = bytearray(data)
    arr[at] ^= 1 << bit
    with pytest.raises(CodecError):
        ing.decode_bytes(bytes(arr))
