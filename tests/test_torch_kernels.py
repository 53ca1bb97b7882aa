"""The port's kernel modules on the CPU (their plain versions) against the
reference package's Pallas kernels in interpret mode, plus the packed
operators of ``kernels.tiling`` and the core ops they are built from.

Tolerances are those of the reference suite: ASM 2e-5
(``test_kernels.py``), the exploded conv 5e-4 (``test_kernels.py``), the
fused block 1e-5 (``test_fused_block.py``); packed buffers 1e-6 relative
(the explode einsum sums in another order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import asm as ref_asm
from repro.core import conv as ref_conv
from repro.kernels import tiling as ref_tiling
from repro.kernels.asm_relu import asm_relu_pallas
from repro.kernels.fused_block import fused_block_pallas, \
    fused_block_reference
from repro.kernels.jpeg_conv import jpeg_conv_pallas
from repro_torch.core import asm as asmlib
from repro_torch.core import conv as convlib
from repro_torch.kernels import asm_relu as kasm
from repro_torch.kernels import fused_block as kfb
from repro_torch.kernels import jpeg_conv as kjc
from repro_torch.kernels import tiling

# one intra-op thread: the suite runs in parallel workers beside
# wall-clock tests of the reference package
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _kernel(rng, cout, cin, r):
    return (rng.normal(size=(cout, cin, r, r)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("nf", [16, 24, 64])
@pytest.mark.parametrize("phi", [8, 14])
def test_asm_relu_matches_pallas(nf, phi):
    x = np.random.default_rng(nf + phi).normal(size=(515, nf)).astype(
        np.float32)
    want = np.asarray(asm_relu_pallas(jnp.asarray(x), phi, interpret=True))
    got = kasm.asm_relu(_t(x), phi)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("bands", [13, 40])
def test_asm_relu_bands_match_core(bands):
    x = _t(np.random.default_rng(bands).normal(size=(3, 5, 64)))
    got = kasm.asm_relu(x, 8, bands=bands)
    want = ref_asm.asm_relu(jnp.asarray(x.numpy()), 8, bands=bands)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(),
                               asmlib.asm_relu(x, 8, bands=bands).numpy(),
                               atol=2e-5)
    assert not got[..., bands:].any()


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("bands", [16, 64])
def test_jpeg_conv_matches_pallas(stride, r, bands):
    rng = np.random.default_rng(10 * stride + r + bands)
    k = _kernel(rng, 5, 3, r)
    xi_ref = ref_conv.explode(jnp.asarray(k), stride, bands=bands)
    xi = convlib.explode(_t(k), stride, bands=bands)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_ref),
                               rtol=1e-6, atol=1e-6)
    coef = rng.normal(size=(2, 4, 4, 3, 64)).astype(np.float32)
    want = np.asarray(jpeg_conv_pallas(jnp.asarray(coef), xi_ref, stride,
                                       interpret=True))
    got = kjc.jpeg_conv(_t(coef), xi, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_jpeg_conv_shift_and_width_fit():
    rng = np.random.default_rng(4)
    xi = convlib.explode(_t(_kernel(rng, 4, 2, 3)), 1, bands=24)
    coef = _t(rng.normal(size=(1, 3, 3, 2, 64)))
    shift = _t(rng.normal(size=(4,)))
    got = kjc.jpeg_conv(coef, xi, 1, shift=shift, w_out=64)
    base = convlib.apply_exploded(coef, xi, 1)
    np.testing.assert_allclose(got[..., 1:24].numpy(), base[..., 1:].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got[..., 0].numpy(),
                               (base[..., 0] + shift).numpy(), atol=1e-6)
    assert not got[..., 24:].any()


def _packed(rng, cin, cout, stride, r, bands, w_in, w_out, shift=True):
    k = _kernel(rng, cout, cin, r)
    sh = rng.normal(size=(cout,)).astype(np.float32) if shift else None
    xi_ref = ref_conv.explode(jnp.asarray(k), stride, bands=bands)
    ref = ref_tiling.pack_conv(xi_ref, None if sh is None else
                               jnp.asarray(sh), stride, w_in=w_in,
                               w_out=w_out)
    port = tiling.pack_conv(convlib.explode(_t(k), stride, bands=bands),
                            None if sh is None else _t(sh), stride,
                            w_in=w_in, w_out=w_out)
    return ref, port


@pytest.mark.parametrize("w_in,w_out", [(16, 16), (8, 24), (64, 40)])
def test_pack_conv_matches_reference(w_in, w_out):
    ref, port = _packed(np.random.default_rng(w_in), 3, 2, 2, 3, 32,
                        w_in, w_out)
    assert port[2:] == tuple(ref[2:])
    np.testing.assert_allclose(port.xi.numpy(), np.asarray(ref.xi),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(port.shift.numpy(), np.asarray(ref.shift))


@pytest.mark.parametrize("phi,bands,w", [(14, 64, 64), (8, 20, 24),
                                         (14, 16, 16)])
def test_pack_asm_matches_reference(phi, bands, w):
    ref = ref_tiling.pack_asm(phi, bands, w)
    port = tiling.pack_asm(phi, bands, w)
    np.testing.assert_array_equal(port.cat.numpy(), np.asarray(ref.cat))
    np.testing.assert_array_equal(port.recon_t.numpy(),
                                  np.asarray(ref.recon_t))


@pytest.mark.parametrize("stride,nd", [(1, 3), (2, 3), (2, 2)])
def test_conv_slices_and_fit_width_exact(stride, nd):
    x = np.random.default_rng(nd).normal(size=(2, 4, 4, 12)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tiling.conv_slices(_t(x), stride, nd, nd).numpy(),
        np.asarray(ref_tiling.conv_slices(jnp.asarray(x), stride, nd, nd)))
    for w_to in (2, 4, 9):
        np.testing.assert_array_equal(
            tiling.fit_width(_t(x), 3, w_to).numpy(),
            np.asarray(ref_tiling.fit_width(jnp.asarray(x), 3, w_to)))
    assert tiling.pick_tile(1000, 1024) == ref_tiling.pick_tile(1000, 1024)


@pytest.mark.parametrize("case", ["identity", "projection", "mixed_w"])
def test_fused_block_matches_pallas(case):
    rng = np.random.default_rng({"identity": 0, "projection": 1,
                                 "mixed_w": 2}[case])
    if case == "identity":      # stride 1, identity shortcut, one width
        cin, cout, s, b1, b2, bj, w_x = 4, 4, 1, 32, 32, 32, 32
        proj = None
    elif case == "projection":  # stride 2, 1×1 projection shortcut
        cin, cout, s, b1, b2, bj, w_x = 3, 5, 2, 16, 16, 16, 16
        proj = _packed(rng, cin, cout, s, 1, 16, 16, 16, shift=False)
    else:                       # operands at their own widths
        cin, cout, s, b1, b2, bj, w_x = 4, 4, 1, 24, 40, 40, 48
        proj = None
    c1 = _packed(rng, cin, cout, s, 3, b1, min(b1, w_x), b1)
    c2 = _packed(rng, cout, cout, 1, 3, b2, min(b1, b2), b2)
    a1r, a1 = ref_tiling.pack_asm(14, b1, b1), tiling.pack_asm(14, b1, b1)
    a2r, a2 = ref_tiling.pack_asm(8, bj, bj), tiling.pack_asm(8, bj, bj)
    x = rng.normal(size=(2, 4, 4, cin * w_x)).astype(np.float32)
    want = fused_block_pallas(jnp.asarray(x), c1[0], a1r, c2[0], a2r,
                              proj[0] if proj else None, interpret=True)
    got = kfb.fused_block(_t(x), c1[1], a1, c2[1], a2,
                          proj[1] if proj else None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_fused_block_wide_join_matches_xla_twin():
    """A residual join wider than conv2's output (``asm_out.w >
    conv2.w_out``): the Pallas kernel's output spec assumes the two are
    equal, so this case is held against its XLA twin."""
    rng = np.random.default_rng(5)
    c1 = _packed(rng, 4, 4, 1, 3, 24, 24, 24)
    c2 = _packed(rng, 4, 4, 1, 3, 16, 16, 16)
    a1r, a1 = ref_tiling.pack_asm(14, 24, 24), tiling.pack_asm(14, 24, 24)
    a2r, a2 = ref_tiling.pack_asm(8, 40, 40), tiling.pack_asm(8, 40, 40)
    x = rng.normal(size=(2, 4, 4, 4 * 40)).astype(np.float32)
    want = fused_block_reference(jnp.asarray(x), c1[0], a1r, c2[0], a2r)
    got = kfb.fused_block(_t(x), c1[1], a1, c2[1], a2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_smem_sizes_fit_one_cta():
    for bm in kjc.TILE_ROWS:
        for w in range(1, 65):
            assert kjc.conv_smem_bytes(w, True, bm) <= 227 * 1024
    # the 64-row variant runs two CTAs an SM (228 KB, 1 KB reserved a CTA)
    for w in range(1, 65):
        assert 2 * (kjc.conv_smem_bytes(w, True, 64) + 1024) <= 228 * 1024
    # ASM epilogue at w 64: the 128×128 tile at row stride 132, cat,
    # recon_t, the masked 128×64 tile at row stride 68
    assert kjc.conv_smem_bytes(64, True) == 4 * (128 * 132 + 192 * 64
                                                 + 128 * 68)
    # at w 6 the operators are padded to 8 lanes
    assert kjc.conv_smem_bytes(6, True, 64) == 4 * (64 * 132 + 192 * 8
                                                    + 64 * 68)
    # two stages of a 32-wide K slice of A (128 rows of 36 floats) and B
    # (128 columns)
    assert kjc.conv_smem_bytes(16, False) == 2 * 4 * (128 * 36 + 32 * 128)
    assert kjc.conv_smem_bytes(16, False, 64) == 2 * 4 * (64 * 36 + 32 * 128)


@pytest.mark.parametrize("m_rows,col_tiles,sms,want", [
    (1024, 16, 132, 128),  # s1 at batch 4: 128 CTAs of 128 rows
    (4096, 8, 132, 128),   # s0 at batch 4: 256 CTAs
    (256, 32, 132, 64),    # s2 at batch 4: 64 CTAs, half the card idle
    (8448, 1, 132, 128),   # CTAs for exactly half the SMs
    (8447, 1, 132, 128),
    (8320, 1, 132, 64),
])
def test_tile_rows_fill_the_card(m_rows, col_tiles, sms, want):
    assert kjc.tile_rows(m_rows, col_tiles, sms) == want


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    before = (kasm.LAUNCHES, kjc.LAUNCHES, kfb.LAUNCHES)
    x = torch.randn(7, 16)
    np.testing.assert_array_equal(kasm.asm_relu(x, 14).numpy(),
                                  kasm.asm_relu_plain(x, 14).numpy())
    assert (kasm.LAUNCHES, kjc.LAUNCHES, kfb.LAUNCHES) == before
