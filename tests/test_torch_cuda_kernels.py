"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU of compute capability 9.0 (the kernels are built for
``sm_90a``) and ``nvcc``; skipped elsewhere.  Run on the card with

    python -m pytest -q tests/test_torch_cuda_kernels.py

Covers ragged row counts, every ASM width 1…64 (all-zero rows and rows
whose approximation is exactly 0 among them), both shortcut
kinds and both strides of the fused block, the banded conv's 16-byte and
4-byte K paths in its 128- and 64-row variants, both block-transform
operators, the launch counters, the autograd wrappers' gradients against
those of the plain versions, and flash attention in fp32 and bf16 (ragged
tiles and the tensor-core kernel's tile edges, S != T, windows, a query
offset, bad operands, a small model's prefill), its backward kernels
against the plain backward on the same cases and the backward's own tile
edges (rows without keys giving zero gradients among them), two bf16
backward calls giving the same bits, the autograd
function against autograd through the plain version, and a small model's
gradient under every ``remat``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import conv as convlib
from repro_torch.core import dispatch as dsp
from repro_torch.core import resnet as resnetlib
from repro_torch.kernels import _build
from repro_torch.kernels import asm_relu as kasm
from repro_torch.kernels import block_dct as kbd
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import fused_block as kfb
from repro_torch.kernels import jpeg_conv as kjc
from repro_torch.kernels import tiling

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (capability 9.0)")
    _build.library()
    return torch.device("cuda", 0)


def _close(got, want, rtol):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    tol = rtol * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


#: asm_kernel's tiles are 128 rows: one row, one short of a tile, one past
#: it, a whole number of tiles, and more tiles than the persistent CTAs,
#: ragged
ASM_ROWS = [1, 127, 129, 4736, 50001]


@pytest.mark.parametrize("w", list(range(1, 65)))
@pytest.mark.parametrize("rows", ASM_ROWS)
def test_asm_relu_every_width(dev, w, rows):
    """Rows read at w of 64 lanes (16-byte copies where w % 4 == 0, float4
    stores) and rows of w lanes (4-byte copies and scalar stores where
    w % 4 != 0)."""
    g = torch.Generator(device=dev).manual_seed(w + rows)
    x = torch.randn((rows, 64), generator=g, device=dev)
    before = kasm.LAUNCHES
    got = kasm.asm_relu(x, 8, bands=w)
    assert kasm.LAUNCHES == before + 1
    _close(got, kasm.asm_relu_plain(x, 8, bands=w), 2e-5)
    narrow = x[:, :w].contiguous()
    _close(kasm.asm_relu(narrow, 14), kasm.asm_relu_plain(narrow, 14), 2e-5)


@pytest.mark.parametrize("w", [6, 16, 64])
def test_asm_relu_zero_and_masked_rows(dev, w):
    """All-zero rows, and rows whose approximation is exactly 0 (φ = 0
    keeps only DC, and DC is 0) while the exact reconstruction is not: the
    mask is off on both paths, so those rows come out exactly 0."""
    g = torch.Generator(device=dev).manual_seed(w)
    x = torch.randn((4099, 64), generator=g, device=dev)
    x[::3] = 0
    x[1::3, 0] = 0
    for phi in (0, 14):
        got = kasm.asm_relu(x, phi, bands=w)
        _close(got, kasm.asm_relu_plain(x, phi, bands=w), 2e-5)
        assert not got[::3].any()
    assert not kasm.asm_relu(x, 0, bands=w)[1::3].any()


@pytest.mark.parametrize("nf,w", [(72, 16), (66, 64), (9, 7)])
def test_asm_relu_rows_the_output_tile_does_not_take(dev, nf, w):
    """Rows wider than 64 lanes, or of a width that is not a multiple of
    4, are stored by the threads instead of the bulk copy."""
    x = torch.randn((3001, nf), device=dev)
    got = kasm.asm_relu(x, 14, bands=w)
    _close(got, kasm.asm_relu_plain(x, 14, bands=w), 2e-5)
    assert not got[:, w:].any()


@pytest.mark.parametrize("stride,r", [(1, 3), (2, 3), (2, 1)])
@pytest.mark.parametrize("bands", [8, 16, 40, 64])
def test_jpeg_conv_matches_plain(dev, stride, r, bands):
    g = torch.Generator(device=dev).manual_seed(stride * 100 + r + bands)
    k = torch.randn((9, 5, r, r), generator=g, device=dev) * 0.3
    xi = convlib.explode(k, stride, bands=bands)
    coef = torch.randn((3, 6, 10, 5, 64), generator=g, device=dev)
    shift = torch.randn((9,), generator=g, device=dev)
    before = kjc.LAUNCHES
    for kw in ({}, {"shift": shift, "w_out": 64}):
        got = kjc.jpeg_conv(coef, xi, stride, **kw)
        _close(got, kjc.jpeg_conv_plain(coef, xi, stride, **kw), 1e-4)
    assert kjc.LAUNCHES == before + 2


def _pc(g, dev, cin, cout, stride, r, bands, w_in, w_out):
    k = torch.randn((cout, cin, r, r), generator=g, device=dev) * 0.3
    shift = torch.randn((cout,), generator=g, device=dev)
    return tiling.pack_conv(convlib.explode(k, stride, bands=bands), shift,
                            stride, w_in=w_in, w_out=w_out)


@pytest.mark.parametrize("case", [
    # (cin, cout, stride, b1, b2, bj, w_x, projection)
    (8, 8, 1, 16, 16, 16, 16, False),
    (6, 10, 2, 24, 24, 24, 24, True),
    (8, 8, 1, 24, 40, 40, 48, False),
    (4, 4, 1, 24, 16, 40, 40, False),
    (5, 3, 2, 64, 64, 64, 64, True),
])
def test_fused_block_matches_plain(dev, case):
    cin, cout, s, b1, b2, bj, w_x, with_proj = case
    g = torch.Generator(device=dev).manual_seed(sum(case))
    c1 = _pc(g, dev, cin, cout, s, 3, b1, min(b1, w_x), b1)
    c2 = _pc(g, dev, cout, cout, 1, 3, b2, min(b1, b2), b2)
    pp = _pc(g, dev, cin, cout, s, 1, bj, min(bj, w_x), bj) \
        if with_proj else None
    a1 = tiling.pack_asm(14, b1, b1, device=dev)
    a2 = tiling.pack_asm(8, bj, bj, device=dev)
    x = torch.randn((3, 6, 10, cin * w_x), generator=g, device=dev)
    before = kfb.LAUNCHES
    got = kfb.fused_block(x, c1, a1, c2, a2, pp)
    assert kfb.LAUNCHES == before + (3 if with_proj else 2)
    _close(got, kfb.fused_block_reference(x, c1, a1, c2, a2, pp), 1e-4)


@pytest.fixture(params=kjc.TILE_ROWS, ids=lambda bm: f"bm{bm}")
def tile(request, monkeypatch):
    """Force the banded conv's 128- or 64-row variant (the wrapper picks
    by grid size, and these shapes are small)."""
    monkeypatch.setattr(kjc, "tile_rows", lambda *_: request.param)
    return request.param


#: jpeg_conv on both K paths: (N, bh, bw, Cin, Cout, stride, r, bands);
#: M = N·bh·bw/s² and Cout·bands are not multiples of 128
CONV_PATHS = [
    (2, 13, 11, 3, 9, 1, 3, 16),    # the stem's Cin = 3, 16-byte copies
    (3, 10, 14, 3, 20, 2, 3, 64),   # stem-like, stride 2, w 64
    (3, 9, 11, 5, 7, 1, 3, 5),      # odd width: 4-byte gathers
    (2, 12, 10, 6, 11, 2, 1, 10),   # w 10: gathers, 1×1 stride 2
]


@pytest.mark.parametrize("n,bh,bw,cin,cout,stride,r,bands", CONV_PATHS)
def test_jpeg_conv_paths_and_tiles(dev, tile, n, bh, bw, cin, cout, stride,
                                   r, bands):
    g = torch.Generator(device=dev).manual_seed(n * bh + bands)
    k = torch.randn((cout, cin, r, r), generator=g, device=dev) * 0.3
    xi = convlib.explode(k, stride, bands=bands)
    coef = torch.randn((n, bh, bw, cin, 64), generator=g, device=dev)
    shift = torch.randn((cout,), generator=g, device=dev)
    for kw in ({}, {"shift": shift, "w_out": 64}):
        got = kjc.jpeg_conv(coef, xi, stride, **kw)
        _close(got, kjc.jpeg_conv_plain(coef, xi, stride, **kw), 1e-4)


@pytest.mark.parametrize("case", [
    # (N, grid, cin, cout, stride, w, projection): the ASM epilogue at w
    # 16 and 64 on 16-byte copies, at w 6 on gathers
    (2, 13, 20, 20, 1, 16, False),
    (3, 10, 8, 9, 2, 64, True),
    (2, 9, 5, 7, 1, 6, True),
])
def test_fused_block_paths_and_tiles(dev, tile, case):
    n, grid, cin, cout, s, w, with_proj = case
    g = torch.Generator(device=dev).manual_seed(sum(case))
    c1 = _pc(g, dev, cin, cout, s, 3, w, w, w)
    c2 = _pc(g, dev, cout, cout, 1, 3, w, w, w)
    pp = _pc(g, dev, cin, cout, s, 1, w, w, w) if with_proj else None
    a1 = tiling.pack_asm(14, w, w, device=dev)
    a2 = tiling.pack_asm(8, w, w, device=dev)
    x = torch.randn((n, grid, grid, cin * w), generator=g, device=dev)
    got = kfb.fused_block(x, c1, a1, c2, a2, pp)
    _close(got, kfb.fused_block_reference(x, c1, a1, c2, a2, pp), 1e-4)


def test_tile_rows_follow_the_grid(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert kjc.tile_rows(4096, 8, sms) == 128      # s0 at batch 4
    assert kjc.tile_rows(1024, 16, sms) == 128     # s1 at batch 4
    assert kjc.tile_rows(256, 32, sms) == 64       # s2 at batch 4


def test_smem_formula_matches_library(dev):
    lib = _build.library()
    for bm in kjc.TILE_ROWS:
        for w in range(1, 65):
            for with_asm in (0, 1):
                assert lib.jk_banded_conv_smem(w, with_asm, bm) == \
                    kjc.conv_smem_bytes(w, bool(with_asm), bm)


def test_kernels_refuse_bad_operands(dev):
    x = torch.randn((4, 64), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        kasm.asm_relu(x, 14)
    np.testing.assert_array_equal(
        kasm.asm_relu(torch.zeros((2, 16)), 14).numpy(), np.zeros((2, 16)))


@pytest.mark.parametrize("quality", [None, 50])
@pytest.mark.parametrize("rows", [1, 63, 515, 24576 + 37])
def test_block_transforms_match_plain(dev, rows, quality):
    g = torch.Generator(device=dev).manual_seed(rows)
    blocks = torch.randn((rows, 8, 8), generator=g, device=dev)
    before = dict(kbd.LAUNCHES)
    coef = kbd.block_dct(blocks, quality)
    # 64-term fp32 sums in another order than cuBLAS's
    _close(coef, kbd.block_dct_plain(blocks, quality), 1e-5)
    _close(kbd.block_idct(coef, quality), kbd.block_idct_plain(coef, quality),
           1e-5)
    assert kbd.LAUNCHES["block_dct"] == before["block_dct"] + 1
    assert kbd.LAUNCHES["block_idct"] == before["block_idct"] + 1


def _grads_match(fn, plain, inputs, rtol):
    """The wrapper's gradients against the plain version's, for a random
    cotangent; fp32, ``rtol`` relative to the largest plain gradient."""
    g = torch.Generator(device=inputs[0].device).manual_seed(7)
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    ys = [x.detach().clone().requires_grad_(True) for x in inputs]
    out, want = fn(*xs), plain(*ys)
    _close(out.detach(), want.detach(), rtol)
    cot = torch.randn(out.shape, generator=g, device=out.device)
    for a, b in zip(torch.autograd.grad(out, xs, cot),
                    torch.autograd.grad(want, ys, cot)):
        _close(a, b, rtol)


@pytest.mark.parametrize("name", ["block_dct", "block_idct"])
def test_block_transform_gradients(dev, name):
    shape = (4, 5, 3, 8, 8) if name == "block_dct" else (4, 5, 3, 64)
    x = torch.randn(shape, device=dev)
    fn = getattr(kbd, name)
    plain = getattr(kbd, name + "_plain")
    before = kbd.LAUNCHES[name]
    _grads_match(lambda t: fn(t, 50), lambda t: plain(t, 50), [x], 1e-5)
    assert kbd.LAUNCHES[name] == before + 2  # forward and backward


@pytest.mark.parametrize("bands", [16, 64])
def test_asm_relu_gradients(dev, bands):
    x = torch.randn((3, 4, 4, 5, 64), device=dev)
    _grads_match(lambda t: kasm.asm_relu(t, 14, bands=bands),
                 lambda t: kasm.asm_relu_plain(t, 14, bands=bands), [x],
                 2e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_jpeg_conv_gradients(dev, stride):
    k = torch.randn((6, 3, 3, 3), device=dev) * 0.3
    coef = torch.randn((2, 4, 4, 3, 64), device=dev)

    def run(conv):
        return lambda c, kern: conv(c, convlib.explode(kern, stride,
                                                       in_scaled=True),
                                    stride, w_out=64)

    _grads_match(run(kjc.jpeg_conv), run(kjc.jpeg_conv_plain), [coef, k],
                 1e-4)


def test_training_forward_kernel_path_matches_plain(dev):
    """jpeg_apply in training on the kernel path against the plain path,
    with a lowered materialise limit so that the factored convs (and the
    block kernels) run too; loss and every gradient within 1e-4 relative
    norm (fp32 sums in another order, ASM masks that may flip on
    pre-activations within rounding of zero)."""
    spec = resnetlib.ResNetSpec(widths=(8, 16), num_classes=10)
    params, state = resnetlib.init_resnet(torch.Generator().manual_seed(0),
                                          spec, dev)
    coef = torch.randn((2, 4, 4, 3, 64), device=dev) * 4
    labels = torch.tensor([1, 7], device=dev)

    def loss_and_grads(path):
        cfg = dsp.DispatchConfig(path=path, materialize_limit=1_000_000)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params["s1b0"].items()}
        p = dict(params, s1b0=leaves)
        logits, _ = resnetlib.jpeg_apply(p, state, coef, training=True,
                                         spec=spec, dispatch=cfg)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        return loss.detach(), torch.autograd.grad(loss,
                                                  list(leaves.values()))

    counts = (kjc.LAUNCHES, kasm.LAUNCHES, dict(kbd.LAUNCHES))
    loss_k, grads_k = loss_and_grads("auto")
    assert kjc.LAUNCHES > counts[0] and kasm.LAUNCHES > counts[1]
    assert all(kbd.LAUNCHES[n] > counts[2][n] for n in kbd.LAUNCHES)
    loss_p, grads_p = loss_and_grads("reference")
    assert abs(float(loss_k) - float(loss_p)) <= 1e-4 * abs(float(loss_p))
    for a, b in zip(grads_k, grads_p):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())


# ------------------------------------------------------- flash attention

CARD = [  # b, s, t, h, kvh, hd, causal, window, q_offset
    (2, 200, 200, 15, 5, 64, True, None, 0),    # ragged query and key tiles
    (1, 130, 300, 8, 2, 128, False, None, 0),   # S != T, not causal
    (2, 333, 333, 4, 1, 64, True, 100, 0),      # window, MQA
    (1, 77, 127, 6, 3, 64, True, None, 50),     # a continued prompt
    (1, 64, 64, 2, 2, 128, False, 16, 0),       # window, not causal
]


def _card_qkv(dev, b, s, t, h, kvh, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, s, h, hd), (b, t, kvh, hd),
                               (b, t, kvh, hd)))


def _hold_kernel_against_plain(dev, dtype, b, s, t, h, kvh, hd, causal,
                               window, q_offset):
    """fp32: 2e-4 absolute.  bf16: the kernel's error against the plain
    version on fp32 copies is at most 1.5× the bf16 plain version's (both
    round their probabilities to bf16; the kernel keeps the scaled q in
    fp32)."""
    q, k, v = _card_qkv(dev, b, s, t, h, kvh, hd, dtype, s + t + h)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = kfa.LAUNCHES
    with torch.inference_mode():
        got = kfa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert kfa.LAUNCHES == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        assert torch.isfinite(got).all()
        exact = kfa.attention_plain(q.float(), k.float(), v.float(), **kw)
        err = float((got.float() - exact).abs().max())
        if dtype == torch.float32:
            assert err <= 2e-4, err
        else:
            plain = kfa.attention_plain(q, k, v, **kw).float()
            assert err <= 1.5 * float((plain - exact).abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset", CARD)
def test_kernel_matches_plain_on_card(dev, dtype, b, s, t, h, kvh, hd,
                                      causal, window, q_offset):
    _hold_kernel_against_plain(dev, dtype, b, s, t, h, kvh, hd, causal,
                               window, q_offset)


#: bf16 cases on the tensor-core kernel's tile edges (query tiles of 128
#: rows at hd 64 and 256 at hd 128, warps of 32 rows, 64-key tiles): b, s,
#: t, h, kvh, hd, causal, window, q_offset
TC_EDGES = [
    (1, 127, 127, 3, 3, 64, True, None, 0),      # G 1, one short tile
    (1, 129, 129, 6, 2, 128, True, None, 0),     # G 3, one row past a tile
    (2, 191, 191, 8, 1, 64, True, None, 0),      # G 8 (MQA), ragged tiles
    (1, 2049, 2049, 2, 1, 128, True, None, 0),   # a long ragged prefill
    (1, 129, 191, 3, 1, 128, False, None, 0),    # S != T, not causal
    (1, 127, 2049, 8, 1, 64, True, None, 1922),  # q_offset > 0
    # window 70: the first visited key tile (keys 0..63) is fully masked
    # for rows 133.. and skipped by the warps whose rows all lie past it
    (1, 191, 191, 3, 3, 128, True, 70, 0),
    (2, 2049, 2049, 6, 2, 64, True, 256, 0),
]


@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset", TC_EDGES)
def test_tensor_core_kernel_tile_edges(dev, b, s, t, h, kvh, hd, causal,
                                       window, q_offset):
    _hold_kernel_against_plain(dev, torch.bfloat16, b, s, t, h, kvh, hd,
                               causal, window, q_offset)


def test_kernel_refuses_bad_operands_and_gradients(dev):
    q, k, v = _card_qkv(dev, 1, 64, 64, 4, 2, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="head_dim"):
        kfa.flash_attention(*_card_qkv(dev, 1, 64, 64, 4, 2, 32,
                                       torch.float32, 0))
    with pytest.raises(ValueError, match="share a dtype"):
        kfa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="KVH dividing H"):
        kfa.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1), v)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention(q, k, v, window=0)
    # a gradient is no longer refused: the hand-written backward runs
    _hold_function_gradient(dev, 1, 64, 64, 4, 2, 64, True, None, 0)


#: the backward kernels' cases beside CARD: 64-row query and 64-key tiles,
#: ragged past them, G 8, a long ragged prefill at hd 128, a query offset
#: past many key tiles, a window whose first key tile a row cannot see,
#: three keys in all (one key would make dq exactly 0, leaving only
#: rounding to compare)
BWD_EDGES = [  # b, s, t, h, kvh, hd, causal, window, q_offset
    (2, 191, 191, 8, 1, 64, True, None, 0),
    (1, 2049, 2049, 2, 1, 128, True, None, 0),
    (1, 127, 2049, 8, 1, 64, True, None, 1922),
    (1, 191, 191, 3, 3, 128, True, 70, 0),
    (1, 65, 3, 2, 1, 64, False, None, 0),
]


def _hold_backward_against_plain(dev, dtype, b, s, t, h, kvh, hd, causal,
                                 window, q_offset):
    """The Function's gradients (one forward and one backward launch)
    against ``attention_backward_plain`` fed by an fp32
    ``attention_lse_plain`` on fp32 copies of the same inputs.  fp32:
    1e-4 of the largest |gradient| (fp32 sums of up to T terms in another
    order).  bf16: the kernel's error at most 1.5× that of the plain
    backward run from the bf16 inputs and their bf16 forward."""
    q, k, v = _card_qkv(dev, b, s, t, h, kvh, hd, dtype, s + t + h)
    do = torch.randn(q.shape, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n_fwd, n_bwd = kfa.LAUNCHES, kfa.BWD_LAUNCHES
    kfa.flash_attention(*leaves, **kw).backward(do)
    torch.cuda.synchronize()
    assert (kfa.LAUNCHES, kfa.BWD_LAUNCHES) == (n_fwd + 1, n_bwd + 1)
    got = [x.grad for x in leaves]
    f32 = [x.float() for x in (q, k, v, do)]
    o32, l32 = kfa.attention_lse_plain(*f32[:3], **kw)
    exact = kfa.attention_backward_plain(*f32[:3], o32, f32[3], l32, **kw)
    if dtype == torch.bfloat16:
        o16, l16 = kfa.attention_lse_plain(q, k, v, **kw)
        plain = kfa.attention_backward_plain(q, k, v, o16, do, l16, **kw)
    for i, name in enumerate("qkv"):
        assert got[i].dtype == dtype and got[i].shape == exact[i].shape
        assert torch.isfinite(got[i]).all(), name
        err = float((got[i].float() - exact[i]).abs().max())
        if dtype == torch.float32:
            tol = 1e-4 * max(1e-30, float(exact[i].abs().max()))
        else:
            tol = 1.5 * float((plain[i].float() - exact[i]).abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset",
                         CARD + BWD_EDGES)
def test_backward_kernels_match_plain_on_card(dev, dtype, b, s, t, h, kvh,
                                              hd, causal, window,
                                              q_offset):
    _hold_backward_against_plain(dev, dtype, b, s, t, h, kvh, hd, causal,
                                 window, q_offset)


@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset", [
    (4, 2048, 2048, 15, 5, 64, True, None, 0),  # smollm-360m's training
    BWD_EDGES[1],
], ids=["smollm-360m", "long-ragged-hd128"])
def test_bf16_backward_is_deterministic_on_card(dev, b, s, t, h, kvh, hd,
                                                causal, window, q_offset):
    """No atomics: every gradient is written once by the CTA that owns
    it, so two bf16 backward calls on the same inputs give the same
    bits."""
    q, k, v = _card_qkv(dev, b, s, t, h, kvh, hd, torch.bfloat16, 3)
    do = torch.randn(q.shape, device=dev).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse, lo = kfa.flash_attention_lse(q, k, v, **kw)
    first = kfa.flash_attention_backward(q, k, v, out, do, lse, out_lo=lo,
                                         **kw)
    second = kfa.flash_attention_backward(q, k, v, out, do, lse, out_lo=lo,
                                          **kw)
    torch.cuda.synchronize()
    for name, a, b_ in zip("qkv", first, second):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b_), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_rows_without_keys_get_zero_gradients_on_card(dev, dtype, hd):
    """Causal queries at positions −30 … 69: the first 30 rows see no key.
    The forward gives them 0 and an lse of −inf; the backward gives them
    zero dq and takes nothing from their dO into dk or dv."""
    q, k, v = _card_qkv(dev, 1, 100, 100, 4, 2, hd, dtype, 5)
    do = torch.randn(q.shape, device=dev).to(dtype)
    kw = dict(causal=True, q_offset=-30)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = kfa.flash_attention(*leaves, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :30], torch.zeros_like(out[:, :30]))
    for x in leaves:
        assert torch.isfinite(x.grad).all()
    assert torch.equal(leaves[0].grad[:, :30],
                       torch.zeros_like(leaves[0].grad[:, :30]))
    kept = do.clone()
    kept[:, :30] = 0
    again = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kfa.flash_attention(*again, **kw).backward(kept)
    for a, b in zip(leaves[1:], again[1:]):
        assert torch.equal(a.grad, b.grad)


def _hold_function_gradient(dev, b, s, t, h, kvh, hd, causal, window,
                            q_offset):
    """fp32: gradients of a loss through the kernel against autograd
    through the plain version, with dO arriving non-contiguous (the loss
    reads the output transposed); 1e-4 of the largest |gradient|."""
    q, k, v = _card_qkv(dev, b, s, t, h, kvh, hd, torch.float32, 11)
    w = torch.randn((b, h, s, hd), device=dev)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    grads = []
    for fn in (kfa.flash_attention, kfa.attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*leaves, **kw).transpose(1, 2) * w).sum().backward()
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("b,s,t,h,kvh,hd,causal,window,q_offset", CARD)
def test_function_gradient_matches_autograd_of_plain(dev, b, s, t, h, kvh,
                                                      hd, causal, window,
                                                      q_offset):
    _hold_function_gradient(dev, b, s, t, h, kvh, hd, causal, window,
                            q_offset)


def test_checkpointed_model_gradient_on_card(dev):
    """A small dense config (head_dim 64) on the card: remat="full" gives
    the gradients of "none" with twice the forward launches, and "dots"
    and "outputs" the same gradients too."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=256,
                      n_heads=6, n_kv_heads=2, head_dim=64, d_ff=512,
                      vocab_size=1000, dtype="float32")
    params = build_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, 1000, (2, 130), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in ("none", "full", "dots", "outputs"):
        model = build_model(cfg, remat=remat)
        n_fwd, n_bwd = kfa.LAUNCHES, kfa.BWD_LAUNCHES
        loss, grads = value_and_grad(lambda p, bt: model.loss_fn(p, bt)[0],
                                     params, batch)
        torch.cuda.synchronize()
        out[remat] = (loss, grads, kfa.LAUNCHES - n_fwd,
                      kfa.BWD_LAUNCHES - n_bwd)
    assert out["none"][2:] == (2, 2)
    assert out["full"][2:] == (4, 2)
    for remat in ("full", "dots", "outputs"):
        assert float(out[remat][0]) == float(out["none"][0])
        for (path, a), (_, b) in zip(leaves_with_paths(out[remat][1]),
                                     leaves_with_paths(out["none"][1])):
            assert torch.equal(a, b), (remat, path)


def test_model_prefill_runs_the_kernel_on_card(dev):
    """A small dense config with head_dim 64: prefill on the card launches
    the kernel once a layer and agrees with the plain path."""
    from repro_torch.configs import ModelConfig
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.models.registry import build_model

    cfg = ModelConfig(name="tiny", family="dense", n_layers=3, d_model=256,
                      n_heads=6, n_kv_heads=2, head_dim=64, d_ff=512,
                      vocab_size=1000, dtype="float32")
    model = build_model(cfg)
    plain = build_model(cfg, dispatch=DispatchConfig(path="reference"))
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, 1000, (2, 150), device=dev)
    with torch.inference_mode():
        before = kfa.LAUNCHES
        got, cache = model.prefill(params, {"tokens": toks}, pad_to=160)
        assert kfa.LAUNCHES == before + cfg.n_layers
        want, ref_cache = plain.prefill(params, {"tokens": toks}, pad_to=160)
        assert kfa.LAUNCHES == before + cfg.n_layers
        torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert cache["pos0"]["k"].shape == (3, 2, 160, 2, 64)
