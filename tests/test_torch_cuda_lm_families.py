"""The RWKV, VLM and audio families on the card.

* The flash-attention kernel, forward and backward, at the shapes these
  models give it: ``whisper-small``'s non-causal encoder (S = T = 1500, not
  a multiple of the key tile, 12 heads over 12), its cross-attention (448
  decoder queries over 1500 frames) and ``internvl2-1b``'s prefill (14
  heads over 2: G = 7), in fp32 (within 2e-4 of the plain version, and
  the backward within 1e-4 of the largest gradient) and bf16 (at most 1.5×
  the bf16 plain version's error against fp32), batch 1, through the
  training path (the forward writes its output's bf16 rounding residual,
  which the backward's D reads).
* That residual: with values sharing a common part, where D from the
  rounded output alone put the gradients of q and k past the gate, the
  kernels stay within 1.5× the error of autograd through the bf16 plain
  forward; the residual is below half a bf16 ulp of the output and not
  all zero.  A bf16 backward without it, or an fp32 one with it, raises.
* ``rwkv6-7b-reduced`` in fp32 on the card against the same weights and
  tokens on the CPU: forward logits, prefill and decode, and the loss
  gradient: activations, logits and states within 1e-5 of the largest
  |value|, gradients within 1e-4 (fp32 sums in another order on the card,
  over up to 138 tokens and 64 channels a head).
* ``serve --arch`` of the three archs (reduced, decode-only from
  ``init_cache``), every request completed.

Needs an NVIDIA GPU of compute capability 9.0 and ``nvcc``; skipped
elsewhere.  Run on the card with ``python -m pytest -q
tests/test_torch_cuda_lm_families.py``.
"""
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths, tree_map

pytestmark = pytest.mark.cuda

#: label, s, t, h, kvh, causal
SHAPES = [("whisper encoder", 1500, 1500, 12, 12, False),
          ("whisper cross-attention", 448, 1500, 12, 12, False),
          ("internvl2 prefill, G = 7", 2304, 2304, 14, 2, True)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (capability 9.0)")
    _build.library()
    return torch.device("cuda", 0)


def _qkv(dev, s, t, h, kvh, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((1, s, h, 64), (1, t, kvh, 64), (1, t, kvh, 64),
                          (1, s, h, 64))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_attention_at_the_new_shapes_matches_plain(dev, shape, dtype):
    _, s, t, h, kvh, causal = shape
    q, k, v, do = _qkv(dev, s, t, h, kvh, dtype, 0)
    kw = dict(causal=causal)
    f32 = [x.float() for x in (q, k, v, do)]
    o32, l32 = kfa.attention_lse_plain(*f32[:3], **kw)
    exact = kfa.attention_backward_plain(*f32[:3], o32, f32[3], l32, **kw)
    out, lse, lo = kfa.flash_attention_lse(q, k, v, **kw)
    got = kfa.flash_attention_backward(q, k, v, out, do, lse, out_lo=lo,
                                       **kw)
    if dtype == torch.float32:
        assert float((out - o32).abs().max()) <= 2e-4
        for g, w in zip(got, exact):
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
        return
    o_p, l_p = kfa.attention_lse_plain(q, k, v, **kw)
    assert float((out.float() - o32).abs().max()) \
        <= 1.5 * float((o_p.float() - o32).abs().max())
    plain = kfa.attention_backward_plain(q, k, v, o_p, do, l_p, **kw)
    for g, p, w in zip(got, plain, exact):
        assert torch.isfinite(g).all()
        assert float((g.float() - w).abs().max()) \
            <= 1.5 * float((p.float() - w).abs().max())


def test_rwkv_on_the_card_equals_the_cpu(dev):
    cfg = reduced_config("rwkv6-7b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    on_card = tree_map(lambda x: x.to(dev), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :69], "labels": toks[:, 1:]}

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    want, _ = T.forward(params, cfg, batch)
    got, _ = T.forward(on_card, cfg, tree_map(lambda x: x.to(dev), batch))
    assert rel(got, want) < 1e-5
    w_last, w_cache = T.prefill(params, cfg, {"tokens": toks[:, :65]})
    g_last, g_cache = T.prefill(on_card, cfg,
                                {"tokens": toks[:, :65].to(dev)})
    for t in range(65, 69):
        assert rel(g_last, w_last) < 1e-5
        w_last, w_cache = T.decode_step(params, cfg, w_cache,
                                        {"tokens": toks[:, t:t + 1]})
        g_last, g_cache = T.decode_step(on_card, cfg, g_cache,
                                        {"tokens": toks[:, t:t + 1].to(dev)})
    for (path, a), (_, b) in zip(leaves_with_paths(g_cache),
                                 leaves_with_paths(w_cache)):
        if path != "['index']":
            assert rel(a, b) < 1e-5, path
    loss_w, g_w = value_and_grad(lambda p, b: T.loss_fn(p, cfg, b)[0],
                                 params, batch)
    loss_g, g_g = value_and_grad(lambda p, b: T.loss_fn(p, cfg, b)[0],
                                 on_card, tree_map(lambda x: x.to(dev),
                                                   batch))
    assert abs(float(loss_g) - float(loss_w)) < 1e-5 * abs(float(loss_w))
    for (path, a), (_, b) in zip(leaves_with_paths(g_g),
                                 leaves_with_paths(g_w)):
        assert rel(a, b) < 1e-4, path


def test_output_residual_on_the_card(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((2, 256, 4, 64), (2, 256, 4, 64),
                                 (2, 256, 4, 64), (2, 256, 4, 64)))
    q, k, v, do = (x.bfloat16() for x in (q, k, 3 + 0.1 * v, do))
    f32 = [x.float() for x in (q, k, v, do)]
    o32, l32 = kfa.attention_lse_plain(*f32[:3])
    exact = kfa.attention_backward_plain(*f32[:3], o32, f32[3], l32)
    out, lse, lo = kfa.flash_attention_lse(q, k, v)
    assert lo is not None and lo.dtype == torch.bfloat16
    assert bool((lo.float().abs() <= out.float().abs() * 2 ** -8).all())
    assert bool(lo.any())
    got = kfa.flash_attention_backward(q, k, v, out, do, lse, out_lo=lo)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = torch.autograd.grad(kfa.attention_plain(*leaves), leaves, do)
    for g, p, w in zip(got, plain, exact):
        assert float((g.float() - w).abs().max()) \
            <= 1.5 * float((p.float() - w).abs().max())
    assert kfa.flash_attention_lse(q.float(), k.float(), v.float())[2] \
        is None
    # the residual is the bf16 backward's input, not an option; fp32 has none
    with pytest.raises(ValueError, match="out_lo"):
        kfa.flash_attention_backward(q, k, v, out, do, lse)
    f32 = [x.float() for x in (q, k, v)]
    out32, lse32, _ = kfa.flash_attention_lse(*f32)
    with pytest.raises(ValueError, match="out_lo"):
        kfa.flash_attention_backward(*f32, out32, do.float(), lse32,
                                     out_lo=lo)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "internvl2-1b",
                                  "whisper-small"])
def test_serve_entry_point_on_the_card(dev, arch):
    out = serve.main(["--arch", arch, "--reduced", "--requests", "6",
                      "--max-new", "5"])
    assert out["completed"] == 6 and out["decode_tokens"] > 0
