"""The MoE and hybrid LMs on the card: their bf16 gradients are
deterministic.

The MoE dispatch and combine move rows with gathers in the forward and the
backward (``models/moe.py``), so two gradient calls on the same inputs give
the same bits; a float scatter-add would sum with atomics in whatever
order they land.  Needs an NVIDIA GPU of compute capability 9.0 and
``nvcc`` (the attention runs the flash-attention kernel, which takes head
dims 64 and 128, so the reduced configs run at head_dim 64); skipped
elsewhere.  Run on the card with ``python -m pytest -q
tests/test_torch_cuda_moe.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.optim import value_and_grad
from repro_torch.tree import leaves_with_paths

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (capability 9.0)")
    _build.library()
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bf16_moe_ffn_gradient_is_deterministic_on_card(dev):
    """4096 tokens, 8 experts, top-2: every expert gets ~1000 pairs, so a
    token's gradient sums k slots and an atomic scatter would race."""
    cfg = dataclasses.replace(reduced_config("mixtral-8x7b"), d_model=256,
                              d_ff=512, n_experts=8, dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {"router": torch.randn((256, 8), generator=gen, device=dev) / 16,
         **{k: (torch.randn(s, generator=gen, device=dev) / 16).bfloat16()
            for k, s in (("w_gate", (8, 256, 512)), ("w_in", (8, 256, 512)),
                         ("w_out", (8, 512, 256)))}}
    x = torch.randn((4, 1024, 256), generator=gen, device=dev).bfloat16()
    dy = torch.randn_like(x)

    def grads():
        xi = x.clone().requires_grad_()
        pi = {k: v.clone().requires_grad_() for k, v in p.items()}
        out, aux = moe.moe_ffn(xi, pi, cfg)
        torch.autograd.backward((out, aux), (dy, torch.ones_like(aux)))
        return [xi.grad] + [pi[k].grad for k in sorted(pi)]

    first, second = grads(), grads()
    for a, b in zip(first, second):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b",
                                  "jamba-v0.1-52b"])
def test_bf16_lm_gradient_is_deterministic_on_card(dev, arch):
    cfg = dataclasses.replace(reduced_config(arch), head_dim=64,
                              dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 257),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n_bwd = kfa.BWD_LAUNCHES
    runs = [value_and_grad(lambda p, b: model.loss_fn(p, b)[0], params,
                           batch) for _ in range(2)]
    assert kfa.BWD_LAUNCHES > n_bwd
    (l1, g1), (l2, g2) = runs
    assert torch.isfinite(l1) and torch.equal(l1, l2)
    for (path, a), (_, b) in zip(leaves_with_paths(g1),
                                 leaves_with_paths(g2)):
        assert torch.equal(_bits(a), _bits(b)), path
