"""Jamba-v0.1-52B [arXiv:2403.19887; hf].

Mamba and attention interleaved 1:7 (attention on layer i where i % 8 ==
4, the paper's block layout), MoE every other layer (16 experts, top-2).
"""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536, rope_theta=10_000.0, use_rope=False,
        n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
        attn_every=8, attn_offset=4, ssm_kind="mamba",
        d_state=16, d_conv=4, expand=2,
        source="[arXiv:2403.19887; hf] Mamba+attn 1:7, MoE 16e top-2",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-reduced", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, use_rope=False,
        n_experts=4, experts_per_token=2, moe_every=2, moe_offset=1,
        attn_every=2, attn_offset=1, ssm_kind="mamba",
        d_state=8, d_conv=4, expand=2, dtype="float32",
    )
