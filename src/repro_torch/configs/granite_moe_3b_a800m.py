"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-3b-a800m-base; hf].

40 experts, top-8, per-expert d_ff=512: every layer is MoE.
"""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49155, rope_theta=10_000.0, tie_embeddings=True,
        n_experts=40, experts_per_token=8,
        source="[hf:ibm-granite/granite-3.0-3b-a800m-base; hf] 40e top-8",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512, n_experts=4, experts_per_token=2,
        tie_embeddings=True, dtype="float32",
    )
