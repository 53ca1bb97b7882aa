"""Mixtral-8x7B [arXiv:2401.04088; hf]. 8 experts top-2, sliding-window
attention."""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000, rope_theta=1_000_000.0,
        sliding_window=4096, n_experts=8, experts_per_token=2,
        source="[arXiv:2401.04088; hf] 8e top-2, SWA",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-reduced", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=64,
        n_experts=4, experts_per_token=2, dtype="float32",
    )
