"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab_size=49155, rope_theta=10_000.0, tie_embeddings=True,
        source="[hf:ibm-granite/granite-3.0-2b-base; hf] GQA",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, tie_embeddings=True, dtype="float32",
    )
