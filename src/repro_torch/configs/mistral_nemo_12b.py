"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407; hf]."""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072, rope_theta=1_000_000.0,
        source="[hf:mistralai/Mistral-Nemo-Base-2407; hf] 128k ctx",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, rope_theta=1_000_000.0, dtype="float32",
    )
