"""StarCoder2-3B [arXiv:2402.19173; hf]: GQA and RoPE, with full attention
(no sliding window)."""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
        d_ff=12288, vocab_size=49152, rope_theta=100_000.0,
        source="[arXiv:2402.19173; hf] GQA, RoPE",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-reduced", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=192, vocab_size=512, dtype="float32",
    )
