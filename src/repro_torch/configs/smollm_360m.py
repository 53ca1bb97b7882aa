"""SmolLM-360M (llama-arch small) [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab_size=49152, rope_theta=10_000.0, tie_embeddings=True,
        source="[hf:HuggingFaceTB/SmolLM-135M; hf] llama-arch small",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-reduced", family="dense",
        n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=128, vocab_size=512, tie_embeddings=True, dtype="float32",
    )
