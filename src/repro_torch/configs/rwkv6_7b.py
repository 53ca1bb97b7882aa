"""RWKV-6 (Finch) 7B [arXiv:2404.05892; hf]: attention-free, with a
data-dependent decay."""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=14336, vocab_size=65536, use_rope=False,
        ssm_kind="rwkv6", rwkv_head_size=64,
        source="[arXiv:2404.05892; hf] Finch, data-dependent decay",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-reduced", family="ssm",
        n_layers=2, d_model=64, d_ff=128, vocab_size=512, use_rope=False,
        ssm_kind="rwkv6", rwkv_head_size=16, dtype="float32",
    )
