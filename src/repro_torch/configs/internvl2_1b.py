"""InternVL2-1B [arXiv:2404.16821; hf]: the Qwen2-0.5B LM tower with the
vision encoder stubbed.

The batch carries ``vision_prefix_len`` patch embeddings
(``vision_embeds``), prepended to the token sequence.  They may come from
JPEG coefficients through a folded patch projection
(``core.transform_linear.fold_patch_embed``).
"""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151655, rope_theta=1_000_000.0,
        tie_embeddings=True, vision_prefix_len=256, frontend_stub=True,
        source="[arXiv:2404.16821; hf] InternViT + InternLM2/Qwen2 tower",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-reduced", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, vision_prefix_len=16, frontend_stub=True,
        tie_embeddings=True, dtype="float32",
    )
