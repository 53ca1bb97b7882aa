"""Whisper-small [arXiv:2212.04356; unverified]: encoder-decoder, the
conv/mel frontend stubbed.

The batch carries precomputed frame embeddings (``frames``, ``(B, T_enc,
d_model)``) for the encoder and tokens for the decoder.  A training batch
of ``seq`` takes ``seq`` frames and ``max(seq // 8, 8)`` tokens
(``models.registry.input_specs``); prefill is the encoder forward; decode
steps the decoder against a self-attention cache and a cross cache of
``encoder_context_len`` frames.
"""
from repro_torch.configs import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=51865, use_rope=False,
        encoder_decoder=True, n_encoder_layers=12, cross_attention=True,
        frontend_stub=True, encoder_context_len=1500,
        source="[arXiv:2212.04356; unverified] enc-dec, conv frontend stub",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-reduced", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, use_rope=False,
        encoder_decoder=True, n_encoder_layers=2, cross_attention=True,
        frontend_stub=True, encoder_context_len=32, dtype="float32",
    )
