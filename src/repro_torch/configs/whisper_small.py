"""whisper-small [audio] — 12L (enc) + 12L (dec) d_model=768 12H d_ff=3072
vocab=51865; enc-dec, conv frontend STUB. [arXiv:2212.04356]

The conv1d audio frontend is a stub: ``context_spec`` stands for the
precomputed frame embeddings (B, 1500, 768) that the encoder reads.  As in
the JAX package, the decoder uses RoPE instead of learned absolute
positions and the norms are RMSNorm.  Field for field the JAX package's
config.
"""
from ..models.common import ModelConfig

ARCH_ID = "whisper-small"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=51865,
        encoder_layers=12, encoder_seq=1500,
        act_fn="gelu", gated_ffn=False, decoder_cross_attn=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        encoder_layers=2, encoder_seq=24,
        act_fn="gelu", gated_ffn=False, decoder_cross_attn=True,
    )
