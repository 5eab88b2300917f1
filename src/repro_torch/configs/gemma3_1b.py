"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; 5:1 local:global, 128k context. [hf:google/gemma-3-1b-pt]

Layer program: a period of 6 = 5 sliding-window ('local', window 512) + 1
global layer; 26 = 4 full periods + 2 remainder local layers.  head_dim=256
(4 x 256 != d_model: gemma3 uses wide heads).  Embeddings are scaled by
sqrt(d_model) and tied.  Field for field the JAX package's config.
"""
from ..models.common import ModelConfig

ARCH_ID = "gemma3-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
        head_dim=256, d_ff=6912, vocab_size=262144,
        qk_norm=True, rope_theta=1_000_000.0, sliding_window=512,
        layer_pattern=("local",) * 5 + ("attn",), ffn_pattern=("dense",) * 6,
        scale_embed=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512,
        qk_norm=True, sliding_window=8,
        layer_pattern=("local",) * 5 + ("attn",), ffn_pattern=("dense",) * 6,
        scale_embed=True, tie_embeddings=True,
    )
