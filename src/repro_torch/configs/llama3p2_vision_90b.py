"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; gated cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision family]

The vision tower is a stub: ``context_spec`` stands for the precomputed
patch embeddings (B, 1600, d_model).  A period of 5 = 4 self-attention
layers + 1 gated cross-attention (``xattn``) layer, 20 cross-attention
layers in 100.  Field for field the JAX package's config.
"""
from ..models.common import ModelConfig

ARCH_ID = "llama-3.2-vision-90b"

_PATTERN = ("attn", "attn", "attn", "attn", "xattn")


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=128256,
        layer_pattern=_PATTERN, ffn_pattern=("dense",) * 5,
        num_image_tokens=1600, rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        layer_pattern=_PATTERN, ffn_pattern=("dense",) * 5,
        num_image_tokens=12,
    )
