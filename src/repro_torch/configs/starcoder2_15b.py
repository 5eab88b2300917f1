"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA, RoPE, non-gated GELU MLP, bias. [arXiv:2402.19173; hf]

Field for field the JAX package's config."""
from ..models.common import ModelConfig

ARCH_ID = "starcoder2-15b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        head_dim=128, d_ff=24576, vocab_size=49152,
        qkv_bias=True, rope_theta=100_000.0,
        act_fn="gelu", gated_ffn=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=8, num_kv_heads=4,
        head_dim=8, d_ff=256, vocab_size=512,
        qkv_bias=True, act_fn="gelu", gated_ffn=False,
    )
