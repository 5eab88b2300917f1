"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2; Mamba+attn 1:7 interleave. [arXiv:2403.19887; hf]

A period of 8 with attention at slot 4 (jamba's attn_layer_period=8,
attn_layer_offset=4) and an MoE FFN on every odd slot (expert_layer_period=2,
offset=1).  51.6 B parameters (~103 GB in bf16): one card holds one period
(8 layers, 13.3 B).  Field for field the JAX package's config.
"""
from ..models.common import ModelConfig

ARCH_ID = "jamba-v0.1-52b"

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
            "mamba")
_FFN = ("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe")


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=65536,
        layer_pattern=_PATTERN, ffn_pattern=_FFN,
        num_experts=16, moe_top_k=2, d_ff_expert=14336,
        norm_topk_prob=True,
        d_state=16, d_conv=4, ssm_expand=2,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        layer_pattern=_PATTERN, ffn_pattern=_FFN,
        num_experts=8, moe_top_k=2, d_ff_expert=64,
        d_state=8, d_conv=4, ssm_expand=2,
        subquadratic=True,
    )
