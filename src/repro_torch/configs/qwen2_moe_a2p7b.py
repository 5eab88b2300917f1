"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408 (expert)
vocab=151936, MoE 60e top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 routed experts are padded to 64 for clean 16-way EP divisibility; the 4
pad experts are masked to -1e30 in the router and never receive tokens
(``models/moe.py::route``).  Shared expert capacity = 4 x 1408 = 5632.
Field for field the JAX package's config, which the port follows rather
than HF's Qwen1.5-MoE: the shared experts are added ungated (HF scales them
by a sigmoid gate of their own), and ``norm_topk_prob`` is off.
"""
from ..models.common import ModelConfig

ARCH_ID = "qwen2-moe-a2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=151936,
        layer_pattern=("attn",), ffn_pattern=("moe",),
        num_experts=64, num_padded_experts=4,
        num_shared_experts=4, moe_top_k=4, d_ff_expert=1408,
        norm_topk_prob=False, qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=512,
        layer_pattern=("attn",), ffn_pattern=("moe",),
        num_experts=8, num_padded_experts=1,
        num_shared_experts=2, moe_top_k=2, d_ff_expert=32,
        norm_topk_prob=False, qkv_bias=True,
    )
