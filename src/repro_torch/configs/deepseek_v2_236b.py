"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 (expert)
vocab=102400, MoE 160e top-6 + 2 shared; MLA kv_lora=512. [arXiv:2405.04434]

MLA: q_lora_rank=1536, kv_lora_rank=512, qk_rope=64, qk_nope=128, v=128.
The prefill attends with q / k at 192 (128 nope + 64 rope) and v at 128
(one ``flash_attention`` launch per layer at dv != d); the decode step is
the weight-absorbed form, over a cache of (512 + 64) values per token per
layer shared by all 128 heads.  The first layer's FFN is dense (d_ff 12288,
first_k_dense_replace=1); the other 59 are MoE.  About 236 B parameters
(~472 GB in bf16): one card holds the dense prelude and 3 MoE layers (4
layers, 13.3 B).  Field for field the JAX package's config.
"""
from ..models.common import ModelConfig

ARCH_ID = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        d_ff=12288, vocab_size=102400,
        layer_pattern=("attn",), ffn_pattern=("moe",),
        prelude_dense_layers=1,
        num_experts=160, num_shared_experts=2, moe_top_k=6, d_ff_expert=1536,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128, head_dim=192,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        layer_pattern=("attn",), ffn_pattern=("moe",),
        prelude_dense_layers=1,
        num_experts=8, num_shared_experts=2, moe_top_k=2, d_ff_expert=32,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16, head_dim=24,
    )
