"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304; sLSTM + mLSTM
blocks in 7:1 ratio (xLSTM[7:1]). [arXiv:2405.04517]

The blocks carry their own up / down projections (mLSTM proj factor 2, its
q / k / v 4096 x 4 x 1024 each; sLSTM a gated MLP of 4/3), so every FFN is
``none``.  3.57 B parameters as configured (the mLSTM projections make it
larger than its name).  Field for field the JAX package's config.
"""
from ..models.common import ModelConfig

ARCH_ID = "xlstm-1.3b"

_PATTERN = ("mlstm",) * 7 + ("slstm",)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        head_dim=512, d_ff=0, vocab_size=50304,
        layer_pattern=_PATTERN, ffn_pattern=("none",) * 8,
        mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=0, vocab_size=512,
        layer_pattern=_PATTERN, ffn_pattern=("none",) * 8,
        subquadratic=True,
    )
