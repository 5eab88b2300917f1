"""The port's model layer: the dense, MoE, context-conditioned
(encoder-decoder, gated cross-attention) and recurrent (Mamba, mLSTM,
sLSTM) families, full-sequence forward, the encoder, one-pass prefill and
decode."""
from . import moe, ssm
from .common import ModelConfig, dense, embed_lookup, rms_norm, rotary_embed
from .convert import params_from_jax
from .transformer import (RunCtx, context_conditioned, decode_step, encode,
                          forward, forward_with_stats, init_cache,
                          init_params, loss_fn, num_params, positional_cache,
                          prefill, recurrent, unembed)

__all__ = [
    "ModelConfig", "RunCtx", "context_conditioned", "decode_step", "dense",
    "embed_lookup", "encode", "forward",
    "forward_with_stats", "init_cache", "init_params", "loss_fn", "moe",
    "num_params",
    "params_from_jax", "positional_cache", "prefill", "recurrent",
    "rms_norm", "rotary_embed", "ssm", "unembed",
]
