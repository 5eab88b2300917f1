"""The port's model layer: the dense and MoE transformer families,
full-sequence forward, one-pass prefill and decode."""
from . import moe
from .common import ModelConfig, dense, embed_lookup, rms_norm, rotary_embed
from .convert import params_from_jax
from .transformer import (decode_step, forward, forward_with_stats,
                          init_cache, init_params, num_params,
                          positional_cache, prefill, unembed)

__all__ = [
    "ModelConfig", "decode_step", "dense", "embed_lookup", "forward",
    "forward_with_stats", "init_cache", "init_params", "moe", "num_params",
    "params_from_jax", "positional_cache", "prefill", "rms_norm",
    "rotary_embed", "unembed",
]
