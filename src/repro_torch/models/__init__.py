"""The port's model layer: the dense transformer family, full-sequence
forward, one-pass prefill and decode."""
from .common import ModelConfig, dense, embed_lookup, rms_norm, rotary_embed
from .convert import params_from_jax
from .transformer import (decode_step, forward, init_cache, init_params,
                          num_params, positional_cache, prefill, unembed)

__all__ = [
    "ModelConfig", "decode_step", "dense", "embed_lookup", "forward",
    "init_cache", "init_params", "num_params", "params_from_jax",
    "positional_cache", "prefill", "rms_norm", "rotary_embed", "unembed",
]
