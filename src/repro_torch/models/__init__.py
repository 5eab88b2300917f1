"""The port's model layer: the dense transformer family, decode path."""
from .common import ModelConfig, dense, embed_lookup, rms_norm, rotary_embed
from .convert import params_from_jax
from .transformer import (decode_step, init_cache, init_params, num_params,
                          positional_cache, unembed)

__all__ = [
    "ModelConfig", "decode_step", "dense", "embed_lookup", "init_cache",
    "init_params", "num_params", "params_from_jax", "positional_cache",
    "rms_norm", "rotary_embed", "unembed",
]
