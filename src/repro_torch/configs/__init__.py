"""Architecture registry of the port: the archs whose model family runs.

The JAX package registers ten architectures; the port so far runs the dense
family (qwen3-0.6b, qwen2.5-14b, starcoder2-15b and gemma3-1b, its 5:1
local:global stack) and the MoE family on one device (qwen2-moe-a2.7b: 60
routed experts plus 4 pads, top-4, 4 shared).  The SSM, MLA,
encoder-decoder and vision archs are later slices.
"""
from __future__ import annotations

from typing import List

from ..models.common import ModelConfig
from . import (gemma3_1b, qwen2_moe_a2p7b, qwen2p5_14b, qwen3_0p6b,
               starcoder2_15b)

_MODULES = {m.ARCH_ID: m for m in (qwen3_0p6b, qwen2p5_14b, starcoder2_15b,
                                     gemma3_1b, qwen2_moe_a2p7b)}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; the port runs {ARCH_IDS}")
    mod = _MODULES[arch_id]
    return mod.smoke_config() if smoke else mod.config()
