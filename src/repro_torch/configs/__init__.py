"""Architecture registry of the port: the archs whose model family runs.

The JAX package registers ten architectures; the port so far runs the dense
family, so only qwen3-0.6b is here (the others are later slices).
"""
from __future__ import annotations

from typing import List

from ..models.common import ModelConfig
from . import qwen3_0p6b

_MODULES = {m.ARCH_ID: m for m in (qwen3_0p6b,)}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; the port runs {ARCH_IDS}")
    mod = _MODULES[arch_id]
    return mod.smoke_config() if smoke else mod.config()
