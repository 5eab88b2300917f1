"""Architecture registry of the port, and the assigned input-shape cells.

The JAX package registers ten architectures and the port runs all ten: the
dense family (qwen3-0.6b, qwen2.5-14b, starcoder2-15b and gemma3-1b, its
5:1 local:global stack), the MoE family on one device (qwen2-moe-a2.7b: 60
routed experts plus 4 pads, top-4, 4 shared; deepseek-v2-236b: multi-head
latent attention, a dense first layer, 160 experts top-6, 2 shared), the
context-conditioned family (whisper-small's encoder-decoder,
llama-3.2-vision-90b's gated cross-attention layers) and the recurrent
family (xlstm-1.3b's 7:1 mLSTM:sLSTM stack, jamba-v0.1-52b's 7:1
Mamba:attention stack with MoE FFNs).

``SHAPES`` / ``valid_cells`` / ``context_spec`` / ``input_specs`` are the
JAX package's cells and input stand-ins; the stand-ins are tensors on the
``meta`` device (shape and dtype, no storage) where the JAX package returns
``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..models.common import ModelConfig
from . import (deepseek_v2_236b, gemma3_1b, jamba_v0p1_52b,
               llama3p2_vision_90b, qwen2_moe_a2p7b, qwen2p5_14b, qwen3_0p6b,
               starcoder2_15b, whisper_small, xlstm_1p3b)

_MODULES = {m.ARCH_ID: m for m in (qwen3_0p6b, qwen2p5_14b, starcoder2_15b,
                                     gemma3_1b, qwen2_moe_a2p7b,
                                     whisper_small, llama3p2_vision_90b,
                                     xlstm_1p3b, jamba_v0p1_52b,
                                     deepseek_v2_236b)}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; the port runs {ARCH_IDS}")
    mod = _MODULES[arch_id]
    return mod.smoke_config() if smoke else mod.config()


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def valid_cells(cfg: ModelConfig) -> List[str]:
    """Per-spec skips: long_500k needs sub-quadratic attention."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        cells.append("long_500k")
    return cells


def context_spec(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    """The stubbed modality frontend's output (audio frames / vision
    patches) as a meta tensor, or None for an arch without a context."""
    if cfg.family == "audio":
        return torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                           dtype=cfg.dtype, device="meta")
    if cfg.family == "vlm":
        return torch.empty((batch, cfg.num_image_tokens, cfg.d_model),
                           dtype=cfg.dtype, device="meta")
    return None


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for the data inputs of one cell.

    train  -> {tokens, labels[, context]}
    prefill-> {tokens[, context]}
    decode -> {tokens (B,1)[, context]}
    """
    B, S = shape.global_batch, shape.seq_len

    def ids(shape_):
        return torch.empty(shape_, dtype=torch.int32, device="meta")

    if shape.kind == "train":
        specs = {"tokens": ids((B, S)), "labels": ids((B, S))}
    elif shape.kind == "prefill":
        specs = {"tokens": ids((B, S))}
    else:
        specs = {"tokens": ids((B, 1))}
    ctx = context_spec(cfg, B)
    if ctx is not None:
        specs["context"] = ctx
    return specs
