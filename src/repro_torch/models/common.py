"""Model substrate: config, norms, rotary embeddings, projections.

The port of ``repro/models/common.py`` for the dense and MoE families.
Parameters are plain nested dicts of tensors with the JAX package's shapes,
so weights carry over leaf for leaf (:mod:`repro_torch.models.convert`).
Where bf16 rounds follows the JAX package's default ``_F32_CHAINS = False``
policy: f32 only for variance reductions, attention scores and softmax;
norms, rotary and projections multiply and emit in the activation dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's model config, cut to the fields the dense and MoE
    families read (the SSM / MLA / encoder fields come with those slices).
    Layer ``i`` has block type ``layer_pattern[i % period]`` and FFN type
    ``ffn_pattern[i % period]``; the port runs ``attn`` and ``local``
    (attention within ``sliding_window`` keys) blocks with ``dense`` or
    ``moe`` FFNs."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 4096       # for 'local' blocks
    layer_pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("dense",)
    # -- MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 1.25
    num_padded_experts: int = 0      # trailing experts masked out of routing
                                     # (qwen2-moe: 60 real + 4 pads for EP=16)
    act_fn: str = "silu"             # silu | gelu
    gated_ffn: bool = True           # SwiGLU vs plain MLP
    scale_embed: bool = False        # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16   # activation/weight dtype

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if len(self.layer_pattern) != len(self.ffn_pattern):
            raise ValueError("layer_pattern and ffn_pattern must be "
                             "slot-aligned")

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    def block_type(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % self.period]

    def ffn_type(self, layer_idx: int) -> str:
        return self.ffn_pattern[layer_idx % self.period]

    def num_params(self) -> int:
        """Parameter count from the shapes ``init_params`` makes (on the
        meta device: nothing is allocated)."""
        from .transformer import init_params, num_params
        return num_params(init_params(self, torch.Generator(), device="meta"))

    def num_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k routed experts;
        the padded experts count as inactive, as the JAX package counts
        them)."""
        total = self.num_params()
        if self.num_experts == 0:
            return total
        per_expert = 3 * self.d_model * self.d_ff_expert
        n_moe = sum(1 for i in range(self.num_layers)
                    if self.ffn_type(i) == "moe")
        return total - (self.num_experts - self.moe_top_k) * per_expert * n_moe


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: float32 for the variance reduction; the multiplies stay in
    x's dtype (as ``common.py:rms_norm`` with ``_F32_CHAINS = False``)."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * gamma.to(x.dtype)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """Rotary position embedding on the half-split halves x[:half], x[half:].

    x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    The sin/cos tables are float32 and the rotation multiplies in x's dtype.
    """
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., seq, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over x's last axis and w's first, emitted in x's dtype."""
    out = torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1))
    return out.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def init_normal(gen: torch.Generator, shape: Tuple[int, ...],
                fan_in: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The JAX package's initializer: normal(0, 1) * 1/sqrt(fan_in) drawn in
    float32 and cast (the ``param`` initializer of ``models/common.py``).
    The numbers come from ``gen``, not from JAX's PRNG."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)
