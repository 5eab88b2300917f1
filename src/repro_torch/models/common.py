"""Model substrate: config, norms, rotary embeddings, projections.

The port of ``repro/models/common.py`` for the dense, MoE and
context-conditioned (encoder-decoder, gated cross-attention) families.
Parameters are plain nested dicts of tensors with the JAX package's shapes,
so weights carry over leaf for leaf (:mod:`repro_torch.models.convert`).
Where bf16 rounds follows the JAX package's default ``_F32_CHAINS = False``
policy: f32 only for variance reductions, attention scores and softmax;
norms, rotary and projections multiply and emit in the activation dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import dist
from ..dist import sharding as shd

# the logical axes of every decode-cache leaf, by leaf name (the JAX
# package's ``launch/steps.py`` ``_CACHE_AXES``): ``launch.steps`` gives
# them to the cache's specs and :func:`cache_leaf` allocates this rank's
# block by them
CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "xk": ("batch", None, "kv_heads", None),
    "xv": ("batch", None, "kv_heads", None),
    "lat_c": ("batch", "kv_seq", None),
    "lat_r": ("batch", "kv_seq", None),
    "ssm_h": ("batch", "mlp", None),
    "ssm_conv": ("batch", None, "mlp"),
    "ml_C": ("batch", "heads", None, None),
    "ml_n": ("batch", "heads", None),
    "sl_h": ("batch", "heads", None),
    "sl_c": ("batch", "heads", None),
    "pos": (),
}


def cache_cut(name: str, shape, dim: int) -> Tuple[str, ...]:
    """The mesh axes dimension ``dim`` of the decode-cache leaf ``name``
    (global ``shape``) is cut over in the active rules scope (() outside
    one).  The batch is this rank's already: it is never cut again."""
    return shd.cut((None,) + CACHE_AXES[name][1:], shape, dim)


def cache_leaf(name: str, shape, dtype: torch.dtype,
               device) -> torch.Tensor:
    """A zeroed decode-cache leaf: this rank's block of a ``shape`` leaf
    under ``CACHE_AXES[name]`` in the active rules scope (the whole leaf
    outside one); ``shape[0]`` is this rank's batch."""
    names = (None,) + CACHE_AXES[name][1:]
    return torch.zeros(shd.local_shape(names, shape), dtype=dtype,
                       device=device)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's model config, cut to the fields the dense, MoE,
    MLA, context-conditioned and recurrent families read.  Layer ``i`` has
    block type ``layer_pattern[i % period]`` and FFN type
    ``ffn_pattern[i % period]``, but for the first ``prelude_dense_layers``
    layers, whose FFN is dense (DeepSeek-V2's first_k_dense_replace); the
    port runs ``attn`` (MLA's latent attention with ``use_mla``),
    ``local`` (attention within ``sliding_window`` keys), ``xattn`` (gated
    cross-attention to the context), ``mamba``, ``mlstm`` and ``slstm``
    blocks with ``dense``, ``moe`` or no (``none``) FFN, an encoder of
    ``encoder_layers`` bidirectional layers over the context (whisper), and
    with ``decoder_cross_attn`` a cross-attention after every ``attn`` /
    ``local`` layer's self-attention."""

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
    prelude_dense_layers: int = 0
    # -- MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 1.25
    num_padded_experts: int = 0      # trailing experts masked out of routing
                                     # (qwen2-moe: 60 real + 4 pads for EP=16)
    # -- MLA (DeepSeek-V2)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # -- SSM (Mamba)
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    # -- xLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333
    # -- encoder-decoder (whisper): the decoder uses the main fields
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper 30s @ 50Hz after the conv stub
    # -- vision cross-attention (llama-3.2-vision)
    num_image_tokens: int = 0        # stubbed patch-embedding count
    act_fn: str = "silu"             # silu | gelu
    gated_ffn: bool = True           # SwiGLU vs plain MLP
    scale_embed: bool = False        # multiply embeddings by sqrt(d_model)
    decoder_cross_attn: bool = False # every attn layer also cross-attends
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16   # activation/weight dtype
    # long-context capability: True for SSM/hybrid archs (O(1)/chunked state)
    subquadratic: bool = False

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
        if layer_idx < self.prelude_dense_layers:
            return "dense"
        return self.ffn_pattern[layer_idx % self.period]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

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
             eps: float = 1e-6, axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """RMSNorm: float32 for the variance reduction; the multiplies stay in
    x's dtype (as ``common.py:rms_norm`` with ``_F32_CHAINS = False``).
    With mesh ``axes``, x and gamma are this rank's block of a last
    dimension cut over them: the sum of squares is summed over the axes,
    and the (replicated) variance enters the blocks through ``dist.enter``,
    so its cotangent is every block's."""
    sq = torch.square(x.to(torch.float32))
    if axes:
        var = dist.enter(dist.psum(sq.sum(dim=-1, keepdim=True), axes),
                         axes) / (x.shape[-1] * dist.axis_size(axes))
    else:
        var = torch.mean(sq, dim=-1, keepdim=True)
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


def add_rows(n_rows: int, ids: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """(n_rows, D) zeros plus each of ``rows`` (N, D) added into row
    ``ids[i]``, in a fixed order without atomics: the ids are sorted
    stably, and one segmented sum (``torch.segment_reduce``: an output
    entry's adds run in one thread, in row order) adds each id's rows in
    their order in ``ids``, each add rounded to the rows' dtype.  That is
    the order of a sequential ``index_add_`` in ``ids``' order, so the sums
    are the same bit for bit on every run.  One host read: the number of
    distinct ids."""
    ids = ids.reshape(-1).long()
    rows = rows.reshape(ids.numel(), rows.shape[-1])
    out = rows.new_zeros((n_rows, rows.shape[1]))
    if ids.numel() == 0:
        return out
    order = torch.argsort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
    sums = torch.segment_reduce(rows[order], "sum", lengths=counts,
                                unsafe=True)
    return out.index_copy_(0, uniq, sums)


class _Lookup(torch.autograd.Function):
    """``table[ids]`` (zeros where ``keep`` is False); backward: the
    cotangent rows added into the ids' rows by :func:`add_rows`."""

    @staticmethod
    def forward(ctx, table, ids, keep):
        ctx.save_for_backward(ids, keep)
        ctx.rows = table.shape[0]
        out = table[ids]
        return out if keep is None else out.masked_fill(~keep[..., None], 0)

    @staticmethod
    def backward(ctx, g):
        ids, keep = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        ids = ids.reshape(-1)
        if keep is not None:
            mine = keep.reshape(-1)
            ids, g = ids[mine], g[mine]
        return add_rows(ctx.rows, ids, g), None, None


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``embedding[tokens]``, zeros where ``keep`` (tokens' shape) is
    False; its backward adds the cotangent rows in a fixed order
    (:func:`add_rows`), deterministic where ``embedding[tokens]``'s
    backward on the card is not."""
    if torch.is_grad_enabled() and embedding.requires_grad:
        return _Lookup.apply(embedding, tokens, keep)
    out = embedding[tokens]
    return out if keep is None else out.masked_fill(~keep[..., None], 0)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over x's last axis and w's first, emitted in x's dtype."""
    out = torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1))
    return out.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def row_parallel(x: torch.Tensor, w: torch.Tensor, axes) -> torch.Tensor:
    """``x @ w`` (``w`` 2-d) when w's rows, and x's last dim, are this
    rank's block of a dimension cut over mesh ``axes``: the float32
    products of the blocks are summed over the axes and rounded once to
    x's dtype, as the unsharded product rounds its float32 sum once.
    Without axes, ``x @ w`` in x's dtype.  Differentiable: the psum's
    backward passes the (replicated) cotangent to every rank's block."""
    if not axes:
        return x @ w.to(x.dtype)
    part = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return dist.psum(part, axes).to(x.dtype)


def init_normal(gen: torch.Generator, shape: Tuple[int, ...],
                fan_in: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The JAX package's initializer: normal(0, 1) * 1/sqrt(fan_in) drawn in
    float32 and cast (the ``param`` initializer of ``models/common.py``).
    The numbers come from ``gen``, not from JAX's PRNG."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)
