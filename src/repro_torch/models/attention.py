"""GQA attention with qk-norm and RoPE: the decode path of the dense family.

The port of the parts of ``repro/models/attention.py`` that serving runs.
Shapes: x (B, S, D); q (B, S, H, hd); k, v (B, S, KV, hd).  Scores
accumulate in float32, softmax runs in float32 and is cast back to the
activation dtype before the value product, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .common import ModelConfig, rms_norm, rotary_embed

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def _project_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype).reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype).reshape(D, KV * hd)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(x.dtype).reshape(D, KV * hd)).reshape(B, S, KV, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotary_embed(q, positions, cfg.rope_theta)
    k = rotary_embed(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B, H, Sq, Sk) float32, GQA grouping."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32)) * scale
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_values(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,H,Sq,Sk) x (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    B, H, Sq, Sk = w.shape
    KV = v.shape[2]
    wg = w.reshape(B, KV, H // KV, Sq, Sk)
    o = torch.einsum("bkgqs,bskh->bqkgh", wg, v)
    return o.reshape(B, Sq, H, v.shape[3])


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(..., Sq, Sk) boolean causal keep-mask."""
    return k_pos[..., None, :] <= q_pos[..., :, None]


def decode_positions(pos: torch.Tensor, batch: int) -> torch.Tensor:
    """(B, 1) query positions from a scalar OR per-row ``pos``."""
    if pos.dim() == 1:
        return pos[:, None].to(torch.int32)
    return pos.to(torch.int32).reshape(1, 1).expand(batch, 1)


def cache_span_update(cache: torch.Tensor, new: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Write a span of rows into a (B, S, ...) cache IN PLACE at scalar or
    per-row start positions ``pos`` and return it.

    Start positions are clamped so the span fits, as ``dynamic_update_slice``
    clamps in the JAX package (an idle slot's position keeps growing).
    """
    S, L = cache.shape[1], new.shape[1]
    if pos.dim() == 0:
        pos = pos.expand(cache.shape[0])
    start = torch.clamp(pos.to(torch.long), 0, S - L)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(L, device=cache.device)[None, :]
    cache[rows, cols] = new.to(cache.dtype)
    return cache


def cache_row_update(cache: torch.Tensor, new: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One new-token row per batch row: the L == 1 case of
    :func:`cache_span_update`."""
    return cache_span_update(cache, new, pos)


def attention_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: Tuple[torch.Tensor, torch.Tensor],
                     pos: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
    """One decode step.  x: (B, 1, D); cache: (k, v) each (B, S, KV, hd),
    updated in place; pos: () or (B,) per-slot positions — each row writes
    and masks at its own position, so rows stay independent."""
    kcache, vcache = cache
    B, S = kcache.shape[0], kcache.shape[1]
    positions = decode_positions(pos, B)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    kcache = cache_row_update(kcache, k_new, pos)
    vcache = cache_row_update(vcache, v_new, pos)
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = _gqa_scores(q, kcache, scale)                      # (B,H,1,S)
    keep = _causal_mask(positions, k_pos)[:, None]
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_values(w, vcache)                                  # (B,1,H,hd)
    H, hd = o.shape[2], o.shape[3]
    out = o.reshape(B, 1, H * hd) @ p["wo"].to(o.dtype).reshape(H * hd, -1)
    return out, (kcache, vcache)
