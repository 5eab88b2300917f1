"""GQA attention with qk-norm and RoPE: the dense family's full-sequence
and decode attention.

The port of the parts of ``repro/models/attention.py`` that serving runs.
Shapes: x (B, S, D); q (B, S, H, hd); k, v (B, S, KV, hd).  The
full-sequence causal :func:`attention` (prefill) runs on the
``flash_attention`` kernel: float32 scores and softmax weights, output in
the activation dtype.  With a per-row query offset and a layer's cache it
is the warm prefill of the radix prefix cache: each row's uncached suffix
attends to its cached prefix rows and to itself in one launch.  A
``window`` (the ``local`` layers of a 5:1 local:global stack) keeps each
query's keys within ``window`` positions of it, in the kernel and in the
decode step's mask alike.  The decode step accumulates scores in float32,
runs softmax in float32 and casts it back to the activation dtype before
the value product, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
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


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window: Optional[int] = None) -> torch.Tensor:
    """(..., Sq, Sk) boolean keep-mask: causal, optionally sliding-window
    (keys ``q_pos - window < k_pos <= q_pos``)."""
    keep = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        keep &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return keep


def query_positions(batch: int, seq: int, q_offset: Optional[torch.Tensor],
                    device) -> torch.Tensor:
    """(B, S) int32 positions of a full-sequence call: ``arange(S)`` per
    row, shifted by the row's query offset when one is given."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    if q_offset is None:
        return pos.expand(batch, seq)
    return q_offset.to(torch.int32)[:, None] + pos


def span_index(start: torch.Tensor, length: int, size: int):
    """Flat row indices ``(dst, src)``, each (B * length,), that write a
    (B, length, ...) span into rows ``[start[b], start[b] + length)`` of a
    contiguous (B, size, ...) cache (see :func:`write_span`), dropping the
    rows past ``size`` (the pad tail of a bucket; ``start[b] < size``).

    Unlike :func:`cache_span_update`, the start is never clamped: moving
    it would shift real suffix rows onto prefix rows.  A row past the end
    is redirected to the last row that fits, carrying that row's own
    value, so the duplicate writes agree and no host sync is needed.  A
    caller that writes many layers computes the indices once.
    """
    start = start.to(torch.long)
    B = start.shape[0]
    j = torch.arange(length, device=start.device)
    src = torch.minimum(j[None, :], (size - 1 - start)[:, None]).clamp_(min=0)
    rows = torch.arange(B, device=start.device)[:, None]
    return ((rows * size + start[:, None] + src).reshape(-1),
            (rows * length + src).reshape(-1))


def write_span(cache: torch.Tensor, new: torch.Tensor, span) -> None:
    """``cache`` (B, size, ...) contiguous, ``new`` (B, length, ...): the
    write :func:`span_index` describes, IN PLACE, as one gather and one
    row copy."""
    dst, src = span
    flat = cache.view(-1, *cache.shape[2:])
    flat.index_copy_(0, dst, new.reshape(-1, *new.shape[2:])
                     .index_select(0, src).to(cache.dtype))


def attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None, *,
              q_offset: Optional[torch.Tensor] = None,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              span=None, window: Optional[int] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention over the full sequence, the counterpart of the
    JAX package's ``attention`` (its XLA and chunked ``attn_state`` forms
    are one function; here it is one launch of the ``flash_attention``
    kernel, on the CPU its plain version).

    Query ``i`` of row ``b`` sits at position ``q_offset[b] + i`` (``i``
    without an offset): RoPE and the causal mask follow from that.
    ``positions`` need not be passed; one that is must equal those
    positions, and any other raises (the kernel's mask cannot follow it).

    Without ``cache`` the keys are the sequence's own: returns the (B, S, D)
    output and the layer's (k, v), each (B, S, KV, hd), for the prefill to
    write into its cache.  With a layer's ``cache`` (k, v), each (B,
    max_seq, KV, hd): the rows ``[q_offset[b], q_offset[b] + S)`` are
    written in place (rows past ``max_seq`` are pads and are dropped; the
    offsets must be below ``max_seq``, the cache tensors contiguous),
    attention runs over the whole cache under the offset mask (keys
    ``<= q_offset[b] + i``: the cached prefix and the suffix so far), and
    the cache is returned as the (k, v);
    ``span`` takes the write indices of :func:`span_index` when the caller
    has them.  ``window`` (a ``local`` layer's) also drops the keys at or
    below ``q_pos - window``, with or without a cache.
    """
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    derived = query_positions(B, S, q_offset, x.device)
    if positions is not None and not torch.equal(
            positions.to(torch.int32).expand(B, S), derived):
        raise ValueError(
            "attention derives its query positions from q_offset (arange(S) "
            "per row, shifted by the row's offset); the positions it was "
            "handed differ, and the kernel's causal mask cannot follow them")
    q, k, v = _project_qkv(p, cfg, x, derived)
    if cache is not None:
        kc, vc = cache
        if span is None:
            start = torch.zeros((B,), dtype=torch.int32, device=x.device) \
                if q_offset is None else q_offset
            span = span_index(start, S, kc.shape[1])
        write_span(kc, k, span)
        write_span(vc, v, span)
        k, v = kc, vc
    # (B, S, heads, hd) viewed as (B, heads, S, hd): the kernel reads the
    # strides (the cache's too: no copy), and its output keeps q's
    # (B, S, H, hd) memory layout
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        q_offset=q_offset, window=window).transpose(1, 2)
    out = o.reshape(B, S, H * hd) @ p["wo"].to(o.dtype).reshape(H * hd, -1)
    return out, (k, v)


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
                     pos: torch.Tensor, *, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Tuple]:
    """One decode step.  x: (B, 1, D); cache: (k, v) each (B, S, KV, hd),
    updated in place; pos: () or (B,) per-slot positions — each row writes
    and masks at its own position, so rows stay independent.  ``window``
    keeps the keys within ``window`` positions of the row's query."""
    kcache, vcache = cache
    B, S = kcache.shape[0], kcache.shape[1]
    positions = decode_positions(pos, B)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    kcache = cache_row_update(kcache, k_new, pos)
    vcache = cache_row_update(vcache, v_new, pos)
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = _gqa_scores(q, kcache, scale)                      # (B,H,1,S)
    keep = _causal_mask(positions, k_pos, window)[:, None]
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_values(w, vcache)                                  # (B,1,H,hd)
    H, hd = o.shape[2], o.shape[3]
    out = o.reshape(B, 1, H * hd) @ p["wo"].to(o.dtype).reshape(H * hd, -1)
    return out, (kcache, vcache)
