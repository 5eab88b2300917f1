"""GQA attention with qk-norm and RoPE: full-sequence and decode
self-attention, the encoder's bidirectional attention, cross-attention
to a context (whisper's decoder, llama-3.2-vision's gated image layers),
and DeepSeek-V2's multi-head latent attention (MLA).

The port of the parts of ``repro/models/attention.py`` that serving and
training run.
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

:func:`attention_bidir` (the encoder's self-attention: no mask, no RoPE)
and the full-sequence :func:`cross_attention` (queries from ``x``, keys and
values projected once from the context by :func:`cross_kv`) are one
non-causal ``flash_attention`` launch each, the latter at ``Sq != Sk``.
Cross-attention in the decode step (one query against the cached context)
runs in plain PyTorch as the decode step's self-attention does, so the step
reads nothing back to the host and can be captured in a CUDA graph.

MLA (:func:`init_mla`, :func:`mla_attention`, :func:`mla_decode`) caches
per token only the normalised latent ``c`` (``kv_lora_rank`` wide) and the
rotated ``k_rope`` (``qk_rope_dim``), shared by all heads: the cache
leaves ``lat_c`` (B, max_seq, kvl) and ``lat_r`` (B, max_seq, dr).  The
full sequence up-projects the latent to per-head K (nope + rope, d 192 at
full width) and V (dv 128) and runs one causal ``flash_attention`` launch
at ``dv != d``; the warm prefill writes the suffix's latent rows first and
up-projects the cache's rows.  The decode step is the reference's
weight-absorbed form in plain PyTorch: the query absorbs ``wk_b`` and
attends in the latent space, the output absorbs ``wv_b``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .. import dist
from ..core import monoids
from ..core.aggregation import monoid_allreduce
from ..dist import sharding as shd
from ..kernels.flash_attention import flash_attention
from .common import ModelConfig, dense, rms_norm, row_parallel, rotary_embed

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def _project_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: Optional[torch.Tensor]):
    """q, k, v of ``x``; RoPE at ``positions``, none when they are None.
    The head counts are the weights' (this rank's block under a mesh)."""
    B, S, D = x.shape
    H, KV, hd = p["wq"].shape[1], p["wk"].shape[1], cfg.head_dim
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
    if positions is not None:
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


def _head_cuts(cfg: ModelConfig):
    """(the mesh axes the query heads are cut over, those the KV heads are
    cut over) in the active rules scope; ((), ()) outside one."""
    D, hd = cfg.d_model, cfg.head_dim
    return (shd.cut(("embed", "heads", "head_dim"),
                    (D, cfg.num_heads, hd), 1),
            shd.cut(("embed", "kv_heads", "head_dim"),
                    (D, cfg.num_kv_heads, hd), 1))


def group_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """The KV heads (dim 2) this rank's query heads read, so that query
    head ``j`` of the block reads head ``j // (Hl / KVl)`` of the result.

    Under a mesh the query heads are this rank's block of ``H / P``; when
    the KV heads are cut the same way every GQA group stays whole and k, v
    come back as they are; when the axis does not divide the KV heads
    (``spec_for`` replicates them) the block's groups are sliced out, or
    gathered one per query head where no slice lines them up."""
    hcut, kcut = _head_cuts(cfg)
    if not hcut and not kcut:
        return k, v
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    Hl = H // dist.axis_size(hcut) if hcut else H
    h0, k0 = shd.block_start(hcut, H), shd.block_start(kcut, KV)
    need = [(h0 + j) // G - k0 for j in range(Hl)]
    lo, n = need[0], need[-1] - need[0] + 1
    if Hl % n == 0 and need == [lo + j // (Hl // n) for j in range(Hl)]:
        if lo == 0 and n == k.shape[2]:
            return k, v
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.tensor(need, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _entered(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """(p, x) as the heads cut over a mesh axis read them: under a cut, x
    and the replicated leaves the cut heads read (the qk-norm gains, and
    the KV projections when the axis does not divide the KV heads, which
    each rank then slices) go through ``dist.enter``, so each gets the sum
    of the ranks' partial cotangents; without grad, or a cut, unchanged."""
    hcut, kcut = _head_cuts(cfg)
    if not hcut:
        return p, x
    rep = ("q_norm", "k_norm") + (() if kcut else ("wk", "wv", "bk", "bv"))
    return ({k: dist.enter(t, hcut) if k in rep else t for k, t in
             p.items()}, dist.enter(x, hcut))


def out_proj(p: Dict, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    """(B, S, Hl, dv) head outputs -> (B, S, D) through ``wo``: summed over
    the mesh axes the heads are cut over (:func:`row_parallel`)."""
    B, S, Hl, dv = o.shape
    w = p["wo"]
    cut = shd.cut(("heads", "head_dim", "embed"),
                  (cfg.num_heads,) + tuple(w.shape[1:]), 0)
    return row_parallel(o.reshape(B, S, Hl * dv), w.reshape(Hl * dv, -1),
                        cut)


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
    derived = query_positions(B, S, q_offset, x.device)
    if positions is not None and not torch.equal(
            positions.to(torch.int32).expand(B, S), derived):
        raise ValueError(
            "attention derives its query positions from q_offset (arange(S) "
            "per row, shifted by the row's offset); the positions it was "
            "handed differ, and the kernel's causal mask cannot follow them")
    p, x = _entered(p, cfg, x)
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
    ka, va = group_kv(cfg, k, v)
    # (B, S, heads, hd) viewed as (B, heads, S, hd): the kernel reads the
    # strides (the cache's too: no copy), and its output keeps q's
    # (B, S, H, hd) memory layout
    o = flash_attention(q.transpose(1, 2), ka.transpose(1, 2),
                        va.transpose(1, 2), causal=True,
                        q_offset=q_offset, window=window).transpose(1, 2)
    return out_proj(p, cfg, o), (k, v)


def _flash_out(p: Dict, cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """(B, S, D): non-causal ``flash_attention`` of q (B, Sq, H, hd) over
    k, v (B, Sk, KV, hd), read as (B, heads, S, hd) views, then ``wo``
    (under a mesh the rank's heads over the KV heads they read, summed
    over the axes the heads are cut over)."""
    ka, va = group_kv(cfg, k, v)
    o = flash_attention(q.transpose(1, 2), ka.transpose(1, 2),
                        va.transpose(1, 2), causal=False).transpose(1, 2)
    return out_proj(p, cfg, o)


def attention_bidir(p: Dict, cfg: ModelConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Bidirectional (encoder) self-attention: no mask, no RoPE (whisper's
    encoder adds sinusoidal absolute positions to its features).  One
    non-causal ``flash_attention`` launch; the JAX package's takes
    ``positions`` and ignores them.  Under a mesh x enters the rank's
    heads as in :func:`attention`."""
    p, x = _entered(p, cfg, x)
    q, k, v = _project_qkv(p, cfg, x, None)
    return _flash_out(p, cfg, q, k, v)


def cross_kv(p: Dict, cfg: ModelConfig, context: torch.Tensor):
    """Project a context (B, Sk, D) to (k, v), each (B, Sk, KV, hd), once:
    the decode cache keeps them for every step.  ``k_norm`` when the config
    has qk-norm; no RoPE.  The KV heads are the weights' (this rank's
    under a mesh): the context, replicated, enters them through
    ``dist.enter`` under grad, as x enters :func:`attention`'s."""
    p, context = _entered(p, cfg, context)
    B, Sk, D = context.shape
    KV, hd = p["wk"].shape[1], cfg.head_dim
    k = (context @ p["wk"].to(context.dtype).reshape(D, KV * hd)
         ).reshape(B, Sk, KV, hd)
    v = (context @ p["wv"].to(context.dtype).reshape(D, KV * hd)
         ).reshape(B, Sk, KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def cross_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                    context_kv: Tuple[torch.Tensor, torch.Tensor], *,
                    gated: bool = False, decode: bool = False
                    ) -> torch.Tensor:
    """Attend from ``x`` (B, S, D) to a projected context ``(k, v)`` (from
    :func:`cross_kv`): no mask, no RoPE, ``q_norm`` on the queries when the
    config has qk-norm; ``gated`` scales the output by ``tanh(gate)``
    (llama-3.2-vision's image layers).

    The full sequence is one non-causal ``flash_attention`` launch at
    ``Sq != Sk``.  ``decode=True`` (the decode step's one query per row)
    runs the JAX package's XLA form in plain PyTorch instead: float32
    scores and softmax, the weights cast to the activation dtype before the
    value product.

    Under a mesh the queries are this rank's heads and ``context_kv`` its
    KV heads (``cross_kv`` of its blocks); the output is summed over the
    axes the heads are cut over, before the (replicated) gate, whose
    cotangent is then whole on every rank.  x and ``q_norm`` enter the
    rank's heads through ``dist.enter`` under grad.
    """
    p, x = _entered(p, cfg, x)
    B, S, D = x.shape
    H, hd = p["wq"].shape[1], cfg.head_dim
    q = (x @ p["wq"].to(x.dtype).reshape(D, H * hd)).reshape(B, S, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = context_kv
    if decode:
        ka, va = group_kv(cfg, k, v)
        w = torch.softmax(_gqa_scores(q, ka, 1.0 / math.sqrt(hd)),
                          dim=-1).to(x.dtype)
        out = out_proj(p, cfg, _gqa_values(w, va))
    else:
        out = _flash_out(p, cfg, q, k, v)
    if gated:
        out = torch.tanh(p["gate"].to(out.dtype)) * out
    return out


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
    ka, va = group_kv(cfg, kcache, vcache)
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = _gqa_scores(q, ka, scale)                          # (B,H,1,S)
    keep = _causal_mask(positions, k_pos, window)[:, None]
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_values(w, va)                                      # (B,1,H,hd)
    return out_proj(p, cfg, o), (kcache, vcache)


def _partial_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   keep: Optional[torch.Tensor], scale: float):
    """The ``attn_state`` (m, l, o) of queries q (B, Sq, H, hd) over one
    block of keys k, v (B, Sk, KV, hd): float32 scores, masked keys at
    -inf (a row with none kept gives m = -inf, l = 0, o = 0), the weights
    cast to v's dtype for the value product, as the JAX package's."""
    scores = _gqa_scores(q, k, scale)                           # (B,H,Sq,Sk)
    if keep is not None:
        scores = scores.masked_fill(~keep, -math.inf)
    m = scores.amax(dim=-1)
    msafe = torch.where(torch.isneginf(m), 0.0, m)
    e = torch.exp(scores - msafe[..., None])
    e = torch.where(torch.isneginf(scores), 0.0, e)
    o = _gqa_values(e.to(v.dtype), v).transpose(1, 2).to(torch.float32)
    return m, e.sum(dim=-1), o


def flash_decode_shardmap(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                          cache: Tuple[torch.Tensor, torch.Tensor],
                          pos: torch.Tensor, mesh=None, *,
                          axis_name: str = "model",
                          window: Optional[int] = None):
    """Flash-decoding over a sequence-sharded KV cache: ``cache`` (k, v),
    each (B, S / P, KV, hd), is this rank's contiguous slice of the rows
    (rank ``r`` holds rows ``[r S / P, (r + 1) S / P)``).

    Each rank projects the new token (the attention weights whole), writes
    its (k, v) row IN PLACE only where ``pos`` falls in its slice, computes
    the partial (m, l, o) ``attn_state`` over its rows, and one
    ``monoid_allreduce`` merges the states -- the distributed combiner.
    ``pos`` must be a scalar: per-slot (B,) positions raise
    ``NotImplementedError``, as the JAX package's.  Returns the (B, 1, D)
    output and the cache.  ``mesh`` is bound for the collectives (None:
    the bound mesh)."""
    if pos.dim() == 1:
        raise NotImplementedError(
            "flash decode requires a scalar cache position; per-slot (B,) "
            "positions (continuous batching) run the dense decode path")
    kc, vc = cache
    B, S_l = kc.shape[0], kc.shape[1]
    with dist.maybe_mesh(mesh):
        hcut, _ = _head_cuts(cfg)
        if axis_name in hcut:
            raise ValueError(f"flash decode over {axis_name!r} needs the "
                             f"attention heads whole on it; they are cut "
                             f"over {hcut}")
        start = dist.axis_index(axis_name) * S_l
        positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
        q, k_new, v_new = _project_qkv(p, cfg, x, positions)
        off = pos.to(torch.long) - start
        mine = (off >= 0) & (off < S_l)
        row = off.clamp(0, S_l - 1)
        # the owner writes its row; the others write back what they hold
        kc[:, row] = torch.where(mine, k_new[:, 0].to(kc.dtype), kc[:, row])
        vc[:, row] = torch.where(mine, v_new[:, 0].to(vc.dtype), vc[:, row])
        ka, va = group_kv(cfg, kc, vc)
        k_pos = start + torch.arange(S_l, dtype=torch.int32,
                                     device=x.device).expand(B, S_l)
        keep = _causal_mask(positions, k_pos, window)[:, None]
        state = _partial_state(q, ka, va, keep, 1.0 / math.sqrt(cfg.head_dim))
        state = monoid_allreduce(monoids.attn_state, state, axis_name)
        o = monoids.attn_state.extract(state)                   # (B,H,1,hd)
    return out_proj(p, cfg, o.transpose(1, 2).to(x.dtype)), (kc, vc)


def ring_attention_shardmap(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh=None, *,
                            axis_name: str = "model", causal: bool = True,
                            head_dim_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Ring attention: q, k, v (B, S / P, H or KV, hd) are this rank's
    block of a sequence cut over ``axis_name`` (rank ``r`` holds positions
    ``[r S / P, (r + 1) S / P)``); the K / V blocks travel around the ring
    on :func:`repro_torch.dist.ppermute` while each rank folds the partial
    ``attn_state`` of every block into its queries' -- each hop one
    combine, legal in any arrival order because the combine is
    associative.  Returns this rank's (B, S / P, H, hd) output block."""
    B, S_l, H, hd = q.shape
    scale = head_dim_scale or (1.0 / math.sqrt(hd))
    with dist.maybe_mesh(mesh):
        P = dist.axis_size(axis_name)
        idx = dist.axis_index(axis_name)
        perm = [(j, (j + 1) % P) for j in range(P)]
        ar = torch.arange(S_l, dtype=torch.int32, device=q.device)
        q_pos = (idx * S_l + ar).expand(B, S_l)
        acc = None
        for i in range(P):
            src = (idx - i) % P                  # who produced this block
            keep = None
            if causal:
                k_pos = (src * S_l + ar).expand(B, S_l)
                keep = _causal_mask(q_pos, k_pos)[:, None]
            state = _partial_state(q, k, v, keep, scale)
            acc = state if acc is None else \
                monoids.attn_state.combine(acc, state)
            if i + 1 < P:
                k, v = dist.ppermute((k, v), axis_name, perm)
        out = monoids.attn_state.extract(acc)    # (B,H,S_l,hd)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, normal, ones) -> Dict:
    """One layer's MLA projections (the JAX package's ``init_mla``): the
    query through the ``q_lora_rank`` bottleneck (``wq_a``, ``q_a_norm``,
    ``wq_b``) or straight (``wq``) when the rank is 0; ``wkv_a`` to the
    latent and the rotary key, ``kv_a_norm``, the up-projections ``wk_b`` /
    ``wv_b`` and ``wo``."""
    D, H = cfg.d_model, cfg.num_heads
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    dr, dn, dv = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    if ql > 0:
        mix = {"wq_a": normal((D, ql), D), "q_a_norm": ones(ql),
               "wq_b": normal((ql, H, dn + dr), ql)}
    else:
        mix = {"wq": normal((D, H, dn + dr), D)}
    mix.update(wkv_a=normal((D, kvl + dr), D), kv_a_norm=ones(kvl),
               wk_b=normal((kvl, H, dn), kvl), wv_b=normal((kvl, H, dv), kvl),
               wo=normal((H, dv, D), H * dv))
    return mix


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, L) x (L, H, k) -> (B, S, H, k) in x's dtype."""
    L, H, k = w.shape
    return (x @ w.to(x.dtype).reshape(L, H * k)).reshape(*x.shape[:2], H, k)


def _mla_q(p: Dict, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated at
    ``positions``).  Under a mesh the heads are this rank's: the
    replicated bottleneck ``cq`` (or x without one) enters them through
    ``dist.enter``, after the replicated ``wq_a`` / ``q_a_norm``."""
    hcut = _head_cuts(cfg)[0]
    if cfg.q_lora_rank > 0:
        cq = rms_norm(dense(x, p["wq_a"]), p["q_a_norm"], cfg.norm_eps)
        q = _heads(dist.enter(cq, hcut), p["wq_b"])
    else:
        q = _heads(dist.enter(x, hcut), p["wq"])
    dn = cfg.qk_nope_dim
    return q[..., :dn], rotary_embed(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x -> (c (B, S, kvl) normalised, k_rope (B, S, dr) rotated): what the
    MLA cache holds."""
    kvl = cfg.kv_lora_rank
    ckv = dense(x, p["wkv_a"])
    c = rms_norm(ckv[..., :kvl], p["kv_a_norm"], cfg.norm_eps)
    k_rope = rotary_embed(ckv[..., None, kvl:], positions,
                          cfg.rope_theta)[:, :, 0]
    return c, k_rope


def mla_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: Optional[torch.Tensor] = None, *,
                  q_offset: Optional[torch.Tensor] = None,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  span=None, k_rows: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal MLA over the full sequence (training and the prefill): the
    latent up-projected to K = (k_nope, k_rope broadcast over the heads) at
    ``qk_nope_dim + qk_rope_dim`` and V at ``v_head_dim``, then one
    ``flash_attention`` launch at ``dv != d`` with the reference's scale
    ``1 / sqrt(qk_nope_dim + qk_rope_dim)``.

    Positions follow from ``q_offset`` as in :func:`attention` (passed ones
    must equal them).  Without ``cache`` returns the (B, S, D) output and
    the layer's latent rows (c, k_rope) for the prefill to cache.  With a
    layer's ``cache`` (lat_c, lat_r), each (B, max_seq, ...): the suffix's
    latent rows are written in place at ``[q_offset[b], q_offset[b] + S)``
    (rows past ``max_seq`` dropped; ``span`` takes :func:`span_index`'s
    indices when the caller has them), the cache's rows ``[0, k_rows)`` are
    up-projected (``k_rows`` defaults to ``max(q_offset) + S`` capped at
    ``max_seq``: the last key any query sees) and attended to under the
    offset mask, and the cache is returned.

    Under a mesh the latent projections and the latent rows are whole on
    every rank (replicated) and the heads are this rank's (``wq_b`` /
    ``wq``, ``wk_b``, ``wv_b``, ``wo``): one launch on them, the output
    summed over the axes they are cut over.  Under grad the latent ``c``
    and the rotary key, replicated, enter the rank's heads through
    ``dist.enter`` (each rank's heads give a partial cotangent), so the
    replicated ``wkv_a`` / ``kv_a_norm`` get the same gradient on every
    rank."""
    B, S, _ = x.shape
    derived = query_positions(B, S, q_offset, x.device)
    if positions is not None and not torch.equal(
            positions.to(torch.int32).expand(B, S), derived):
        raise ValueError(
            "mla_attention derives its query positions from q_offset; the "
            "positions it was handed differ, and the kernel's causal mask "
            "cannot follow them")
    q_nope, q_rope = _mla_q(p, cfg, x, derived)
    c, k_rope = _mla_latent(p, cfg, x, derived)
    latent = (c, k_rope)
    if cache is not None:
        cc, rc = cache
        size = cc.shape[1]
        if span is None:
            start = torch.zeros((B,), dtype=torch.int32, device=x.device) \
                if q_offset is None else q_offset
            span = span_index(start, S, size)
        write_span(cc, c, span)
        write_span(rc, k_rope, span)
        if k_rows is None:
            k_rows = S if q_offset is None else \
                min(size, int(q_offset.max()) + S)
        c, k_rope = cc[:, :k_rows], rc[:, :k_rows]
        latent = (cc, rc)
    H = q_nope.shape[2]                  # this rank's heads under a mesh
    c, k_rope = dist.enter((c, k_rope), _head_cuts(cfg)[0])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([_heads(c, p["wk_b"]),
                   k_rope[:, :, None].expand(-1, -1, H, -1)], dim=-1)
    v = _heads(c, p["wv_b"])
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        q_offset=q_offset).transpose(1, 2)
    return out_proj(p, cfg, o), latent


def mla_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One weight-absorbed MLA decode step: x (B, 1, D); cache (lat_c (B,
    S, kvl), lat_r (B, S, dr)), updated in place at the rows' ``pos`` (()
    or (B,)).  The query absorbs the key up-projection, ``q_lat = q_nope .
    wk_b`` (B, 1, H, kvl); the scores ``q_lat . c + q_rope . k_rope`` and
    the softmax are float32, the weights cast to the activation dtype; the
    output is ``(w . c) . wv_b . wo``.  No device value is read on the
    host, so the step can be captured in a CUDA graph.  Under a mesh the
    heads are this rank's (the latent rows whole) and the output is summed
    over the axes they are cut over."""
    c_cache, r_cache = cache
    B, S = c_cache.shape[0], c_cache.shape[1]
    positions = decode_positions(pos, B)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)                # (B,1,H,*)
    c_new, r_new = _mla_latent(p, cfg, x, positions)
    c_cache = cache_row_update(c_cache, c_new, pos)
    r_cache = cache_row_update(r_cache, r_new, pos)
    wk_b = p["wk_b"].to(x.dtype)                                 # (kvl,H,dn)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, wk_b)
    f32 = torch.float32
    s_lat = torch.einsum("bqhl,bsl->bhqs", q_lat.to(f32), c_cache.to(f32))
    s_rope = torch.einsum("bqhk,bsk->bhqs", q_rope.to(f32), r_cache.to(f32))
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    scores = (s_lat + s_rope) * scale
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    keep = _causal_mask(positions, k_pos)[:, None]
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhqs,bsl->bqhl", w, c_cache)           # (B,1,H,kvl)
    o = torch.einsum("bqhl,lhv->bqhv", o_lat, p["wv_b"].to(x.dtype))
    return out_proj(p, cfg, o), (c_cache, r_cache)
