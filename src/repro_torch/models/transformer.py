"""Model assembly for the dense family: init, full-sequence forward,
one-pass prefill, decode cache, decode step.

The port of the serving half of ``repro/models/transformer.py``.  The JAX
package stacks the layers over a leading ``n_periods`` dim and runs them
with ``lax.scan``; here ``params["layers"]`` is a list of per-layer dicts run
by a Python loop (``models/convert.py`` unstacks JAX weights).  The decode
cache mirrors that: ``{"pos": (B,) or (), "layers": [{"k", "v"}, ...]}``, and
:func:`decode_step` updates it in place (the JAX engine donates its cache).
:func:`forward` and :func:`prefill` run the same layer function over a whole
sequence, its attention on the ``flash_attention`` kernel; :func:`prefill`
leaves the cache as the decode step run over the sequence would, and with
``prefix_len`` prefills each row's uncached suffix after its cached prefix
(the radix prefix cache's warm admission) in the same one pass.

Layers are ``attn`` (global causal attention) or ``local`` (attention within
``cfg.sliding_window`` keys, gemma3's 5:1 local:global stack), in layer
order; every layer's decode cache holds all ``max_seq`` rows, as the JAX
package's does, so the cache stays indexed by position.  Each layer's FFN
is ``dense`` or ``moe`` (qwen2-moe: :mod:`repro_torch.models.moe` on one
device); :func:`forward_with_stats` also returns the MoE stats summed over
layers (a Sum monoid), which :func:`forward`, :func:`prefill` and
:func:`decode_step` drop.  The encoder and cross-attention (whisper), SSM /
xLSTM blocks (xlstm, jamba), MLA (deepseek-v2) and gated cross-attention
(llama-3.2-vision) are later slices of the port (``init_params`` /
``init_cache`` raise for them).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from . import attention as attn
from . import moe as moe_mod
from .common import ModelConfig, embed_lookup, init_normal, rms_norm
from .moe import _act, dense_ffn  # noqa: F401  (their home is moe.py)

Pytree = Any


def _check_supported(cfg: ModelConfig) -> None:
    for i in range(cfg.num_layers):
        if cfg.block_type(i) not in ("attn", "local") or \
                cfg.ffn_type(i) not in ("dense", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is ({cfg.block_type(i)}, "
                f"{cfg.ffn_type(i)}); the port runs attention layers with "
                "dense or MoE FFNs (SSM / MLA / cross-attention layers are "
                "later slices)")


def layer_window(cfg: ModelConfig, i: int) -> Optional[int]:
    """Layer ``i``'s attention window: ``cfg.sliding_window`` for a
    ``local`` layer, None (global) for an ``attn`` one."""
    return cfg.sliding_window if cfg.block_type(i) == "local" else None


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Pytree:
    """Random parameters with the JAX package's shapes and scales
    (``std = 1/sqrt(fan_in)``, norms at one), drawn from ``gen``."""
    _check_supported(cfg)
    device = torch.device(device)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.dtype

    def normal(shape, fan_in):
        return init_normal(gen, shape, fan_in, dt, device)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    params: Dict[str, Any] = {"embed": normal((cfg.vocab_size, D), D)}
    layers: List[Dict] = []
    for i in range(cfg.num_layers):
        mix = {"wq": normal((D, H, hd), D), "wk": normal((D, KV, hd), D),
               "wv": normal((D, KV, hd), D), "wo": normal((H, hd, D), H * hd)}
        if cfg.qkv_bias:
            mix.update(bq=torch.zeros((H, hd), dtype=dt, device=device),
                       bk=torch.zeros((KV, hd), dtype=dt, device=device),
                       bv=torch.zeros((KV, hd), dtype=dt, device=device))
        if cfg.qk_norm:
            mix.update(q_norm=ones(hd), k_norm=ones(hd))
        ffn = moe_mod.init_moe(cfg, gen, device=device) \
            if cfg.ffn_type(i) == "moe" else \
            moe_mod.init_dense_ffn(cfg, gen, device=device)
        layers.append({"norm1": ones(D), "mix": mix, "norm2": ones(D),
                       "ffn": ffn})
    params["layers"] = layers
    params["final_norm"] = ones(D)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, cfg.vocab_size), D)
    return params


def positional_cache(cfg: ModelConfig) -> bool:
    """True when every decode-cache leaf (besides ``pos``) is indexed by
    absolute sequence position — the property prefix KV sharing needs;
    true of every attention-only stack."""
    return all(cfg.block_type(i) in ("attn", "local")
               for i in range(cfg.num_layers))


def init_cache(params: Pytree, cfg: ModelConfig, batch: int, max_seq: int, *,
               pos_per_slot: bool = False) -> Pytree:
    """Zeroed KV caches on the parameters' device.  ``pos_per_slot=True``
    makes ``pos`` a ``(batch,)`` vector: every row (request slot) carries
    its own cache position."""
    _check_supported(cfg)
    device = params["embed"].device
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    pos = torch.zeros((batch,) if pos_per_slot else (), dtype=torch.int32,
                      device=device)
    return {"pos": pos,
            "layers": [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                        "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
                       for _ in range(cfg.num_layers)]}


def _apply_ffn(p: Dict, cfg: ModelConfig, ftype: str, x: torch.Tensor,
               stats: Optional[Dict]):
    """The residual FFN block -> (x, stats): an MoE layer adds its stats
    into ``stats`` (the reference's ``_apply_ffn``)."""
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if ftype == "dense":
        return x + dense_ffn(p["ffn"], cfg, h), stats
    out, s = moe_mod.moe_ffn(p["ffn"], cfg, h)
    if stats is not None:
        stats = {k: stats[k] + s[k] for k in stats}
    return x + out, stats


def _decode_layer(p: Dict, cfg: ModelConfig, ftype: str, x: torch.Tensor,
                  cache: Dict, pos: torch.Tensor,
                  window: Optional[int]) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    mixed, _ = attn.attention_decode(p["mix"], cfg, h,
                                     (cache["k"], cache["v"]), pos,
                                     window=window)
    x, _ = _apply_ffn(p, cfg, ftype, x + mixed, None)
    return x


def _full_layer(p: Dict, cfg: ModelConfig, ftype: str, x: torch.Tensor,
                window: Optional[int], stats: Optional[Dict],
                q_offset=None, cache=None, span=None):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    mixed, kv = attn.attention(p["mix"], cfg, h, q_offset=q_offset,
                               cache=cache, span=span, window=window)
    x, stats = _apply_ffn(p, cfg, ftype, x + mixed, stats)
    return x, kv, stats


def _zero_stats(cfg: ModelConfig, device) -> Optional[Dict]:
    if cfg.num_experts == 0:
        return None
    return {"expert_load": torch.zeros(cfg.num_experts, dtype=torch.int32,
                                       device=device),
            "dropped": torch.zeros((), dtype=torch.int32, device=device)}


def _embed(params: Pytree, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return x


def _forward(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
             cache_layers=None, prefix_len=None):
    """(final hidden states of (B, S) tokens, MoE stats or None); with
    ``cache_layers``, each layer's (k, v) is written in place into rows
    [0, S) of its cache, or, with ``prefix_len``, into rows [prefix_len,
    prefix_len + S) after the cached prefix rows it attends to."""
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    stats = _zero_stats(cfg, x.device)
    if prefix_len is not None:      # every layer writes the same rows
        span = attn.span_index(prefix_len, S, cache_layers[0]["k"].shape[1])
    for i, p in enumerate(params["layers"]):
        window, ftype = layer_window(cfg, i), cfg.ffn_type(i)
        if prefix_len is not None:
            c = cache_layers[i]
            x, _, stats = _full_layer(p, cfg, ftype, x, window, stats,
                                      prefix_len, (c["k"], c["v"]), span)
            continue
        x, (k, v), stats = _full_layer(p, cfg, ftype, x, window, stats)
        if cache_layers is not None:
            cache_layers[i]["k"][:, :S] = k
            cache_layers[i]["v"][:, :S] = v
    return rms_norm(x, params["final_norm"], cfg.norm_eps), stats


@torch.no_grad()
def forward_with_stats(params: Pytree, cfg: ModelConfig,
                       tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Token ids (B, S) -> (final hidden states (B, S, D), stats): the JAX
    package's ``forward`` (no context, no remat; forward only, as the
    attention kernel is).  ``stats`` is ``{"expert_load": (E,) int32,
    "dropped": int32}`` summed over the MoE layers, or None without
    experts."""
    return _forward(params, cfg, tokens)


def forward(params: Pytree, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)
    (:func:`forward_with_stats` without the stats)."""
    return forward_with_stats(params, cfg, tokens)[0]


@torch.no_grad()
def prefill(params: Pytree, cfg: ModelConfig, cache: Pytree,
            tokens: torch.Tensor, lengths: torch.Tensor,
            prefix_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Pytree]:
    """A whole (B, S) bucket of prompts in one pass -> ((B, V) float32
    logits at each row's position ``lengths - 1``, the cache).

    Writes K/V rows [0, S) of every layer, pad rows past a prompt's length
    included, and sets ``pos`` to S: the cache the decode step run over the
    S tokens leaves, and the same logits at ``lengths - 1``.  The hidden
    rows are gathered before ``unembed``, so only B rows of logits exist.

    With ``prefix_len`` ((B,) int; each below the cache length) the tokens
    are each row's uncached SUFFIX and the cache already holds the row's
    prefix K/V in rows [0, prefix_len): the suffix sits at positions
    ``prefix_len + i``, writes rows [prefix_len, prefix_len + S) (those
    past the cache's end are pads and are dropped), attends to the prefix
    and to itself (one ``flash_attention`` launch per layer with the row's
    query offset), ``pos`` becomes ``prefix_len + S``, and the logits are
    those at suffix position ``lengths - 1``: what the decode step run over
    the suffix from ``pos = prefix_len`` leaves.
    """
    B, S = tokens.shape
    h, _ = _forward(params, cfg, tokens, cache["layers"], prefix_len)
    rows = torch.arange(B, device=h.device)
    logits = unembed(params, cfg, h[rows, lengths.long() - 1])
    pos = torch.full_like(cache["pos"], S) if prefix_len is None else \
        (prefix_len + S).to(cache["pos"].dtype)
    return logits, {"pos": pos, "layers": cache["layers"]}


def unembed(params: Pytree, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits in float32: products of the activation-dtype inputs summed in
    float32, as ``preferred_element_type=float32`` does."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h.to(torch.float32), w.to(torch.float32))


@torch.no_grad()
def decode_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Pytree]:
    """One serving step: (B, 1) new tokens -> (B, 1, V) float32 logits and
    the cache, its KV rows written in place and ``pos`` advanced."""
    pos = cache["pos"]
    x = _embed(params, cfg, tokens)
    for i, (p, c) in enumerate(zip(params["layers"], cache["layers"])):
        x = _decode_layer(p, cfg, cfg.ffn_type(i), x, c, pos,
                          layer_window(cfg, i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


def num_params(params: Pytree) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))
