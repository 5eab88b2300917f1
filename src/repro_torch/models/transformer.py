"""Model assembly: init, full-sequence forward, one-pass prefill, decode
cache, decode step, and the encoder of the encoder-decoder archs.

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

Layers are ``attn`` (global causal attention), ``local`` (attention within
``cfg.sliding_window`` keys, gemma3's 5:1 local:global stack) or ``xattn``
(llama-3.2-vision's gated cross-attention to the context), in layer order;
every self-attention layer's decode cache holds all ``max_seq`` rows, as the
JAX package's does, so the cache stays indexed by position.  Each layer's
FFN is ``dense`` or ``moe`` (qwen2-moe: :mod:`repro_torch.models.moe` on one
device); :func:`forward_with_stats` also returns the MoE stats summed over
layers (a Sum monoid), which :func:`forward`, :func:`prefill` and
:func:`decode_step` drop.

Context-conditioned archs take a ``context`` (B, Sc, D): whisper's stub
frame embeddings, which :func:`encode` runs through ``params["encoder"]``
(bidirectional layers, one non-causal ``flash_attention`` launch each), or
llama-3.2-vision's stub patch embeddings as they are.  With
``cfg.decoder_cross_attn`` every self-attention layer then cross-attends to
it (``norm_x``, ``xattn``).  :func:`init_cache` projects the context's K/V
once per cross-attending layer (``xk`` / ``xv``) and the decode step reads
them.  The engine's one-pass :func:`prefill` refuses these archs, as the
JAX package's engine does.

Recurrent layers (``mamba``, ``mlstm``, ``slstm``: :mod:`repro_torch.models.ssm`;
xlstm-1.3b's 7:1 mLSTM:sLSTM stack with no FFN, jamba's 7:1 Mamba:attention
stack with dense and MoE FFNs) keep a state in the decode cache instead of
K/V rows (``ssm_h`` / ``ssm_conv``, ``ml_C`` / ``ml_n``, ``sl_h`` /
``sl_c``), which the decode step advances in place.  They have no one-pass
prefill (:func:`prefill` raises): the engine runs the decode step over the
bucket, as the JAX package's engine does for every arch.  MLA
(deepseek-v2, ``cfg.use_mla``) is not ported yet (``init_params`` /
``init_cache`` raise for it).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .common import ModelConfig, embed_lookup, init_normal, rms_norm
from .moe import _act, dense_ffn  # noqa: F401  (their home is moe.py)

Pytree = Any


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention (use_mla) is not ported yet")
    for i in range(cfg.num_layers):
        if cfg.block_type(i) not in ("attn", "local", "xattn") + \
                ssm.RECURRENT_BLOCKS or \
                cfg.ffn_type(i) not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is ({cfg.block_type(i)}, "
                f"{cfg.ffn_type(i)}); the port runs attention, "
                "cross-attention, mamba, mlstm and slstm layers with dense, "
                "MoE or no FFN")


def recurrent(cfg: ModelConfig) -> bool:
    """True for an arch with a recurrent layer (mamba, mlstm, slstm)."""
    return any(cfg.block_type(i) in ssm.RECURRENT_BLOCKS
               for i in range(cfg.num_layers))


def context_conditioned(cfg: ModelConfig) -> bool:
    """True for an arch that reads a context: an encoder (whisper), a
    decoder that cross-attends, or ``xattn`` layers (llama-3.2-vision)."""
    return cfg.encoder_layers > 0 or cfg.decoder_cross_attn or any(
        cfg.block_type(i) == "xattn" for i in range(cfg.num_layers))


def layer_window(cfg: ModelConfig, i: int) -> Optional[int]:
    """Layer ``i``'s attention window: ``cfg.sliding_window`` for a
    ``local`` layer, None (global) for an ``attn`` one."""
    return cfg.sliding_window if cfg.block_type(i) == "local" else None


def _init_attn(cfg: ModelConfig, normal, ones, zeros) -> Dict:
    """One layer's GQA projections (the JAX package's ``init_attn``)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mix = {"wq": normal((D, H, hd), D), "wk": normal((D, KV, hd), D),
           "wv": normal((D, KV, hd), D), "wo": normal((H, hd, D), H * hd)}
    if cfg.qkv_bias:
        mix.update(bq=zeros((H, hd)), bk=zeros((KV, hd)), bv=zeros((KV, hd)))
    if cfg.qk_norm:
        mix.update(q_norm=ones(hd), k_norm=ones(hd))
    return mix


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Pytree:
    """Random parameters with the JAX package's shapes and scales
    (``std = 1/sqrt(fan_in)``, norms at one, cross-attention gates at
    zero, Mamba's ``A_log`` / ``dt_bias`` at zero and ``D_skip`` at one),
    drawn from ``gen``.  A layer whose FFN is ``none`` has no ``norm2`` /
    ``ffn``."""
    _check_supported(cfg)
    device = torch.device(device)
    D = cfg.d_model
    dt = cfg.dtype

    def normal(shape, fan_in):
        return init_normal(gen, shape, fan_in, dt, device)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def cross():      # the JAX package's init_cross_attn
        return {**_init_attn(cfg, normal, ones, zeros), "gate": zeros(())}

    def layer(ltype, ftype, cross_attends):
        if ltype == "xattn":
            mix = cross()
        elif ltype in ssm.INIT:
            mix = ssm.INIT[ltype](cfg, normal, ones, zeros)
        else:
            mix = _init_attn(cfg, normal, ones, zeros)
        p = {"norm1": ones(D), "mix": mix}
        if cross_attends and ltype in ("attn", "local"):
            p["xattn"] = cross()
            p["norm_x"] = ones(D)
        if ftype != "none":
            p["norm2"] = ones(D)
            p["ffn"] = moe_mod.init_moe(cfg, gen, device=device) \
                if ftype == "moe" else \
                moe_mod.init_dense_ffn(cfg, gen, device=device)
        return p

    params: Dict[str, Any] = {"embed": normal((cfg.vocab_size, D), D)}
    params["layers"] = [layer(cfg.block_type(i), cfg.ffn_type(i),
                              cfg.decoder_cross_attn)
                        for i in range(cfg.num_layers)]
    params["final_norm"] = ones(D)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, cfg.vocab_size), D)
    if cfg.encoder_layers > 0:   # whisper's encoder (the conv frontend is a stub)
        params["encoder"] = {
            "layers": [layer("attn", "dense", False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": ones(D)}
    return params


def positional_cache(cfg: ModelConfig) -> bool:
    """True when every decode-cache leaf (besides ``pos``) is indexed by
    absolute sequence position — the property prefix KV sharing needs;
    true of every self-attention stack, false when the cache holds a
    context's K/V (an encoder, a cross-attending decoder, ``xattn``
    layers) or a recurrent state (``mamba``, ``mlstm``, ``slstm``)."""
    if cfg.encoder_layers > 0 or cfg.decoder_cross_attn:
        return False
    return all(cfg.block_type(i) in ("attn", "local")
               for i in range(cfg.num_layers))


@torch.no_grad()
def init_cache(params: Pytree, cfg: ModelConfig, batch: int, max_seq: int, *,
               context: Optional[torch.Tensor] = None,
               pos_per_slot: bool = False) -> Pytree:
    """Decode caches on the parameters' device: zeroed KV rows per
    self-attention layer.  ``pos_per_slot=True`` makes ``pos`` a
    ``(batch,)`` vector: every row (request slot) carries its own cache
    position.

    With a ``context`` (B, Sc, D) (encoded first when the arch has an
    encoder), every cross-attending layer's context K/V are projected ONCE
    here as ``xk`` / ``xv`` (B, Sc, KV, hd) and reused by every decode step.
    An ``xattn`` layer without a context gets zeros of
    ``cfg.num_image_tokens`` rows; a cross-attending ``attn`` layer without
    one gets none (its decode skips the cross-attention, as the JAX
    package's does).  A recurrent layer gets its zeroed state
    (``ssm.INIT_CACHE``): Mamba's ``ssm_h`` (B, d_inner, d_state) float32
    and ``ssm_conv`` (B, d_conv - 1, d_inner); mLSTM's ``ml_C`` (B, H, hd,
    hd) and ``ml_n`` (B, H, hd) float32; sLSTM's ``sl_h`` / ``sl_c`` (B, H,
    D // H) float32."""
    _check_supported(cfg)
    device = params["embed"].device
    if cfg.encoder_layers > 0 and context is not None:
        context = encode(params, cfg, context)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    pos = torch.zeros((batch,) if pos_per_slot else (), dtype=torch.int32,
                      device=device)

    def zeros(shape_):
        return torch.zeros(shape_, dtype=cfg.dtype, device=device)

    layers = []
    for i, p in enumerate(params["layers"]):
        if cfg.block_type(i) in ssm.INIT_CACHE:
            layers.append(ssm.INIT_CACHE[cfg.block_type(i)](cfg, batch,
                                                            device))
            continue
        if cfg.block_type(i) == "xattn":
            if context is not None:
                xk, xv = attn.cross_kv(p["mix"], cfg, context)
            else:
                shape_x = (batch, cfg.num_image_tokens, cfg.num_kv_heads,
                           cfg.head_dim)
                xk, xv = zeros(shape_x), zeros(shape_x)
            layers.append({"xk": xk, "xv": xv})
            continue
        c = {"k": zeros(shape), "v": zeros(shape)}
        if cfg.decoder_cross_attn and context is not None:
            c["xk"], c["xv"] = attn.cross_kv(p["xattn"], cfg, context)
        layers.append(c)
    return {"pos": pos, "layers": layers}


def _apply_ffn(p: Dict, cfg: ModelConfig, ftype: str, x: torch.Tensor,
               stats: Optional[Dict]):
    """The residual FFN block -> (x, stats): an MoE layer adds its stats
    into ``stats``, a ``none`` FFN returns x (the reference's
    ``_apply_ffn``)."""
    if ftype == "none":
        return x, stats
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if ftype == "dense":
        return x + dense_ffn(p["ffn"], cfg, h), stats
    out, s = moe_mod.moe_ffn(p["ffn"], cfg, h)
    if stats is not None:
        stats = {k: stats[k] + s[k] for k in stats}
    return x + out, stats


def _cross_attend(p: Dict, cfg: ModelConfig, x: torch.Tensor, kv,
                  decode: bool = False) -> torch.Tensor:
    """The residual cross-attention a ``decoder_cross_attn`` layer adds
    after its self-attention: ``norm_x``, then ``xattn`` over ``kv``."""
    h = rms_norm(x, p["norm_x"], cfg.norm_eps)
    return x + attn.cross_attention(p["xattn"], cfg, h, kv, decode=decode)


def _decode_layer(p: Dict, cfg: ModelConfig, ltype: str, ftype: str,
                  x: torch.Tensor, cache: Dict, pos: torch.Tensor,
                  window: Optional[int]) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if ltype == "xattn":
        mixed = attn.cross_attention(p["mix"], cfg, h,
                                     (cache["xk"], cache["xv"]), gated=True,
                                     decode=True)
    elif ltype in ssm.DECODE:
        mixed, _ = ssm.DECODE[ltype](p["mix"], cfg, h, cache)
    else:
        mixed, _ = attn.attention_decode(p["mix"], cfg, h,
                                         (cache["k"], cache["v"]), pos,
                                         window=window)
    x = x + mixed
    if cfg.decoder_cross_attn and ltype in ("attn", "local") and \
            "xk" in cache:
        x = _cross_attend(p, cfg, x, (cache["xk"], cache["xv"]), decode=True)
    x, _ = _apply_ffn(p, cfg, ftype, x, None)
    return x


def _full_layer(p: Dict, cfg: ModelConfig, ltype: str, ftype: str,
                x: torch.Tensor, window: Optional[int],
                stats: Optional[Dict], context=None, q_offset=None,
                cache=None, span=None):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    kv = None
    if ltype == "xattn":
        if context is None:
            raise ValueError(f"{cfg.name}: an xattn layer needs a context")
        mixed = attn.cross_attention(p["mix"], cfg, h,
                                     attn.cross_kv(p["mix"], cfg, context),
                                     gated=True)
    elif ltype in ssm.MIX:
        mixed = ssm.MIX[ltype](p["mix"], cfg, h)
    else:
        mixed, kv = attn.attention(p["mix"], cfg, h, q_offset=q_offset,
                                   cache=cache, span=span, window=window)
    x = x + mixed
    if cfg.decoder_cross_attn and ltype in ("attn", "local") and \
            context is not None:
        x = _cross_attend(p, cfg, x, attn.cross_kv(p["xattn"], cfg, context))
    x, stats = _apply_ffn(p, cfg, ftype, x, stats)
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
             cache_layers=None, prefix_len=None, context=None):
    """(final hidden states of (B, S) tokens, MoE stats or None); with
    ``cache_layers``, each layer's (k, v) is written in place into rows
    [0, S) of its cache, or, with ``prefix_len``, into rows [prefix_len,
    prefix_len + S) after the cached prefix rows it attends to.  A
    ``context`` is encoded first when the arch has an encoder, then every
    cross-attending layer attends to it."""
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    stats = _zero_stats(cfg, x.device)
    if cfg.encoder_layers > 0 and context is not None:
        context = encode(params, cfg, context)
    if prefix_len is not None:      # every layer writes the same rows
        span = attn.span_index(prefix_len, S, cache_layers[0]["k"].shape[1])
    for i, p in enumerate(params["layers"]):
        ltype, window, ftype = cfg.block_type(i), layer_window(cfg, i), \
            cfg.ffn_type(i)
        if prefix_len is not None:
            c = cache_layers[i]
            x, _, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                      None, prefix_len, (c["k"], c["v"]),
                                      span)
            continue
        x, kv, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                   context)
        if cache_layers is not None:
            cache_layers[i]["k"][:, :S] = kv[0]
            cache_layers[i]["v"][:, :S] = kv[1]
    return rms_norm(x, params["final_norm"], cfg.norm_eps), stats


def _sinusoid(S: int, D: int, device) -> torch.Tensor:
    """(S, D) float32 sinusoidal positions: sin of the first D/2 angles,
    then cos, angle ``pos / 10000 ** (2 i / D)`` (the JAX package's
    ``encode``)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


@torch.no_grad()
def encode(params: Pytree, cfg: ModelConfig,
           features: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, S_enc, D) ->
    (B, S_enc, D) in ``cfg.dtype``: sinusoidal positions (float32, added in
    the features' dtype), then ``encoder_layers`` bidirectional attention
    layers with dense FFNs (one non-causal ``flash_attention`` launch
    each) and the encoder's final norm."""
    enc = params["encoder"]
    _, S, D = features.shape
    pe = _sinusoid(S, D, features.device)
    x = (features + pe.to(features.dtype)).to(cfg.dtype)
    for p in enc["layers"]:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn.attention_bidir(p["mix"], cfg, h)
        x, _ = _apply_ffn(p, cfg, "dense", x, None)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


@torch.no_grad()
def forward_with_stats(params: Pytree, cfg: ModelConfig,
                       tokens: torch.Tensor, *,
                       context: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Token ids (B, S) -> (final hidden states (B, S, D), stats): the JAX
    package's ``forward`` (no remat; forward only, as the attention kernel
    is).  ``context`` (B, Sc, D) conditions a context arch (encoded first
    when it has an encoder).  ``stats`` is ``{"expert_load": (E,) int32,
    "dropped": int32}`` summed over the MoE layers, or None without
    experts."""
    return _forward(params, cfg, tokens, context=context)


def forward(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor, *,
            context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)
    (:func:`forward_with_stats` without the stats)."""
    return forward_with_stats(params, cfg, tokens, context=context)[0]


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
    if context_conditioned(cfg):
        raise NotImplementedError(
            f"{cfg.name}: context-conditioned archs (audio/vision) have no "
            "one-pass prefill; the JAX package's engine refuses them, and "
            "the decode step over a context cache is their path")
    if recurrent(cfg):
        raise NotImplementedError(
            f"{cfg.name}: recurrent layers (mamba / mlstm / slstm) have no "
            "one-pass prefill; the engine runs the decode step over the "
            "bucket, as the JAX package's engine does")
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
        x = _decode_layer(p, cfg, cfg.block_type(i), cfg.ffn_type(i), x, c,
                          pos, layer_window(cfg, i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


def num_params(params: Pytree) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))
