"""Model assembly: init, full-sequence forward, one-pass prefill, decode
cache, decode step, the encoder of the encoder-decoder archs, and the
training loss.

The port of ``repro/models/transformer.py``.  The JAX package unrolls
its ``prelude_dense_layers`` first layers (``prelude_i``), stacks the
rest over a leading ``n_periods`` dim and runs them with ``lax.scan``;
here ``params["layers"]`` is a list of per-layer dicts in layer order run
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
bucket, as the JAX package's engine does for every arch.

With ``cfg.use_mla`` (deepseek-v2) an ``attn`` layer is multi-head latent
attention (:func:`attn.mla_attention` / :func:`attn.mla_decode`) and caches
the latent rows ``lat_c`` / ``lat_r`` instead of ``k`` / ``v``; still
indexed by position, so the one-pass prefill, its warm form and the prefix
cache run as for the dense family.  A full-sequence layer returns the rows
it caches by leaf name, and the prefill writes whatever leaves it returns.

:func:`loss_fn` (with :class:`RunCtx`) is the training form: the forward
under the caller's grad mode, each layer recomputed in the backward with
``remat="full"``, the attention differentiated through
``flash_attention``'s autograd Function (its hand-written backward
kernel), and the cross-entropy folded chunk by chunk with ``ce_chunk``.
``init_cache``, ``prefill`` and ``decode_step`` stay no-grad.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .common import ModelConfig, embed_lookup, init_normal, rms_norm
from .moe import _act, dense_ffn  # noqa: F401  (their home is moe.py)

Pytree = Any


def _check_supported(cfg: ModelConfig) -> None:
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
    ``ffn``; with ``cfg.use_mla`` an ``attn`` / ``local`` layer's ``mix``
    holds MLA's projections (:func:`attn.init_mla`)."""
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
        elif cfg.use_mla:
            mix = attn.init_mla(cfg, normal, ones)
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
    self-attention layer (with ``cfg.use_mla`` the latent rows ``lat_c``
    (B, max_seq, kv_lora_rank) and ``lat_r`` (B, max_seq, qk_rope_dim)
    instead).  ``pos_per_slot=True`` makes ``pos`` a
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
        if cfg.use_mla:
            c = {"lat_c": zeros((batch, max_seq, cfg.kv_lora_rank)),
                 "lat_r": zeros((batch, max_seq, cfg.qk_rope_dim))}
        else:
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
    elif cfg.use_mla:
        mixed, _ = attn.mla_decode(p["mix"], cfg, h,
                                   (cache["lat_c"], cache["lat_r"]), pos)
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
                cache=None, span=None, k_rows=None):
    """One layer over the full sequence -> (x, rows, stats): ``rows`` maps
    the names of the cache leaves a self-attention layer fills (``k`` /
    ``v``, or MLA's ``lat_c`` / ``lat_r``) to its (B, S, ...) rows, or,
    given the layer's ``cache`` dict (the warm prefill, at ``q_offset``),
    to the cache leaves it wrote in place; None for other layers."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    rows = None
    if ltype == "xattn":
        if context is None:
            raise ValueError(f"{cfg.name}: an xattn layer needs a context")
        mixed = attn.cross_attention(p["mix"], cfg, h,
                                     attn.cross_kv(p["mix"], cfg, context),
                                     gated=True)
    elif ltype in ssm.MIX:
        mixed = ssm.MIX[ltype](p["mix"], cfg, h)
    else:
        names = ("lat_c", "lat_r") if cfg.use_mla else ("k", "v")
        leaves = None if cache is None else tuple(cache[n] for n in names)
        if cfg.use_mla:
            mixed, out = attn.mla_attention(p["mix"], cfg, h,
                                            q_offset=q_offset, cache=leaves,
                                            span=span, k_rows=k_rows)
        else:
            mixed, out = attn.attention(p["mix"], cfg, h, q_offset=q_offset,
                                        cache=leaves, span=span,
                                        window=window)
        rows = dict(zip(names, out))
    x = x + mixed
    if cfg.decoder_cross_attn and ltype in ("attn", "local") and \
            context is not None:
        x = _cross_attend(p, cfg, x, attn.cross_kv(p["xattn"], cfg, context))
    x, stats = _apply_ffn(p, cfg, ftype, x, stats)
    return x, rows, stats


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


def _remat_layer(p: Dict, cfg: ModelConfig, ltype: str, ftype: str,
                 x: torch.Tensor, window: Optional[int],
                 stats: Optional[Dict], context):
    """One layer under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward (the JAX
    package's ``remat="full"``, which wraps each period)."""
    def run(x, stats, context):
        x, _, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                  context)
        return x, stats
    return checkpoint(run, x, stats, context, use_reentrant=False)


def _forward(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
             cache_layers=None, prefix_len=None, context=None,
             remat: bool = False):
    """(final hidden states of (B, S) tokens, MoE stats or None); with
    ``cache_layers``, the rows each layer caches (its (k, v), or MLA's
    latent rows) are written in place into rows [0, S) of its cache, or,
    with ``prefix_len``, into rows [prefix_len, prefix_len + S) after the
    cached prefix rows it attends to.  A
    ``context`` is encoded first when the arch has an encoder, then every
    cross-attending layer attends to it.  ``remat`` (training) recomputes
    each layer in the backward (:func:`_remat_layer`)."""
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    stats = _zero_stats(cfg, x.device)
    if cfg.encoder_layers > 0 and context is not None:
        context = encode(params, cfg, context)
    span = k_rows = None
    if prefix_len is not None:      # every layer writes the same rows
        size = next(iter(cache_layers[0].values())).shape[1]
        span = attn.span_index(prefix_len, S, size)
        if cfg.use_mla:         # the cache rows the queries see, read once
            k_rows = min(size, int(prefix_len.max()) + S)
    for i, p in enumerate(params["layers"]):
        ltype, window, ftype = cfg.block_type(i), layer_window(cfg, i), \
            cfg.ffn_type(i)
        if remat:
            x, stats = _remat_layer(p, cfg, ltype, ftype, x, window, stats,
                                    context)
            continue
        if prefix_len is not None:
            x, _, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                      None, prefix_len, cache_layers[i],
                                      span, k_rows)
            continue
        x, rows, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                     context)
        if cache_layers is not None:
            for name, t in rows.items():
                cache_layers[i][name][:, :S] = t
    return rms_norm(x, params["final_norm"], cfg.norm_eps), stats


def _sinusoid(S: int, D: int, device) -> torch.Tensor:
    """(S, D) float32 sinusoidal positions: sin of the first D/2 angles,
    then cos, angle ``pos / 10000 ** (2 i / D)`` (the JAX package's
    ``encode``)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


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


def forward_with_stats(params: Pytree, cfg: ModelConfig,
                       tokens: torch.Tensor, *,
                       context: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Token ids (B, S) -> (final hidden states (B, S, D), stats): the JAX
    package's ``forward`` (no remat; :func:`loss_fn` is the training form),
    under the caller's grad mode.  ``context`` (B, Sc, D) conditions a
    context arch (encoded first when it has an encoder).  ``stats`` is
    ``{"expert_load": (E,) int32, "dropped": int32}`` summed over the MoE
    layers, or None without experts."""
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

    Writes K/V rows (MLA: latent rows) [0, S) of every layer, pad rows
    past a prompt's length included, and sets ``pos`` to S: the cache the
    decode step run over the
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


# ---------------------------------------------------------------------------
# training: the loss
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Execution-context knobs of the training forward (the JAX package's
    ``RunCtx``).  ``mesh`` must be None: the mesh tier is a later slice.
    ``moe_impl`` is accepted and, on one device, runs ``moe_ffn_local`` as
    the JAX package does there.  ``attn_chunk`` is accepted for the JAX
    package's chunked attention; the kernel's own KV tiles take its place.
    ``ce_chunk > 0`` folds the cross-entropy chunk by chunk of the
    sequence; ``remat="full"`` recomputes each layer in the backward."""
    mesh: Any = None
    moe_impl: str = "replicated"
    attn_chunk: Optional[int] = None
    ce_chunk: int = 0
    remat: str = "full"                 # full | none

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "RunCtx(mesh=) needs the mesh tier, a later slice of the port "
                "(ROADMAP: mesh tier)")
        if self.remat not in ("full", "none"):
            raise ValueError(f"remat must be 'full' or 'none'; got "
                             f"{self.remat!r}")


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor):
    """(sum of the masked token losses, int32 count of masked tokens whose
    argmax is the label) of (..., V) logits."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    loss = (lse - gold) * mask
    correct = (torch.argmax(logits, dim=-1) == labels) & (mask > 0)
    return loss.sum(), correct.sum().to(torch.int32)


def loss_fn(params: Pytree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ctx: RunCtx = RunCtx()) -> Tuple[torch.Tensor, Dict]:
    """Mean cross-entropy and its metrics, a Sum-monoid dict (``loss_sum``,
    ``tokens``, ``correct``, plus ``expert_load`` and ``moe_dropped`` with
    experts, all float32), differentiable in ``params``: the JAX package's
    ``loss_fn``.  Labels < 0 are masked.

    ``ctx.ce_chunk > 0`` (dividing S) produces and folds the logits chunk
    by chunk of the sequence -- in-mapper combining of ``(loss_sum,
    correct)`` -- each chunk's logits recomputed in the backward, so the
    full (B, S, V) logits are never live."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    labels_safe = torch.clamp(labels, min=0)
    h, stats = _forward(params, cfg, tokens, context=batch.get("context"),
                        remat=ctx.remat == "full")
    S = tokens.shape[1]
    if ctx.ce_chunk and S % ctx.ce_chunk == 0:
        def chunk(hc, lc, mc):
            return _ce_from_logits(unembed(params, cfg, hc), lc, mc)
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        correct = torch.zeros((), dtype=torch.int32, device=h.device)
        for c0 in range(0, S, ctx.ce_chunk):
            sl = slice(c0, c0 + ctx.ce_chunk)
            ls, cr = checkpoint(chunk, h[:, sl], labels_safe[:, sl],
                                mask[:, sl], use_reentrant=False)
            loss_sum, correct = loss_sum + ls, correct + cr
    else:
        loss_sum, correct = _ce_from_logits(unembed(params, cfg, h),
                                            labels_safe, mask)
    ntok = mask.sum()
    metrics = {"loss_sum": loss_sum, "tokens": ntok,
               "correct": correct.to(torch.float32)}
    if stats is not None:
        metrics["expert_load"] = stats["expert_load"].to(torch.float32)
        metrics["moe_dropped"] = stats["dropped"].to(torch.float32)
    return loss_sum / torch.clamp(ntok, min=1.0), metrics


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
