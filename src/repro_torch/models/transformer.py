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

Under a mesh (``RunCtx(mesh=)``, or inside ``dist.sharding.use_rules``)
every family runs tensor and expert parallel with explicit per-rank
shards, where the JAX package lets GSPMD place its ``PartitionSpec``s: each
rank holds its block of every parameter
(:func:`param_axes` names the dimensions; ``dist.sharding.shard_params``
cuts them), the KV cache holds its KV heads, and the layers call the
collectives themselves.  Under ``SERVE_RULES`` the ``heads``,
``kv_heads``, ``mlp``, ``vocab`` and ``expert`` dimensions are cut over
``model`` and the residual stream is replicated: the embedding is looked
up in this rank's rows and summed over the axis, a ``psum`` follows
``wo`` and the FFN's down projection (float32 partial products, rounded
once), the MoE layer runs ``moe.moe_ffn(mesh=, impl=ctx.moe_impl)``, and
the vocab-cut logits are gathered.  A dimension the axis does not divide
stays whole (``spec_for``), and the layer computes the same function: KV
heads the axis does not divide are sliced per query-head block
(``attention.group_kv``).  ``decode_impl="flash"`` decodes over a cache
whose rows are cut over ``model`` (``attention.flash_decode_shardmap``).
:func:`loss_fn` trains on the same blocks (``TRAIN_RULES`` in
``launch/steps.py``): the collectives are differentiable (``dist``), a
replicated value entering a cut product goes through ``dist.enter`` (its
cotangent summed over the axis), and the cross-entropy runs on the
vocab-cut logits, or on the whole logits where the axis does not divide
the vocabulary (whisper's 51865).  MLA's latent and rotary key, the
encoder's output and a cross-attention's context are replicated and enter
the rank's heads the same way; the recurrent blocks run on their packed
halves and heads (:mod:`repro_torch.models.ssm`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from .. import dist
from ..dist import sharding as shd
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .common import (ModelConfig, cache_leaf, embed_lookup, init_normal,
                     rms_norm)
from .moe import _act, dense_ffn  # noqa: F401  (their home is moe.py)

Pytree = Any


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Execution-context knobs threaded through the stack (the JAX
    package's ``RunCtx``).  ``mesh`` (a ``DeviceMesh``) runs
    :func:`forward`, :func:`prefill`, :func:`decode_step` and
    :func:`init_cache` on this rank's blocks, under ``SERVE_RULES`` unless
    a ``dist.sharding.use_rules`` scope is open; ``moe_impl``
    (``replicated`` | ``a2a``) picks the expert-parallel strategy there (on
    one device ``moe_ffn_local`` runs, as in the JAX package);
    ``decode_impl="flash"`` decodes over a sequence-cut cache.
    ``batch_axes`` are the mesh axes the caller cut the batch over (the MoE
    stats are summed over them; the JAX package's arrays are global and
    need no such field).  ``attn_chunk`` is accepted for the JAX package's
    chunked attention; the kernel's own KV tiles take its place.
    ``ce_chunk > 0`` folds the cross-entropy chunk by chunk of the
    sequence; ``remat="full"`` recomputes each layer in the backward."""
    mesh: Any = None
    moe_impl: str = "replicated"
    attn_chunk: Optional[int] = None
    ce_chunk: int = 0
    remat: str = "full"                 # full | none
    decode_impl: str = "dense"          # dense | flash (sharded-KV decode)
    batch_axes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.remat not in ("full", "none"):
            raise ValueError(f"remat must be 'full' or 'none'; got "
                             f"{self.remat!r}")
        if self.decode_impl not in ("dense", "flash"):
            raise ValueError(f"decode_impl must be 'dense' or 'flash'; got "
                             f"{self.decode_impl!r}")


def _mesh_of(ctx: RunCtx):
    """The mesh a call runs on: ``ctx.mesh``, else the open rules
    scope's, else None."""
    if ctx.mesh is not None:
        return ctx.mesh
    scope = shd.current_rules()
    return None if scope is None else scope[0]


@contextlib.contextmanager
def _mesh_scope(cfg: ModelConfig, ctx: RunCtx):
    """The scope a call runs in: nothing without a mesh; with one, its
    rules (``SERVE_RULES`` unless a scope is open) and the mesh bound for
    the collectives."""
    mesh = _mesh_of(ctx)
    if mesh is None:
        yield
        return
    if shd.current_rules() is None:
        with shd.use_rules(mesh, shd.SERVE_RULES):
            yield
    else:
        with dist.maybe_mesh(ctx.mesh if getattr(ctx.mesh, "mesh_dim_names",
                                                 None) else None):
            yield


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


# the logical axes of every parameter leaf, by leaf name: the names the JAX
# package's ParamBuilder records (models/common.py, attention.py, moe.py,
# ssm.py), which ``dist.sharding`` maps to mesh axes
_ATTN_AXES = {
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "q_norm": ("head_dim",), "k_norm": ("head_dim",), "gate": (),
    # MLA
    "wq_a": ("embed", "q_lora"), "q_a_norm": ("q_lora",),
    "wq_b": ("q_lora", "heads", "head_dim"),
    "wkv_a": ("embed", "kv_lora"), "kv_a_norm": ("kv_lora",),
    "wk_b": ("kv_lora", "heads", "head_dim"),
    "wv_b": ("kv_lora", "heads", "head_dim"),
}
_FFN_AXES = {
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"), "router": ("embed", None),
    "we_gate": ("expert", "embed", "mlp"), "we_up": ("expert", "embed", "mlp"),
    "we_down": ("expert", "mlp", "embed"),
}
_MIX_AXES = ssm.AXES


def _axes_like(tree: Dict, table: Dict) -> Dict:
    return {k: _axes_like(v, table) if isinstance(v, dict) else table[k]
            for k, v in tree.items()}


def _layer_axes(ltype: str, layer: Dict) -> Dict:
    """The logical axes of one layer's parameter dict."""
    out = {}
    for k, v in layer.items():
        if k == "mix":
            out[k] = _axes_like(v, _MIX_AXES.get(ltype, _ATTN_AXES))
        elif k == "xattn":
            out[k] = _axes_like(v, _ATTN_AXES)
        elif k == "ffn":
            out[k] = _axes_like(v, _FFN_AXES)
        else:                                   # norm1, norm2, norm_x
            out[k] = ("embed",)
    return out


def _top_axes(name: str) -> Tuple:
    return {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab")}.get(
        name, ("embed",))


def param_axes(cfg: ModelConfig) -> Pytree:
    """The logical-axes tree of the parameters (a tuple of names per leaf,
    the tree shaped as :func:`init_params`'s), without allocating: the
    names of the JAX package's ``param_axes``, per layer where it stacks
    the layers under a leading ``"layers"`` name."""
    shapes = param_shapes(cfg)
    out = {k: _top_axes(k) for k in shapes if k not in ("layers", "encoder")}
    out["layers"] = [_layer_axes(cfg.block_type(i), p)
                     for i, p in enumerate(shapes["layers"])]
    if "encoder" in shapes:
        out["encoder"] = {"layers": [_layer_axes("attn", p) for p in
                                     shapes["encoder"]["layers"]],
                          "final_norm": ("embed",)}
    return out


def param_shapes(cfg: ModelConfig) -> Pytree:
    """The parameter tree on the meta device: shapes and dtypes, nothing
    allocated (the dry-run path)."""
    return init_params(cfg, torch.Generator(), device="meta")


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda",
                shard: Optional[Callable[[Any, Any], Any]] = None) -> Pytree:
    """Random parameters with the JAX package's shapes and scales
    (``std = 1/sqrt(fan_in)``, norms at one, cross-attention gates at
    zero, Mamba's ``A_log`` / ``dt_bias`` at zero and ``D_skip`` at one),
    drawn from ``gen``.  A layer whose FFN is ``none`` has no ``norm2`` /
    ``ffn``; with ``cfg.use_mla`` an ``attn`` / ``local`` layer's ``mix``
    holds MLA's projections (:func:`attn.init_mla`).

    ``shard(tree, axes)`` (e.g. ``dist.sharding.shard_params`` bound to a
    mesh) is applied to each leaf or layer as soon as it is drawn, so a
    rank keeps only its blocks of the same numbers the whole draw gives
    and never holds more than one whole layer."""
    _check_supported(cfg)
    device = torch.device(device)
    keep = shard or (lambda tree, axes: tree)
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

    def layer_kept(ltype, ftype, cross_attends):
        p = layer(ltype, ftype, cross_attends)
        return keep(p, _layer_axes(ltype, p))

    params: Dict[str, Any] = {"embed": keep(normal((cfg.vocab_size, D), D),
                                            _top_axes("embed"))}
    params["layers"] = [layer_kept(cfg.block_type(i), cfg.ffn_type(i),
                                   cfg.decoder_cross_attn)
                        for i in range(cfg.num_layers)]
    params["final_norm"] = keep(ones(D), _top_axes("final_norm"))
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(normal((D, cfg.vocab_size), D),
                                 _top_axes("lm_head"))
    if cfg.encoder_layers > 0:   # whisper's encoder (the conv frontend is a stub)
        params["encoder"] = {
            "layers": [layer_kept("attn", "dense", False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": keep(ones(D), ("embed",))}
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
               pos_per_slot: bool = False, ctx: RunCtx = RunCtx()) -> Pytree:
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
    D // H) float32.

    Under a mesh (``ctx.mesh`` or an open rules scope) ``batch`` is this
    rank's and every leaf is this rank's block under ``CACHE_AXES``: a KV
    cache holds its KV heads and its block of the rows when ``kv_seq`` is
    cut (the flash decode), ``xk`` / ``xv`` its KV heads (the context is
    encoded and projected on every rank), the latent rows are whole, and
    a recurrent state holds its channels or heads.  On the meta device
    (the step builders' shapes) the encoder is not run: its output has its
    input's shape."""
    with _mesh_scope(cfg, ctx):
        return _init_cache(params, cfg, batch, max_seq, context,
                           pos_per_slot)


def _init_cache(params, cfg, batch, max_seq, context, pos_per_slot):
    _check_supported(cfg)
    device = params["embed"].device
    if cfg.encoder_layers > 0 and context is not None and \
            context.device.type != "meta":
        context = encode(params, cfg, context)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    pos = torch.zeros((batch,) if pos_per_slot else (), dtype=torch.int32,
                      device=device)

    def zeros(name, shape_):
        return cache_leaf(name, shape_, cfg.dtype, device)

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
                xk, xv = zeros("xk", shape_x), zeros("xv", shape_x)
            layers.append({"xk": xk, "xv": xv})
            continue
        if cfg.use_mla:
            c = {"lat_c": zeros("lat_c", (batch, max_seq, cfg.kv_lora_rank)),
                 "lat_r": zeros("lat_r", (batch, max_seq, cfg.qk_rope_dim))}
        else:
            c = {"k": zeros("k", shape), "v": zeros("v", shape)}
        if cfg.decoder_cross_attn and context is not None:
            c["xk"], c["xv"] = attn.cross_kv(p["xattn"], cfg, context)
        layers.append(c)
    return {"pos": pos, "layers": layers}


def _apply_ffn(p: Dict, cfg: ModelConfig, ftype: str, x: torch.Tensor,
               stats: Optional[Dict], ctx: RunCtx = RunCtx()):
    """The residual FFN block -> (x, stats): an MoE layer adds its stats
    into ``stats``, a ``none`` FFN returns x (the reference's
    ``_apply_ffn``)."""
    if ftype == "none":
        return x, stats
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if ftype == "dense":
        return x + dense_ffn(p["ffn"], cfg, h), stats
    out, s = moe_mod.moe_ffn(p["ffn"], cfg, h, mesh=_mesh_of(ctx),
                             impl=ctx.moe_impl, batch_axes=ctx.batch_axes,
                             with_stats=stats is not None)
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
                  window: Optional[int], ctx: RunCtx = RunCtx()
                  ) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if ltype == "xattn":
        mixed = attn.cross_attention(p["mix"], cfg, h,
                                     (cache["xk"], cache["xv"]), gated=True,
                                     decode=True)
    elif ltype in ssm.DECODE:
        mixed, _ = ssm.DECODE[ltype](p["mix"], cfg, h, cache)
    elif cfg.use_mla:
        if ctx.decode_impl == "flash" and _mesh_of(ctx) is not None:
            raise NotImplementedError(
                f"{cfg.name}: MLA decodes over its whole latent rows; "
                "decode_impl='flash' over rows cut over a mesh is not "
                "ported (no cell of the JAX package's decodes MLA so)")
        mixed, _ = attn.mla_decode(p["mix"], cfg, h,
                                   (cache["lat_c"], cache["lat_r"]), pos)
    elif ctx.decode_impl == "flash" and _mesh_of(ctx) is not None:
        mixed, _ = attn.flash_decode_shardmap(
            p["mix"], cfg, h, (cache["k"], cache["v"]), pos, window=window)
    else:
        mixed, _ = attn.attention_decode(p["mix"], cfg, h,
                                         (cache["k"], cache["v"]), pos,
                                         window=window)
    x = x + mixed
    if cfg.decoder_cross_attn and ltype in ("attn", "local") and \
            "xk" in cache:
        x = _cross_attend(p, cfg, x, (cache["xk"], cache["xv"]), decode=True)
    x, _ = _apply_ffn(p, cfg, ftype, x, None, ctx)
    return x


def _full_layer(p: Dict, cfg: ModelConfig, ltype: str, ftype: str,
                x: torch.Tensor, window: Optional[int],
                stats: Optional[Dict], context=None, q_offset=None,
                cache=None, span=None, k_rows=None, ctx: RunCtx = RunCtx()):
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
    x, stats = _apply_ffn(p, cfg, ftype, x, stats, ctx)
    return x, rows, stats


def _zero_stats(cfg: ModelConfig, device) -> Optional[Dict]:
    if cfg.num_experts == 0:
        return None
    return {"expert_load": torch.zeros(cfg.num_experts, dtype=torch.int32,
                                       device=device),
            "dropped": torch.zeros((), dtype=torch.int32, device=device)}


def _embed(params: Pytree, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    cut = shd.cut(_top_axes("embed"), (cfg.vocab_size, cfg.d_model), 0)
    if cut:       # this rank's rows: the ids it holds, zeros elsewhere
        idx = tokens.long() - shd.block_start(cut, cfg.vocab_size)
        mine = (idx >= 0) & (idx < emb.shape[0])
        x = embed_lookup(emb, idx.clamp(0, emb.shape[0] - 1), mine)
        # one nonzero term per entry: the float32 sum is the row exactly;
        # backward, each rank adds the cotangent rows of its own ids
        x = dist.psum(x.to(torch.float32), cut).to(emb.dtype)
    else:
        x = embed_lookup(emb, tokens)
    x = x.to(cfg.dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    return x


def _remat_layer(p: Dict, cfg: ModelConfig, ltype: str, ftype: str,
                 x: torch.Tensor, window: Optional[int],
                 stats: Optional[Dict], context, ctx: RunCtx = RunCtx()):
    """One layer under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward (the JAX
    package's ``remat="full"``, which wraps each period).  The recompute
    reopens the forward's mesh scope: autograd may run it on a thread that
    does not see the caller's."""
    scope = shd.capture()

    def run(x, stats, context):
        with shd.use_scope(scope):
            x, _, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                      context, ctx=ctx)
        return x, stats
    return checkpoint(run, x, stats, context, use_reentrant=False)


def _forward(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor,
             cache_layers=None, prefix_len=None, context=None,
             remat: bool = False, ctx: RunCtx = RunCtx(),
             with_stats: bool = True):
    """(final hidden states of (B, S) tokens, MoE stats or None); with
    ``cache_layers``, the rows each layer caches (its (k, v), or MLA's
    latent rows) are written in place into rows [0, S) of its cache, or,
    with ``prefix_len``, into rows [prefix_len, prefix_len + S) after the
    cached prefix rows it attends to.  A
    ``context`` is encoded first when the arch has an encoder, then every
    cross-attending layer attends to it.  ``remat`` (training) recomputes
    each layer in the backward (:func:`_remat_layer`).  ``with_stats=False``
    skips the MoE stats (the prefill drops them: under a mesh they cost a
    collective a layer)."""
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    stats = _zero_stats(cfg, x.device) if with_stats else None
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
                                    context, ctx)
            continue
        if prefix_len is not None:
            x, _, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                      None, prefix_len, cache_layers[i],
                                      span, k_rows, ctx)
            continue
        x, rows, stats = _full_layer(p, cfg, ltype, ftype, x, window, stats,
                                     context, ctx=ctx)
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
                       context: Optional[torch.Tensor] = None,
                       ctx: RunCtx = RunCtx()
                       ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Token ids (B, S) -> (final hidden states (B, S, D), stats): the JAX
    package's ``forward`` (no remat; :func:`loss_fn` is the training form),
    under the caller's grad mode.  ``context`` (B, Sc, D) conditions a
    context arch (encoded first when it has an encoder).  ``stats`` is
    ``{"expert_load": (E,) int32, "dropped": int32}`` summed over the MoE
    layers, or None without experts.  Under a mesh (``ctx``) ``tokens`` is
    this rank's block of the batch and every rank gets its rows' hidden
    states whole."""
    with _mesh_scope(cfg, ctx):
        return _forward(params, cfg, tokens, context=context, ctx=ctx)


def forward(params: Pytree, cfg: ModelConfig, tokens: torch.Tensor, *,
            context: Optional[torch.Tensor] = None,
            ctx: RunCtx = RunCtx()) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)
    (:func:`forward_with_stats` without the stats)."""
    return forward_with_stats(params, cfg, tokens, context=context,
                              ctx=ctx)[0]


@torch.no_grad()
def prefill(params: Pytree, cfg: ModelConfig, cache: Pytree,
            tokens: torch.Tensor, lengths: torch.Tensor,
            prefix_len: Optional[torch.Tensor] = None, *,
            ctx: RunCtx = RunCtx()) -> Tuple[torch.Tensor, Pytree]:
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

    Under a mesh (``ctx``) the cache is this rank's (its KV heads) and the
    logits are gathered whole on every rank.
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
    with _mesh_scope(cfg, ctx):
        h, _ = _forward(params, cfg, tokens, cache["layers"], prefix_len,
                        ctx=ctx, with_stats=False)
        rows = torch.arange(B, device=h.device)
        logits = unembed(params, cfg, h[rows, lengths.long() - 1])
    pos = torch.full_like(cache["pos"], S) if prefix_len is None else \
        (prefix_len + S).to(cache["pos"].dtype)
    return logits, {"pos": pos, "layers": cache["layers"]}


def unembed(params: Pytree, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits in float32: products of the activation-dtype inputs summed in
    float32, as ``preferred_element_type=float32`` does.  With the vocab
    cut over a mesh's axes (``embed`` / ``lm_head`` hold this rank's vocab
    rows / columns) the logits of every rank are gathered."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(h.to(torch.float32), w.to(torch.float32))
    cut = shd.cut(_top_axes("lm_head"), (cfg.d_model, cfg.vocab_size), 1)
    if cut:       # this rank's vocab columns: gather every rank's
        logits = dist.all_gather(logits.movedim(-1, 0), cut, tiled=True)
        logits = logits.movedim(0, -1).contiguous()
    return logits


# ---------------------------------------------------------------------------
# training: the loss
# ---------------------------------------------------------------------------

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


def _ce(params: Pytree, cfg: ModelConfig, h: torch.Tensor,
        labels: torch.Tensor, mask: torch.Tensor):
    """:func:`_ce_from_logits` of h's logits.  With the vocab cut over a
    mesh's axes the logits stay cut, never gathered: the row max is a
    ``pmax``, the sum of exponentials and the gold logit are ``psum``s
    (differentiable: each rank's cotangent reaches its own columns), and
    the argmax is the lowest vocab id holding the global max."""
    cut = shd.cut(_top_axes("lm_head"), (cfg.d_model, cfg.vocab_size), 1)
    if not cut:
        return _ce_from_logits(unembed(params, cfg, h), labels, mask)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    lf = torch.matmul(dist.enter(h, cut).to(torch.float32),
                      w.to(torch.float32))
    Vl, v0 = lf.shape[-1], shd.block_start(cut, cfg.vocab_size)
    with torch.no_grad():
        mx_l, arg_l = torch.max(lf, dim=-1)
        mx = dist.pmax(mx_l, cut)
        top = dist.pmin(torch.where(mx_l == mx, arg_l + v0,
                                    cfg.vocab_size), cut)
    lse = mx + torch.log(dist.psum(torch.exp(lf - mx[..., None]).sum(-1),
                                   cut))
    idx = labels.long() - v0
    mine = (idx >= 0) & (idx < Vl)
    gold = torch.gather(lf, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = dist.psum(torch.where(mine, gold, torch.zeros_like(gold)), cut)
    loss = (lse - gold) * mask
    correct = (top == labels) & (mask > 0)
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
    full (B, S, V) logits are never live.

    Under a mesh (``ctx.mesh`` or an open rules scope) ``params`` are this
    rank's blocks and ``batch`` its rows: the cross-entropy runs on the
    vocab-cut logits (:func:`_ce`), the metrics are this rank's (the MoE
    stats summed over the model axis only), and the mean divides by the
    token count summed over ``ctx.batch_axes``, so that the sum of the
    ranks' gradients over those axes is the gradient of the global mean.
    A context arch's ``batch["context"]`` is this rank's rows of it."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    labels_safe = torch.clamp(labels, min=0)
    S = tokens.shape[1]
    with _mesh_scope(cfg, ctx):
        meshed = shd.current_rules() is not None
        fctx = dataclasses.replace(ctx, batch_axes=()) if meshed else ctx
        h, stats = _forward(params, cfg, tokens,
                            context=batch.get("context"),
                            remat=ctx.remat == "full", ctx=fctx)
        if ctx.ce_chunk and S % ctx.ce_chunk == 0:
            scope = shd.capture()

            def chunk(hc, lc, mc):
                with shd.use_scope(scope):
                    return _ce(params, cfg, hc, lc, mc)
            loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
            correct = torch.zeros((), dtype=torch.int32, device=h.device)
            for c0 in range(0, S, ctx.ce_chunk):
                sl = slice(c0, c0 + ctx.ce_chunk)
                ls, cr = checkpoint(chunk, h[:, sl], labels_safe[:, sl],
                                    mask[:, sl], use_reentrant=False)
                loss_sum, correct = loss_sum + ls, correct + cr
        else:
            loss_sum, correct = _ce(params, cfg, h, labels_safe, mask)
        ntok = mask.sum()
        denom = dist.psum(ntok, ctx.batch_axes) if meshed and \
            ctx.batch_axes else ntok
    metrics = {"loss_sum": loss_sum, "tokens": ntok,
               "correct": correct.to(torch.float32)}
    if stats is not None:
        metrics["expert_load"] = stats["expert_load"].to(torch.float32)
        metrics["moe_dropped"] = stats["dropped"].to(torch.float32)
    return loss_sum / torch.clamp(denom, min=1.0), metrics


@torch.no_grad()
def decode_step(params: Pytree, cfg: ModelConfig, cache: Pytree,
                tokens: torch.Tensor, *, ctx: RunCtx = RunCtx()
                ) -> Tuple[torch.Tensor, Pytree]:
    """One serving step: (B, 1) new tokens -> (B, 1, V) float32 logits and
    the cache, its KV rows written in place and ``pos`` advanced.  Under a
    mesh (``ctx``) the cache is this rank's and the logits are gathered
    whole on every rank; ``ctx.decode_impl="flash"`` decodes over a cache
    whose rows are cut (a scalar ``pos``)."""
    pos = cache["pos"]
    with _mesh_scope(cfg, ctx):
        x = _embed(params, cfg, tokens)
        for i, (p, c) in enumerate(zip(params["layers"], cache["layers"])):
            x = _decode_layer(p, cfg, cfg.block_type(i), cfg.ffn_type(i), x,
                              c, pos, layer_window(cfg, i), ctx)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = unembed(params, cfg, x)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


def num_params(params: Pytree) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))
