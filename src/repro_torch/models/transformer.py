"""Model assembly for the dense family: init, decode cache, decode step.

The port of the serving half of ``repro/models/transformer.py``.  The JAX
package stacks the layers over a leading ``n_periods`` dim and runs them
with ``lax.scan``; here ``params["layers"]`` is a list of per-layer dicts run
by a Python loop (``models/convert.py`` unstacks JAX weights).  The decode
cache mirrors that: ``{"pos": (B,) or (), "layers": [{"k", "v"}, ...]}``, and
:func:`decode_step` updates it in place (the JAX engine donates its cache).

MoE, SSM, MLA, cross-attention and the encoder are later slices of the port
(``init_params`` / ``init_cache`` raise for them).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from . import attention as attn
from .common import ModelConfig, dense, embed_lookup, init_normal, rms_norm

Pytree = Any


def _check_supported(cfg: ModelConfig) -> None:
    for i in range(cfg.num_layers):
        if cfg.block_type(i) != "attn" or cfg.ffn_type(i) != "dense":
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is ({cfg.block_type(i)}, "
                f"{cfg.ffn_type(i)}); the port runs the dense family only "
                "(MoE / SSM / local attention are later slices)")


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Pytree:
    """Random parameters with the JAX package's shapes and scales
    (``std = 1/sqrt(fan_in)``, norms at one), drawn from ``gen``."""
    _check_supported(cfg)
    device = torch.device(device)
    D, H, KV, hd, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    dt = cfg.dtype

    def normal(shape, fan_in):
        return init_normal(gen, shape, fan_in, dt, device)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    params: Dict[str, Any] = {"embed": normal((cfg.vocab_size, D), D)}
    layers: List[Dict] = []
    for _ in range(cfg.num_layers):
        mix = {"wq": normal((D, H, hd), D), "wk": normal((D, KV, hd), D),
               "wv": normal((D, KV, hd), D), "wo": normal((H, hd, D), H * hd)}
        if cfg.qkv_bias:
            mix.update(bq=torch.zeros((H, hd), dtype=dt, device=device),
                       bk=torch.zeros((KV, hd), dtype=dt, device=device),
                       bv=torch.zeros((KV, hd), dtype=dt, device=device))
        if cfg.qk_norm:
            mix.update(q_norm=ones(hd), k_norm=ones(hd))
        ffn = {"w_up": normal((D, Fd), D), "w_down": normal((Fd, D), Fd)}
        if cfg.gated_ffn:
            ffn["w_gate"] = normal((D, Fd), D)
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


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) if cfg.act_fn == "silu" else F.gelu(x)


def dense_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = dense(x, p["w_up"])
    if cfg.gated_ffn:
        up = _act(cfg, dense(x, p["w_gate"])) * up
    else:
        up = _act(cfg, up)
    return dense(up, p["w_down"])


def _decode_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                  pos: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    mixed, _ = attn.attention_decode(p["mix"], cfg, h,
                                     (cache["k"], cache["v"]), pos)
    x = x + mixed
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + dense_ffn(p["ffn"], cfg, h)


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
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    for p, c in zip(params["layers"], cache["layers"]):
        x = _decode_layer(p, cfg, x, c, pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


def num_params(params: Pytree) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))
