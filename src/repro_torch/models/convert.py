"""Weight carry-over from the JAX package.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
parameters: the same leaves, with the layers unstacked into one dict per
layer in layer order.  The JAX package unrolls the first ``pre =
prelude_dense_layers`` layers (``params["prelude_i"]``; deepseek-v2's dense
first layer), stacks a period of ``P`` layer slots over a leading
``n_periods = (num_layers - pre) // P`` dim (``params["layers"]["slot_j"]``)
and keeps the remaining layers unrolled (``params["rem_i"]``; gemma3's 26 =
4 x 6 + 2), so layer ``i < pre`` is ``prelude_i``, layer ``pre + p * P + j``
is period ``p`` of slot ``j`` and layer ``pre + n_periods * P + i`` is
``rem_i``.  The two models then compute the same function.  Nested leaves carry over as they
are: an MoE layer's ``ffn`` holds ``router``, ``we_gate``, ``we_up``,
``we_down`` and the ``shared`` dense FFN dict; a cross-attending layer's
``xattn`` dict (with its 0-d ``gate``) and ``norm_x``; an MLA layer's
``mix`` (``wq_a`` / ``q_a_norm`` / ``wq_b`` or ``wq``, ``wkv_a``,
``kv_a_norm``, ``wk_b``, ``wv_b``, ``wo``); an ``xattn`` layer's
``mix`` with its ``gate``; a recurrent layer's ``mix`` (Mamba's ``A_log``,
``D_skip``, ``dt_bias``, conv and projections; mLSTM's ``b_if`` and
``ln_g``; sLSTM's block-diagonal ``w_h``), and no ``norm2`` / ``ffn`` where
the FFN is ``none``.  The encoder's unrolled ``encoder["layer_i"]`` become
the list ``encoder["layers"]``, beside its ``final_norm``.

:func:`to_jax_layout` / :func:`from_jax_layout` move any tree shaped like
the port's parameters (gradients, error-feedback state) into the JAX
package's stacked layout and back, for what reads a stacked leaf as one
unit (the lossy gradient compressors select and scale per leaf).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.utils._pytree as pytree

from .common import ModelConfig
from .transformer import _check_supported


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # numpy has no bfloat16: JAX's bf16 arrays arrive as ml_dtypes arrays,
    # which go through float32 (exact for bf16 values)
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(
        device=device, dtype=dtype)


def _plan(cfg: ModelConfig):
    """(prelude layers, period P, n_periods, remainder layers): the JAX
    package's ``_layer_plan`` / ``_num_periods``."""
    pre, P = cfg.prelude_dense_layers, cfg.period
    n_periods = (cfg.num_layers - pre) // P
    return pre, P, n_periods, cfg.num_layers - pre - n_periods * P


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """The port's parameters from the JAX package's (dense, MoE, MLA,
    context-conditioned and recurrent families; prelude layers, layers
    stacked with period ``cfg.period``, remainder layers; the encoder's
    layers unrolled), cast to ``cfg.dtype`` on ``device``."""
    _check_supported(cfg)
    device = torch.device(device)

    def conv(a):
        return _to_tensor(a, cfg.dtype, device)

    pre, P, n_periods, n_rem = _plan(cfg)
    stacks = tree.get("layers", {})
    slots = [f"slot_{j}" for j in range(P)] if n_periods else []
    if sorted(stacks) != sorted(slots):
        raise ValueError(f"JAX stack holds slots {sorted(stacks)}; "
                         f"{n_periods} periods of {P} layers need {slots}")
    layers = [pytree.tree_map(conv, tree[f"prelude_{i}"])
              for i in range(pre)]
    for p in range(n_periods):
        for j in range(P):
            stacked = stacks[f"slot_{j}"]
            n = pytree.tree_leaves(stacked)[0].shape[0]
            if n != n_periods:
                raise ValueError(f"JAX slot_{j} stacks {n} periods; config "
                                 f"says {n_periods}")
            layers.append(pytree.tree_map(
                lambda a, p=p: conv(np.asarray(a)[p]), stacked))
    for i in range(n_rem):
        layers.append(pytree.tree_map(conv, tree[f"rem_{i}"]))
    out = {k: conv(v) for k, v in tree.items()
           if k not in ("layers",) and not isinstance(v, dict)}
    out["layers"] = layers
    if cfg.encoder_layers > 0:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [pytree.tree_map(conv, enc[f"layer_{i}"])
                       for i in range(cfg.encoder_layers)],
            "final_norm": conv(enc["final_norm"])}
    return out


def to_jax_layout(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """A tree shaped like the port's parameters in the JAX package's
    layout: the prelude layers become ``prelude_i``, layer ``pre + p * P +
    j`` period ``p`` of ``layers["slot_j"]`` (stacked along a new leading
    dim), the remainder layers ``rem_i``, the encoder's layers
    ``encoder["layer_i"]``."""
    pre, P, n_periods, n_rem = _plan(cfg)
    layers = tree["layers"]
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    for i in range(pre):
        out[f"prelude_{i}"] = layers[i]
    if n_periods:
        out["layers"] = {
            f"slot_{j}": pytree.tree_map(
                lambda *xs: torch.stack(xs),
                *[layers[pre + p * P + j] for p in range(n_periods)])
            for j in range(P)}
    for i in range(n_rem):
        out[f"rem_{i}"] = layers[pre + n_periods * P + i]
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {f"layer_{i}": layer
                          for i, layer in enumerate(enc["layers"])}
        out["encoder"]["final_norm"] = enc["final_norm"]
    return out


def from_jax_layout(tree: Dict[str, Any], cfg: ModelConfig,
                    like: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`to_jax_layout` (tensors kept as they are:
    views of the stacked leaves), with the keys in ``like``'s order, so it
    flattens leaf for leaf as ``like`` does."""
    pre, P, n_periods, n_rem = _plan(cfg)
    layers = [tree[f"prelude_{i}"] for i in range(pre)]
    layers += [pytree.tree_map(lambda a, p=p: a[p],
                               tree["layers"][f"slot_{j}"])
               for p in range(n_periods) for j in range(P)]
    layers += [tree[f"rem_{i}"] for i in range(n_rem)]
    out = {k: v for k, v in tree.items()
           if k not in ("layers", "encoder") and
           not k.startswith(("rem_", "prelude_"))}
    out["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [enc[f"layer_{i}"] for i in range(cfg.encoder_layers)],
            "final_norm": enc["final_norm"]}
    return _ordered_as(out, like)


def _ordered_as(tree, like):
    if isinstance(like, dict):
        return {k: _ordered_as(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_ordered_as(t, x) for t, x in zip(tree, like))
    return tree
