"""Weight carry-over from the JAX package.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
parameters: the same leaves, with the layers unstacked into one dict per
layer in layer order.  The JAX package stacks a period of ``P`` layer slots
over a leading ``n_periods`` dim (``params["layers"]["slot_j"]``) and keeps
the ``num_layers - n_periods * P`` remainder layers unrolled
(``params["rem_i"]``; gemma3's 26 = 4 x 6 + 2), so layer ``p * P + j`` is
period ``p`` of slot ``j`` and layer ``n_periods * P + i`` is ``rem_i``.  The
two models then compute the same function.  Nested leaves carry over as they
are: an MoE layer's ``ffn`` holds ``router``, ``we_gate``, ``we_up``,
``we_down`` and the ``shared`` dense FFN dict; a cross-attending layer's
``xattn`` dict (with its 0-d ``gate``) and ``norm_x``; an ``xattn`` layer's
``mix`` with its ``gate``; a recurrent layer's ``mix`` (Mamba's ``A_log``,
``D_skip``, ``dt_bias``, conv and projections; mLSTM's ``b_if`` and
``ln_g``; sLSTM's block-diagonal ``w_h``), and no ``norm2`` / ``ffn`` where
the FFN is ``none``.  The encoder's unrolled ``encoder["layer_i"]`` become
the list ``encoder["layers"]``, beside its ``final_norm``.
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


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """The port's parameters from the JAX package's (dense, MoE,
    context-conditioned and recurrent families; layers stacked with period
    ``cfg.period`` plus remainder layers; the encoder's layers unrolled),
    cast to ``cfg.dtype`` on ``device``."""
    _check_supported(cfg)
    device = torch.device(device)

    def conv(a):
        return _to_tensor(a, cfg.dtype, device)

    P = cfg.period
    n_periods = cfg.num_layers // P
    stacks = tree.get("layers", {})
    slots = [f"slot_{j}" for j in range(P)] if n_periods else []
    if sorted(stacks) != sorted(slots):
        raise ValueError(f"JAX stack holds slots {sorted(stacks)}; "
                         f"{n_periods} periods of {P} layers need {slots}")
    layers = []
    for p in range(n_periods):
        for j in range(P):
            stacked = stacks[f"slot_{j}"]
            n = pytree.tree_leaves(stacked)[0].shape[0]
            if n != n_periods:
                raise ValueError(f"JAX slot_{j} stacks {n} periods; config "
                                 f"says {n_periods}")
            layers.append(pytree.tree_map(
                lambda a, p=p: conv(np.asarray(a)[p]), stacked))
    for i in range(cfg.num_layers - n_periods * P):
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
