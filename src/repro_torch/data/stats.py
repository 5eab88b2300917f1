"""Streaming corpus statistics as one product monoid (paper §3).

One accumulator tracks, over the token stream:
  * ``cms``   — count-min sketch of token frequencies (the ``cms_update``
                CUDA kernel on the card),
  * ``hll``   — HyperLogLog of distinct token ids,
  * ``bloom`` — Bloom filter of seen ids (membership),
  * ``count`` — exact token count,

combined per batch with in-mapper combining (Algorithm 4: the whole batch is
vector-lifted into ONE monoid value, then folded into the carried state by
the execution planner).  The same monoid serves the streaming path and any
batch job (the Summingbird observation, paper §4).  The state is a dict of
tensors, the JAX package's state leaf for leaf; :func:`state_from_numpy`
carries a JAX state across.  Combining per-host states across devices
(:func:`sync_stats`) is the mesh tier, a later slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import monoids
from ..core.monoid import Monoid
from ..core.plan import _MESH_TODO, execute_fold
from ..device import resolve_device


def make_stream_stats(*, cms_depth: int = 4, cms_width: int = 2048,
                      hll_precision: int = 10,
                      bloom_bits: int = 1 << 14) -> Monoid:
    return monoids.product(
        cms=monoids.count_min(cms_depth, cms_width),
        hll=monoids.hyperloglog(hll_precision),
        bloom=monoids.bloom_filter(bloom_bits),
        count=monoids.count,
    )


def init_stats(m: Monoid, device="cuda") -> Dict[str, torch.Tensor]:
    """The identity state on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``)."""
    dev = resolve_device(device)
    return pytree.tree_map(lambda x: x.to(dev), m.identity())


def state_from_numpy(state: Dict[str, Any], device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """Carry a JAX stream-stats state across: a dict of numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``) -> the port's state on
    ``device``, dtypes kept, ready for :func:`update_stats` to continue."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in state.items()}


# Structural combine for any stream-stats state: parameter-free (widths come
# from the state's shapes), so the fold needs no Monoid argument.
_STATS_COMBINE = Monoid(
    name="stream_stats",
    combine=lambda a, b: {
        "cms": a["cms"] + b["cms"],
        "hll": torch.maximum(a["hll"], b["hll"]),
        "bloom": torch.bitwise_or(a["bloom"], b["bloom"]),
        "count": a["count"] + b["count"],
    },
    identity_fn=lambda *, example: pytree.tree_map(torch.zeros_like, example),
)


def _batch_value(state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 valid_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Vector-lift a whole token batch into ONE stats monoid value.

    Shapes are taken from ``state``, so the value matches whatever widths
    ``make_stream_stats`` chose.  ``valid_mask`` (same shape as ``tokens``)
    is the ragged path: padding tokens contribute the identity to every
    component."""
    flat = tokens.reshape(-1)
    mask = None if valid_mask is None else \
        valid_mask.to(torch.bool).reshape(-1)
    # the bool mask is the kernel's weight as it is (the plain version
    # takes it as 0/1)
    cms = monoids.cms_update_batch(torch.zeros_like(state["cms"]), flat,
                                   weights=mask)
    hll = monoids.hll_update_batch(torch.zeros_like(state["hll"]), flat,
                                   valid_mask=mask)
    bloom = torch.zeros_like(state["bloom"])
    hit = (torch.ones_like(flat, dtype=bloom.dtype) if mask is None
           else mask.to(bloom.dtype))
    for s in range(4):
        idx = monoids._uhash(flat, s) % bloom.shape[-1]
        # masked-out tokens set no bits
        bloom = bloom.scatter_reduce(0, idx, hit, reduce="amax",
                                     include_self=True)
    dtype = state["count"].dtype
    count = (torch.tensor(flat.shape[0], dtype=dtype, device=flat.device)
             if mask is None else mask.sum().to(dtype))
    return {"cms": cms, "hll": hll, "bloom": bloom, "count": count}


def update_stats(state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 valid_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Fold one (possibly ragged) token batch into the stats state: the
    batch's value and the state, combined through the execution planner
    (tree fold over [state, batch_value]).  With ``valid_mask`` only True
    positions count."""
    bval = _batch_value(state, tokens, valid_mask)
    stacked = pytree.tree_map(lambda a, b: torch.stack([a, b]), state, bval)
    return execute_fold(_STATS_COMBINE, stacked)


def sync_stats(m: Monoid, state: Dict[str, torch.Tensor],
               mesh_axes: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """Combining per-host stats across devices is not ported yet."""
    raise NotImplementedError(f"sync_stats: {_MESH_TODO}")


def summarize(m: Monoid, state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """extract(): approximate distinct count, total, heavy-hitter counts."""
    out = m.extract(state)
    return {"tokens": int(out["count"]),
            "approx_distinct": float(out["hll"]),
            "cms": state["cms"], "bloom": state["bloom"]}
