"""Local (on-device) monoid aggregation and byte accounting.

The local half of the JAX package's ``core/aggregation.py``: the combiner
that runs before any collective, the monoid families the collectives lower
to, the fast/slow (ICI/DCN) split of mesh axes the planner prices, and the
byte count of a value pytree, and the gradient accumulation fold of
training (:func:`grad_accum_fold`).  Keyed folds live in
:mod:`repro_torch.core.plan` (``execute_fold``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from .monoid import Monoid, Pytree, scan_fold, tree_fold


def local_fold(m: Monoid, xs: Pytree, *, axis: int = 0,
               strategy: str = "tree") -> Pytree:
    """Fold stacked monoid values on-device before any communication.

    strategy='tree' — log-depth reduction (Algorithm 3's combiner over
    materialized map output); strategy='scan' — in-mapper combining
    (Algorithm 4, O(1) live values).
    """
    if strategy == "tree":
        return tree_fold(m, xs, axis=axis)
    if strategy == "scan":
        return scan_fold(m, xs, axis=axis)
    raise ValueError(f"unknown strategy {strategy!r}")


# matched against Monoid.name: the monoids whose cross-device combine is a
# sum / max / min reduction
_PSUM_LIKE = {"sum", "count"}
_PMAX_LIKE = {"max", "bitwise_or"}   # 0/1 bitmaps: OR == max
_PMIN_LIKE = {"min"}


# Mesh axes wired over the slow inter-node link (DCN) rather than the fast
# one (ICI); the JAX package's ``dist/collectives.py`` definition.
DCN_AXIS_NAMES: Tuple[str, ...] = ("pod",)


def split_axis_names(axes: Sequence[Any]) -> Tuple[Tuple[Any, ...],
                                                   Tuple[Any, ...]]:
    """Classify axis names into (ici, dcn): the planner combines fast axes
    first, so the slow axis only ever sees pre-combined values."""
    names = tuple(axes)
    return (tuple(a for a in names if a not in DCN_AXIS_NAMES),
            tuple(a for a in names if a in DCN_AXIS_NAMES))


def grad_accum_fold(loss_and_grad_fn: Callable[[Pytree, Pytree],
                                               Tuple[Pytree, Pytree]],
                    params: Pytree, microbatches: Pytree
                    ) -> Tuple[Pytree, Pytree]:
    """Fold gradients over a leading microbatch axis without keeping them.

    ``loss_and_grad_fn(params, microbatch) -> (metrics_monoid_value,
    grads)``.  Both metrics and grads are folded with the Sum monoid, one
    microbatch at a time -- the paper's Algorithm 4 with the weight-vector
    monoid of §3 -- through the planner's in-mapper scan tier
    (:func:`repro_torch.core.plan.execute_fold`, ``layout="scan"``).

    Returns (metrics_accum, grads_sum); callers divide by the number of
    microbatches (an ``extract``) for the mean.
    """
    from . import monoids          # local: monoids is a sibling, not a dep
    from .plan import execute_fold

    return execute_fold(monoids.sum_, microbatches, layout="scan",
                        map_fn=lambda mb: loss_and_grad_fn(params, mb))


def tree_bytes(tree: Pytree) -> int:
    """Total bytes of all leaves (real or ``meta``-device tensors)."""
    return int(sum(math.prod(leaf.shape) * leaf.element_size()
                   for leaf in pytree.tree_leaves(tree)))
