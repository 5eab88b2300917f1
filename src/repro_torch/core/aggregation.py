"""Local (on-device) monoid aggregation and byte accounting.

The local half of the JAX package's ``core/aggregation.py``: the combiner
that runs before any collective, the monoid families the collectives lower
to, and the byte count of a value pytree.  Keyed folds live in
:mod:`repro_torch.core.plan` (``execute_fold``).
"""
from __future__ import annotations

import math

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


def tree_bytes(tree: Pytree) -> int:
    """Total bytes of all leaves (real or ``meta``-device tensors)."""
    return int(sum(math.prod(leaf.shape) * leaf.element_size()
                   for leaf in pytree.tree_leaves(tree)))
