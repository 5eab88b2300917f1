"""Monoid aggregation: the combiner, the cross-device combine, and bytes.

The port of the JAX package's ``core/aggregation.py``:

* :func:`local_fold` — the combiner, run before any collective touches the
  wire.  Keyed folds live in :mod:`repro_torch.core.plan` (``execute_fold``).
* :func:`monoid_allreduce` — a monoid combine across a bound mesh axis
  (:mod:`repro_torch.dist`), lowering to the cheapest collective the monoid
  admits: a sum for the additive family, ``mean`` and ``cms*``; a max for
  ``max``, ``bitwise_or`` (0/1 bitmaps) and ``hll*``; a min; the rescaled
  max-then-sum of the flash-decoding merge for ``logsumexp`` /
  ``attn_state``; and an all-gather plus an on-device tree fold, in rank
  order, for any other monoid.
* :func:`monoid_reduce_scatter`, :func:`hierarchical_psum`,
  :func:`monoid_hierarchical_allreduce` — the rack-aware aggregation of §2:
  reduce-scatter inside the pod, all-reduce across pods on the scattered
  shard, all-gather back.  Legal only because the value is a monoid.
* :func:`grad_accum_fold` — in-mapper combining over microbatches.

The cross-device functions run inside ``dist.use_mesh``; each rank calls
them with its own value, as each device runs the body of ``shard_map``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from .. import dist
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


# matched against Monoid.name: monoids.stripes / monoids.grad_sum are
# aliases of sum_ (name 'sum'), so they need no entries of their own
_PSUM_LIKE = {"sum", "count"}
_PMAX_LIKE = {"max", "bitwise_or"}   # 0/1 bitmaps: OR == max
_PMIN_LIKE = {"min"}


# ---------------------------------------------------------------------------
# cross-device combine — the shuffle, minimized
# ---------------------------------------------------------------------------

def _rescale(mx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """exp(m - g), 0 where a party holds no mass (m = -inf)."""
    return torch.where(torch.isneginf(mx), torch.zeros_like(mx),
                       torch.exp(mx - g))


def monoid_allreduce(m: Monoid, x: Pytree, axis_name: Any, *,
                     async_op: bool = False):
    """Combine monoid values across a bound mesh axis (or a tuple of axes).

    Picks the cheapest legal collective:
      * additive monoids, mean, cms   -> one sum
      * max / bitwise_or / hll        -> max (0/1 bitmaps: OR == max)
      * min                           -> min
      * logsumexp / attn_state        -> max of m, then the sum of the
                                         rescaled terms (the distributed
                                         flash-decoding merge)
      * anything else                 -> all-gather + on-device tree fold,
                                         in rank (= coordinate) order
    With ``async_op=True`` the first collective is issued and a
    :class:`repro_torch.dist.Pending` comes back.
    """
    name = m.name
    if name in _PSUM_LIKE or name == "mean" or name.startswith("cms"):
        p = dist.psum(x, axis_name, async_op=True)
    elif name in _PMAX_LIKE or name.startswith("hll"):
        p = dist.pmax(x, axis_name, async_op=True)
    elif name in _PMIN_LIKE:
        p = dist.pmin(x, axis_name, async_op=True)
    elif name == "logsumexp":
        mx, l = x
        p = dist.pmax(mx, axis_name, async_op=True).then(
            lambda g: (g, dist.psum(l * _rescale(mx, g), axis_name)))
    elif name == "attn_state":
        mx, l, o = x

        def merge(g):
            scale = _rescale(mx, g)
            return (g, dist.psum(l * scale, axis_name),
                    dist.psum(o * scale[..., None], axis_name))
        p = dist.pmax(mx, axis_name, async_op=True).then(merge)
    else:
        p = dist.all_gather(x, axis_name, async_op=True).then(
            lambda gathered: tree_fold(m, gathered, axis=0))
    return p if async_op else p.wait()


def monoid_reduce_scatter(m: Monoid, x: Pytree, axis_name: Any) -> Pytree:
    """Reduce-scatter a (S, ...) keyed monoid value: rank i ends up owning
    the combined partials of key shard i.  The additive family uses a
    reduce-scatter; any other monoid an all-to-all plus a local fold over
    the sources, in rank order (the MapReduce shuffle).  The leading leaf
    axis S must divide by the axis size."""
    if m.name in _PSUM_LIKE or m.name == "mean" or m.name.startswith("cms"):
        return dist.psum_scatter(x, axis_name)
    size = dist.axis_size(axis_name)

    def split(v):
        s = v.shape[0]
        if s % size:
            raise ValueError(f"key axis {s} not divisible by {size}")
        return v.reshape((size, s // size) + tuple(v.shape[1:]))

    # send key shard j to rank j; receive one shard per source rank
    shuffled = dist.all_to_all(pytree.tree_map(split, x), axis_name)
    return tree_fold(m, shuffled, axis=0)


# ---------------------------------------------------------------------------
# hierarchical aggregation — reduce-scatter (ICI) -> all-reduce (DCN) ->
# all-gather (ICI)
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    n = flat.shape[0]
    rem = (-n) % mult
    if rem:
        flat = torch.cat([flat, flat.new_zeros((rem,))])
    return flat, n


def hierarchical_psum(tree: Pytree, *, ici_axis: Any,
                      dcn_axis: Any = None) -> Pytree:
    """Sum a pytree across ``ici_axis`` (and ``dcn_axis``) hierarchically.

    Per leaf: flatten -> reduce-scatter over the fast intra-pod axis (each
    rank now holds 1/|ici| of the summed leaf) -> sum the small shard over
    the slow cross-pod axis -> all-gather back over the fast axis.  DCN
    traffic per leaf is bytes/|ici| instead of the full leaf, legal by the
    associativity and commutativity of +.
    """
    ici = dist.axis_size(ici_axis)

    def per_leaf(x):
        flat, n = _pad_to(x, ici)
        shard = dist.psum_scatter(flat, ici_axis)
        if dcn_axis is not None:
            shard = dist.psum(shard, dcn_axis)
        full = dist.all_gather(shard, ici_axis, tiled=True)
        return full[:n].reshape(x.shape)

    return pytree.tree_map(per_leaf, tree)


def monoid_hierarchical_allreduce(m: Monoid, x: Pytree, axes: Sequence[Any],
                                  *, async_op: bool = False):
    """Combine across several mesh axes, one axis at a time (fast axes
    first).  A re-bracketing of the global combine, legal by
    associativity; the rank order along each gathered axis is kept, so
    non-commutative monoids combine in mesh-lexicographic order.  With
    ``async_op=True`` the first axis's collective is issued and a Pending
    comes back (the later axes run in its ``wait()``)."""
    axes = tuple(axes)
    if not axes:
        return dist.Pending.done(x) if async_op else x
    p = monoid_allreduce(m, x, axes[0], async_op=True)
    for ax in axes[1:]:
        p = p.then(lambda y, ax=ax: monoid_allreduce(m, y, ax))
    return p if async_op else p.wait()


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


def allreduce_wire_bytes(nbytes: int, axis_size: int, *,
                         algorithm: str = "ring") -> int:
    """Bytes each device puts on the wire for an all-reduce of nbytes."""
    if axis_size <= 1:
        return 0
    if algorithm == "ring":  # reduce-scatter + all-gather, 2(n-1)/n each way
        return int(2 * nbytes * (axis_size - 1) / axis_size)
    if algorithm == "gather":  # naive all-gather-everything
        return int(nbytes * (axis_size - 1))
    raise ValueError(algorithm)
