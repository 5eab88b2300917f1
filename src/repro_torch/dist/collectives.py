"""Mesh-aware monoid collectives: cross the DCN axis once, pre-combined.

The port of the JAX package's ``dist/collectives.py``.
``core.aggregation`` combines a monoid value across named axes; this module
knows which of a mesh's axes are fast (ICI, intra-pod) and which are slow
(DCN, inter-pod: the ``pod`` axis of ``launch/mesh.py``), and orders the
reduction so the slow axis always sees already-combined values — the
paper's rack-aware combiner tree.

Each rank calls these with its own value inside ``dist.use_mesh`` (the
functions that take a ``mesh`` bind it themselves), as each device runs the
body of ``jax.shard_map``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from . import Pending, all_gather, maybe_mesh
from ..core import monoids
from ..core.aggregation import (hierarchical_psum, monoid_allreduce,
                                monoid_hierarchical_allreduce,
                                monoid_reduce_scatter)
from ..core.monoid import Monoid, Pytree

# Mesh axes wired over DCN rather than ICI.  One name today; a multi-slice
# topology adds its axes here and every reduction below stays correct by
# associativity.
DCN_AXIS_NAMES: Tuple[str, ...] = ("pod",)


def split_axis_names(axes: Sequence[Any]) -> Tuple[Tuple[Any, ...],
                                                   Tuple[Any, ...]]:
    """Classify axis names into (ici, dcn) — THE single definition of the
    fast/slow split, shared by these collectives and the execution planner
    (``core/plan.py``), so the predicted tier order is the executed one."""
    names = tuple(axes)
    return (tuple(a for a in names if a not in DCN_AXIS_NAMES),
            tuple(a for a in names if a in DCN_AXIS_NAMES))


def _names(mesh, axes: Optional[Sequence[Any]]) -> Tuple[Any, ...]:
    return tuple(axes) if axes is not None else tuple(mesh.mesh_dim_names)


def dcn_axes(mesh, axes: Optional[Sequence[Any]] = None) -> Tuple[Any, ...]:
    """The slow (cross-pod) axes among ``axes`` (default: all mesh axes)."""
    return split_axis_names(_names(mesh, axes))[1]


def ici_axes(mesh, axes: Optional[Sequence[Any]] = None) -> Tuple[Any, ...]:
    """The fast (intra-pod) axes among ``axes`` (default: all mesh axes)."""
    return split_axis_names(_names(mesh, axes))[0]


def cross_mesh_allreduce(m: Monoid, x: Pytree, mesh,
                         axes: Optional[Sequence[Any]] = None) -> Pytree:
    """Combine a monoid value across mesh axes, fast axes first: each pod
    sends one pre-combined value over DCN instead of |ici| raw partials."""
    ordered = ici_axes(mesh, axes) + dcn_axes(mesh, axes)
    with maybe_mesh(mesh):
        return monoid_hierarchical_allreduce(m, x, ordered)


def cross_axes_allreduce(m: Monoid, x: Pytree, axes: Sequence[Any]) -> Pytree:
    """Name-based :func:`cross_mesh_allreduce` — the collective tier of the
    execution planner, for the mesh bound by ``dist.use_mesh``.  Axes are
    classified by name (DCN_AXIS_NAMES) and reduced fast-first."""
    ici, dcn = split_axis_names(axes)
    return monoid_hierarchical_allreduce(m, x, ici + dcn)


def combine_keyed_table(m: Monoid, table: Pytree, axis_name: Any, *,
                        algorithm: str = "allreduce") -> Pytree:
    """Combine a keyed (num_segments, ...) monoid table across ONE mesh axis
    with the shuffle algorithm the planner chose (``Plan.shuffle_algorithm``).

    'allreduce' — :func:`monoid_allreduce`.  'reduce_scatter' — the
    MapReduce shuffle proper: each rank combines its 1/P key shard
    (``monoid_reduce_scatter``), then the shards are all-gathered back so
    every rank holds the full table; needs ``num_segments % P == 0``, which
    the planner checks before choosing it.
    """
    if algorithm == "allreduce":
        return monoid_allreduce(m, table, axis_name)
    if algorithm != "reduce_scatter":
        raise ValueError(f"unknown shuffle algorithm {algorithm!r}")
    shard = monoid_reduce_scatter(m, table, axis_name)
    return all_gather(shard, axis_name, tiled=True)


def grad_sync(grads: Pytree, mesh,
              axes: Optional[Sequence[Any]] = None) -> Pytree:
    """Data-parallel gradient all-reduce: inside a pod the sum is
    reduce-scattered over the fast axis and only the 1/|ici| shard crosses
    DCN (``hierarchical_psum``).  With no DCN axis this is a hierarchical
    sum over ICI."""
    ici = ici_axes(mesh, axes)
    dcn = dcn_axes(mesh, axes)
    if not ici and not dcn:
        return grads
    with maybe_mesh(mesh):
        if not ici:
            # pure cross-pod data parallelism: one flat sum
            return monoid_allreduce(monoids.grad_sum, grads, dcn)
        return hierarchical_psum(
            grads, ici_axis=ici if len(ici) > 1 else ici[0],
            dcn_axis=(dcn if len(dcn) > 1 else dcn[0]) if dcn else None)


def metrics_sync(metrics: Pytree, mesh,
                 axes: Optional[Sequence[Any]] = None) -> Pytree:
    """Sum-monoid metric aggregation (loss_sum, tokens, expert_load, ...):
    one combine per axis, ICI first, so DCN carries a single scalar tree."""
    return cross_mesh_allreduce(monoids.sum_, metrics, mesh, axes)


# ---------------------------------------------------------------------------
# lossy DCN crossings — compressed representations on the slow wire
# ---------------------------------------------------------------------------

def _is_message(x) -> bool:
    return isinstance(x, dict) and ("q" in x or "values" in x)


def _gather_all(t: torch.Tensor, dcn: Sequence[Any]) -> Pending:
    """Every DCN party's ``t``, stacked on dim 0 (one gather per axis)."""
    p = all_gather(t, dcn[0], async_op=True)
    for ax in dcn[1:]:
        p = p.then(lambda y, ax=ax: all_gather(y, ax))
    return p


def _lossy_dcn_combine(spec, comp: Pytree, like: Pytree, dcn: Sequence[Any],
                       *, async_op: bool = False):
    """Combine compressed gradient messages across the DCN axes; return dense.

    Each party contributes its compressed message (sparse {values, idx} or
    {q, scale}); the receiver sums the *messages* exactly — concatenate +
    scatter-add for sparse, dequantize-and-sum for int8 — so the only loss
    in the crossing is the compression, which error feedback recovers.
    What crosses the wire per party is ``spec.wire_bytes(like)``.
    """
    comps = pytree.tree_flatten(comp, is_leaf=_is_message)[0]
    gs, treedef = pytree.tree_flatten(like)

    def leaf(c, g) -> Pending:
        if spec.method == "int8":
            def dequant_sum(q, s):
                q = q.reshape((-1,) + tuple(g.shape)).to(torch.float32)
                return torch.tensordot(s.reshape(-1), q, dims=1).to(g.dtype)
            return Pending.all([_gather_all(c["q"], dcn),
                                _gather_all(c["scale"], dcn)], dequant_sum)

        def scatter_add(values, idx):
            flat = torch.zeros((c["size"],), dtype=torch.float32,
                               device=g.device)
            flat.index_put_((idx.reshape(-1).long(),), values.reshape(-1),
                            accumulate=True)
            return flat.reshape(g.shape).to(g.dtype)
        return Pending.all([_gather_all(c["values"], dcn),
                            _gather_all(c["idx"], dcn)], scatter_add)

    p = Pending.tree([leaf(c, g) for c, g in zip(comps, gs)], treedef)
    return p if async_op else p.wait()


def lossy_cross_axes(spec, grads: Pytree, axes: Sequence[Any], *,
                     ef: Pytree) -> Tuple[Pytree, Pytree]:
    """Gradient combine with a compressed DCN crossing: dense over ICI,
    ``spec``-compressed over DCN, the error-feedback residual returned as
    the new fold state.  With no DCN axis among ``axes`` compression buys
    nothing, so the dense result and ``ef`` as it was come back."""
    ici, dcn = split_axis_names(axes)
    if ici:
        grads = monoid_allreduce(monoids.grad_sum, grads, ici)
    if not dcn:
        return grads, ef
    comp, new_ef = spec.compress(grads, ef)
    return _lossy_dcn_combine(spec, comp, grads, dcn), new_ef


# ---------------------------------------------------------------------------
# async (double-buffered) microbatch fold — overlap the shuffle with compute
# ---------------------------------------------------------------------------

def async_microbatch_fold(m: Monoid, xs: Pytree, axes: Sequence[Any], *,
                          map_fn: Optional[Callable[[Pytree], Pytree]] = None,
                          lifted: bool = True, lossy=None,
                          ef: Optional[Pytree] = None, overlap: bool = True,
                          ) -> Tuple[Pytree, Optional[Pytree]]:
    """Double-buffered microbatch fold: the DCN crossing of microbatch *i*'s
    ICI-combined partial is issued (``async_op=True``) before microbatch
    *i+1*'s compute and waited for after it.  The execution behind
    ``layout='async'`` in :func:`repro_torch.core.plan.execute_fold`.

    Schedule (n microbatches, n >= 1):

        compute(0)                                    # prologue
        for i in 1..n-1:  cross(i-1)  ||  compute(i)  # overlap
        cross(n-1); combine                           # exposed epilogue

    Only the epilogue crossing is structurally un-hideable; how much of the
    n-1 pipelined crossings is hidden is the platform's measured
    ``TierCoeff.overlap_frac``.  ``overlap=False`` waits for each crossing
    before the next compute (the serial schedule a calibration compares
    with).

    Args:
      m: the fold monoid.  ``lossy`` requires an additive monoid (sum).
      xs: pytree stacked along a leading microbatch axis.
      axes: mesh axis names to combine across (classified ICI/DCN by name).
      map_fn: per-microbatch compute, applied before ``m.lift``.
      lossy: optional :class:`repro_torch.optim.compress.LossySpec` —
        compress each partial's DCN crossing, error feedback carried across
        microbatches (resumable fold state).
      ef: error-feedback state (the partial's shape) when ``lossy``.

    Returns ``(total, new_ef)``; ``new_ef`` is ``ef`` passed through (or
    updated per crossing when ``lossy``).
    """
    if lossy is not None and m.name != "sum":
        raise ValueError(
            f"lossy= compression needs an additive fold; got monoid {m.name!r}")
    ici, dcn = split_axis_names(axes)

    def local(x):
        if map_fn is not None:
            v = m.lift(map_fn(x))
        elif not lifted:
            v = m.lift(x)
        else:
            v = x
        return monoid_hierarchical_allreduce(m, v, ici) if ici else v

    def cross(v, ef_c) -> Tuple[Pending, Optional[Pytree]]:
        if not dcn:
            return Pending.done(v), ef_c
        if lossy is None:
            return monoid_hierarchical_allreduce(m, v, dcn,
                                                 async_op=True), ef_c
        comp, ef_c = lossy.compress(v, ef_c)
        return _lossy_dcn_combine(lossy, comp, v, dcn, async_op=True), ef_c

    def row(i):
        return pytree.tree_map(lambda x: x[i], xs)

    n = pytree.tree_leaves(xs)[0].shape[0]
    first = local(row(0))
    pending, ef = cross(first, ef)
    if n == 1:
        return pending.wait(), ef
    acc = m.identity_like(first)
    for i in range(1, n):
        if not overlap:
            pending = Pending.done(pending.wait())
        cur = local(row(i))                    # compute of i+1 ...
        acc = m.combine(acc, pending.wait())   # ... while i crossed
        pending, ef = cross(cur, ef)
    return m.combine(acc, pending.wait()), ef  # exposed epilogue crossing
