"""The Monoid abstraction over pytrees of torch tensors.

A monoid is ``(M, combine, identity)`` with ``combine`` associative and
``identity`` its two-sided unit.  Following the paper an aggregation splits
into four pieces (§2, "Monoidify!"):

    lift     : X -> M        "monoidify" a raw mapper output      (r -> (r, 1))
    combine  : M x M -> M    the associative op / combiner body   ((s,c),(s',c')) -> (s+s', c+c')
    identity : -> M          the unit                             (0, 0)
    extract  : M -> R        one-time post-processing (fn. 3)     (s,c) -> s/c

Monoid values are pytrees (``torch.utils._pytree``: tuples, lists, dicts)
of tensors.  ``combine`` must preserve structure and shapes — the MapReduce
combiner contract that the paper's Algorithm 2 violates — which
:func:`check_structure` enforces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

Pytree = Any


def _default_lift(x: Pytree) -> Pytree:
    return x


def _default_extract(m: Pytree) -> Pytree:
    return m


def _moveaxis(xs: Pytree, axis: int) -> Pytree:
    if axis == 0:
        return xs
    return pytree.tree_map(lambda x: torch.movedim(x, axis, 0), xs)


# ---------------------------------------------------------------------------
# kernel lowerings — how the execution planner (core/plan.py) finds the
# segment-fold kernel for a monoid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelLowering:
    """A registered kernel lowering for a monoid's keyed fold.

    semiring: which semiring the segment-fold kernel runs in ('sum' for the
      additive monoids, 'max'/'min' for the max-plus family).
    fn: ``(values, seg_ids, num_segments, *, valid_mask) -> table`` —
      applied leaf-wise to the lifted value pytree; returns the per-key
      table with leading axis ``num_segments``.  ``valid_mask`` (one bool
      per record, or None) marks rows that must contribute the identity.
    """

    semiring: str
    fn: Callable[..., Pytree]


# Keyed by Monoid.name: the side table that lets plan.py register lowerings
# without core importing the kernels at module load.
_KERNEL_LOWERINGS: Dict[str, KernelLowering] = {}


def register_kernel_lowering(name: str, lowering: KernelLowering) -> None:
    """Register (or replace) the kernel lowering for monoid ``name``."""
    _KERNEL_LOWERINGS[name] = lowering


@dataclasses.dataclass(frozen=True)
class Monoid:
    """An algebraic monoid over pytrees of tensors.

    Attributes:
      name: human-readable name (error messages, the lowering registry).
      combine: associative binary op ``M x M -> M``.
      identity_fn: callable returning the identity element; shape-polymorphic
        monoids take an ``example`` kwarg — use :meth:`identity_like`.
      lift: ``X -> M`` ("monoidify" a raw value).  Defaults to the identity
        function.
      extract: ``M -> R`` one-time post-processing.  Defaults to identity.
      commutative: whether combine is commutative; reductions that reorder
        operands check this flag.
      approx_equal: optional custom equality for law checking.
    """

    name: str
    combine: Callable[[Pytree, Pytree], Pytree]
    identity_fn: Callable[..., Pytree]
    lift: Callable[[Pytree], Pytree] = _default_lift
    extract: Callable[[Pytree], Pytree] = _default_extract
    commutative: bool = True
    approx_equal: Optional[Callable[[Pytree, Pytree], bool]] = None

    def identity(self) -> Pytree:
        return self.identity_fn()

    def identity_like(self, example: Pytree) -> Pytree:
        """Identity element with the shapes/dtypes/device of ``example``."""
        try:
            return self.identity_fn(example=example)
        except TypeError:
            return self.identity_fn()

    def kernel_lowering(self) -> Optional[KernelLowering]:
        """The registered kernel lowering for this monoid, or None."""
        return _KERNEL_LOWERINGS.get(self.name)

    def __call__(self, a: Pytree, b: Pytree) -> Pytree:
        return self.combine(a, b)

    def fold(self, xs: Pytree, *, axis: int = 0, lifted: bool = True) -> Pytree:
        """Fold a stacked batch of monoid values along ``axis`` with a
        log-depth tree reduction (legal by associativity)."""
        if not lifted:
            xs = vmap(self.lift, in_dims=axis, out_dims=axis)(xs)
        return tree_fold(self, xs, axis=axis)

    def equal(self, a: Pytree, b: Pytree, *, rtol: float = 1e-5,
              atol: float = 1e-6) -> bool:
        if self.approx_equal is not None:
            return bool(self.approx_equal(a, b))
        la, sa = pytree.tree_flatten(a)
        lb, sb = pytree.tree_flatten(b)
        if sa != sb:
            return False
        for x, y in zip(la, lb):
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            if x.shape != y.shape:
                return False
            if x.is_floating_point() or x.is_complex():
                if not torch.allclose(x, y.to(x.dtype), rtol=rtol, atol=atol):
                    return False
            elif not torch.equal(x, y):
                return False
        return True


class MonoidTypeError(TypeError):
    """Raised when a combine would change the value's pytree structure or
    a leaf shape — the combiner contract of the paper's Algorithm 2."""


def check_structure(m: Monoid, a: Pytree, b: Pytree) -> None:
    """Verify ``combine(a, b)`` is structure and shape preserving."""
    out = m.combine(a, b)
    la, sa = pytree.tree_flatten(a)
    lo, so = pytree.tree_flatten(out)
    if sa != so:
        raise MonoidTypeError(
            f"monoid {m.name!r}: combine changed pytree structure {sa} -> {so}; "
            "a MapReduce combiner must map M x M -> M (paper, Algorithm 2)")
    for x, y in zip(la, lo):
        if tuple(torch.as_tensor(x).shape) != tuple(torch.as_tensor(y).shape):
            raise MonoidTypeError(
                f"monoid {m.name!r}: combine changed leaf shape "
                f"{tuple(torch.as_tensor(x).shape)} -> "
                f"{tuple(torch.as_tensor(y).shape)}")


def check_laws(m: Monoid, samples: list, *, rtol: float = 1e-4,
               atol: float = 1e-5) -> None:
    """Assert the monoid laws on concrete samples: associativity, left and
    right identity, structure preservation, commutativity if declared."""
    e = m.identity_like(samples[0]) if samples else m.identity()
    for a in samples:
        check_structure(m, a, a)
        assert m.equal(m.combine(e, a), a, rtol=rtol, atol=atol), \
            f"{m.name}: left identity failed"
        assert m.equal(m.combine(a, e), a, rtol=rtol, atol=atol), \
            f"{m.name}: right identity failed"
    for a in samples:
        for b in samples:
            if m.commutative:
                assert m.equal(m.combine(a, b), m.combine(b, a),
                               rtol=rtol, atol=atol), \
                    f"{m.name}: commutativity failed"
            for c in samples:
                lhs = m.combine(m.combine(a, b), c)
                rhs = m.combine(a, m.combine(b, c))
                assert m.equal(lhs, rhs, rtol=rtol, atol=atol), \
                    f"{m.name}: associativity failed"


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------

def tree_fold(m: Monoid, xs: Pytree, *, axis: int = 0) -> Pytree:
    """Log-depth tree reduction of stacked monoid values along ``axis``.

    The batch size need not be a power of two: an odd remainder is carried
    to the next level.
    """
    xs = _moveaxis(xs, axis)
    n = pytree.tree_leaves(xs)[0].shape[0]
    if n == 0:
        raise ValueError("tree_fold over empty batch; use identity_like instead")
    combine = vmap(m.combine)
    while n > 1:
        half = n // 2
        # pair ADJACENT elements so the re-bracketing keeps sequence order —
        # required for non-commutative monoids
        lo = pytree.tree_map(lambda x: x[0:2 * half:2], xs)
        hi = pytree.tree_map(lambda x: x[1:2 * half:2], xs)
        merged = combine(lo, hi)
        if n % 2:
            merged = pytree.tree_map(lambda a, x: torch.cat([a, x[-1:]], 0),
                                     merged, xs)
            n = half + 1
        else:
            n = half
        xs = merged
    return pytree.tree_map(lambda x: x[0], xs)


def scan_fold(m: Monoid, xs: Pytree, *, axis: int = 0,
              init: Optional[Pytree] = None) -> Pytree:
    """Serial in-mapper-combining fold (the paper's Algorithm 4): an
    accumulator held across inputs, emitted once.  ``init`` defaults to the
    identity."""
    xs = _moveaxis(xs, axis)
    n = pytree.tree_leaves(xs)[0].shape[0]
    acc = init
    for i in range(n):
        x = pytree.tree_map(lambda v: v[i], xs)
        if acc is None:
            acc = m.identity_like(x)
        acc = m.combine(acc, x)
    return acc


def fold_map(m: Monoid, fn: Callable[[Pytree], Pytree], xs: Pytree, *,
             axis: int = 0, strategy: str = "scan") -> Pytree:
    """map-then-fold: ``fold(lift(fn(x)) for x in xs)``.

    strategy='scan' is in-mapper combining (Algorithm 4: nothing
    materialized); strategy='tree' materializes the lifted values, then
    tree-reduces (Algorithm 3: combiner on materialized map output).
    """
    if strategy == "scan":
        xs = _moveaxis(xs, axis)
        n = pytree.tree_leaves(xs)[0].shape[0]
        acc = None
        for i in range(n):
            v = m.lift(fn(pytree.tree_map(lambda x: x[i], xs)))
            acc = m.combine(m.identity_like(v) if acc is None else acc, v)
        return acc
    if strategy == "tree":
        lifted = vmap(lambda x: m.lift(fn(x)), in_dims=axis, out_dims=0)(xs)
        return tree_fold(m, lifted, axis=0)
    raise ValueError(f"unknown strategy {strategy!r}")
