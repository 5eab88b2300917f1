"""The mesh scope: named mesh axes bound to ``torch.distributed`` groups.

The JAX package resolves an ``axis_name`` inside ``jax.shard_map``.  Here
each process is one rank of a world (``launch.mesh.init_distributed``) and a
``torch.distributed.device_mesh.DeviceMesh`` names its dimensions; a scope
binds those names for the collectives below::

    mesh = make_mesh((2, 4), ("pod", "data"))
    with use_mesh(mesh):
        total = psum(x, "data")

A name-based collective called outside a scope, or with a name the bound
mesh lacks, raises ``ValueError`` naming the axis: an unbound axis never
runs as a world of one.

The collectives return new tensors and never write to their inputs (the
JAX package's are functional; ``torch.distributed`` works in place, so each
one copies first).  A tuple of axis names reduces over their product, one
axis at a time, and gathers in mesh-lexicographic order (the first name
outermost), as ``jax.lax`` does.  Each collective can be issued with
``async_op=True``: it then returns a :class:`Pending` whose ``wait()``
gives the value.

Each collective is one ``torch.distributed`` call on the tensors' own
device: NCCL and gloo take all of them, for every dtype the port folds, on
CUDA tensors (``chip_smoke.py`` phase 16 checks gloo's, and fails if one
is refused).  A refused call is never caught and retried another way, and
no tensor is moved to another device.  ``bool`` tensors cross as
``uint8`` (the JAX package's sketch bitmaps are uint8).

Every collective adds to the counters of its axis (:func:`counts`): calls,
payload bytes (this rank's input) and per-device wire bytes (ring
all-reduce 2(P-1)/P x bytes, all-gather (P-1) x bytes, reduce-scatter and
all-to-all (P-1)/P x bytes), the quantities the planner's byte model
predicts.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as tdist
import torch.utils._pytree as pytree

Pytree = Any

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind ``mesh``'s dimension names for the collectives in this scope."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


@contextlib.contextmanager
def maybe_mesh(mesh):
    """:func:`use_mesh` when ``mesh`` is given, else the scope as it is."""
    if mesh is None:
        yield _MESH.get()
    else:
        with use_mesh(mesh):
            yield mesh


def current_mesh():
    """The mesh bound by the innermost :func:`use_mesh`, or None."""
    return _MESH.get()


def axis_names(axis) -> Tuple[str, ...]:
    """An axis name or a tuple of names, as a tuple."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{dimension name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _bound(name):
    mesh = _MESH.get()
    if mesh is None:
        raise ValueError(
            f"mesh axis {name!r} is not bound: call the collective inside "
            "`with repro_torch.dist.use_mesh(mesh):` for a DeviceMesh with "
            f"a dimension named {name!r} (or pass mesh=)")
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"mesh axis {name!r} is not a dimension of the bound mesh "
            f"{tuple(mesh.mesh_dim_names or ())}")
    return mesh


def group(name):
    """The process group of one bound axis."""
    return _bound(name).get_group(name)


def axis_size(axis) -> int:
    """Size of a bound axis (the product for a tuple of names)."""
    size = 1
    for name in axis_names(axis):
        size *= mesh_axis_sizes(_bound(name))[name]
    return size


def axis_index(axis) -> int:
    """This rank's coordinate along a bound axis (mesh-lexicographic for a
    tuple of names, the first name outermost)."""
    idx = 0
    for name in axis_names(axis):
        mesh = _bound(name)
        idx = idx * mesh_axis_sizes(mesh)[name] + mesh.get_local_rank(name)
    return idx


def local_block(x: Pytree, mesh, spec) -> Pytree:
    """The rows of ``x`` that ``PartitionSpec(spec)`` gives this rank: dim 0
    split evenly over the axis (or the product of a tuple of axes, the
    first name outermost), block ``axis_index(spec)``."""
    names = axis_names(spec)
    sizes = mesh_axis_sizes(mesh)
    idx, parts = 0, 1
    for name in names:
        idx = idx * sizes[name] + mesh.get_local_rank(name)
        parts *= sizes[name]

    def block(v):
        n = v.shape[0]
        if n % parts:
            raise ValueError(f"{n} rows do not split into {parts} blocks "
                             f"over {names}")
        per = n // parts
        return v[idx * per:(idx + 1) * per]

    return pytree.tree_map(block, x)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_COUNTS: Dict[str, Dict[str, int]] = {}


def reset_counts() -> None:
    """Set every axis's counters to 0."""
    _COUNTS.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """{axis: {"calls", "bytes", "wire_bytes"}} since the last reset."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def _count(name: str, nbytes: int, wire: float) -> None:
    c = _COUNTS.setdefault(name, {"calls": 0, "bytes": 0, "wire_bytes": 0})
    c["calls"] += 1
    c["bytes"] += int(nbytes)
    c["wire_bytes"] += int(round(wire))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

class Pending:
    """Collectives in flight: ``wait()`` waits for them and returns the
    value (any later stage runs then, synchronously)."""

    def __init__(self, works: Sequence, finish: Callable[[], Any]):
        self._works = [w for w in works if w is not None]
        self._finish = finish

    @classmethod
    def done(cls, value) -> "Pending":
        return cls((), lambda: value)

    @classmethod
    def all(cls, pendings: List["Pending"],
            finish: Callable[..., Any]) -> "Pending":
        """One Pending for several: ``finish`` takes their values."""
        return cls([w for p in pendings for w in p._works],
                   lambda: finish(*[p._finish() for p in pendings]))

    @classmethod
    def tree(cls, pendings: List["Pending"], spec) -> "Pending":
        """One Pending for a pytree of leaf Pendings."""
        return cls.all(pendings,
                       lambda *vals: pytree.tree_unflatten(list(vals), spec))

    def then(self, fn: Callable[[Any], Any]) -> "Pending":
        return Pending(self._works, lambda: fn(self._finish()))

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish()


def _wire(x: torch.Tensor) -> Tuple[torch.Tensor, Callable]:
    """(the tensor as it crosses, how to turn a result back)."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        return x.to(torch.uint8), lambda y: y.to(torch.bool)
    return x, lambda y: y


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


_OPS = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX,
        "min": tdist.ReduceOp.MIN}


def _all_reduce_leaf(x, name, op) -> Pending:
    g = group(name)
    P = axis_size(name)
    y, back = _wire(x)
    y = y.clone()
    _count(name, _nbytes(y), 2.0 * _nbytes(y) * (P - 1) / P)
    work = tdist.all_reduce(y, _OPS[op], group=g, async_op=True)
    return Pending([work], lambda: back(y))


def _all_gather_leaf(x, name, tiled: bool) -> Pending:
    g = group(name)
    P = axis_size(name)
    y, back = _wire(x)
    flat = y.reshape((1,) + tuple(y.shape)) if y.dim() == 0 else y
    out = flat.new_empty((P * flat.shape[0],) + tuple(flat.shape[1:]))
    _count(name, _nbytes(y), float(_nbytes(y)) * (P - 1))
    work = tdist.all_gather_into_tensor(out, flat, group=g, async_op=True)
    shape = ((P * flat.shape[0],) + tuple(flat.shape[1:]) if tiled
             else (P,) + tuple(y.shape))
    return Pending([work], lambda: back(out.reshape(shape)))


def _all_to_all_leaf(x, name) -> Pending:
    g = group(name)
    P = axis_size(name)
    y, back = _wire(x)
    if y.shape[0] % P:
        raise ValueError(f"all_to_all over {name!r}: {y.shape[0]} rows do "
                         f"not split into {P}")
    out = torch.empty_like(y)
    _count(name, _nbytes(y), float(_nbytes(y)) * (P - 1) / P)
    work = tdist.all_to_all_single(out, y, group=g, async_op=True)
    return Pending([work], lambda: back(out))


def _reduce_scatter_leaf(x, name) -> Pending:
    g = group(name)
    P = axis_size(name)
    if x.shape[0] % P:
        raise ValueError(f"psum_scatter over {name!r}: {x.shape[0]} rows "
                         f"do not split into {P}")
    y, back = _wire(x)
    out = y.new_empty((y.shape[0] // P,) + tuple(y.shape[1:]))
    _count(name, _nbytes(y), float(_nbytes(y)) * (P - 1) / P)
    work = tdist.reduce_scatter_tensor(out, y, group=g, async_op=True)
    return Pending([work], lambda: back(out))


def _over_tree(x: Pytree, leaf: Callable[[torch.Tensor], Pending],
               async_op: bool):
    leaves, spec = pytree.tree_flatten(x)
    p = Pending.tree([leaf(v) for v in leaves], spec)
    return p if async_op else p.wait()


def _sequential(x: Pytree, names: Sequence[str],
                one: Callable[[Pytree, str], Pending]) -> Pending:
    """One collective per axis: the first issued now, the rest in wait()."""
    p = one(x, names[0])
    for name in names[1:]:
        p = p.then(lambda y, name=name: one(y, name).wait())
    return p


def _reduce(x, axis, op, async_op):
    def one(v, name):
        return _over_tree(v, lambda t: _all_reduce_leaf(t, name, op), True)
    p = _sequential(x, axis_names(axis), one)
    return p if async_op else p.wait()


def psum(x: Pytree, axis, *, async_op: bool = False):
    """Sum over a bound axis (``jax.lax.psum``)."""
    return _reduce(x, axis, "sum", async_op)


def pmax(x: Pytree, axis, *, async_op: bool = False):
    """Element-wise max over a bound axis (``jax.lax.pmax``)."""
    return _reduce(x, axis, "max", async_op)


def pmin(x: Pytree, axis, *, async_op: bool = False):
    """Element-wise min over a bound axis (``jax.lax.pmin``)."""
    return _reduce(x, axis, "min", async_op)


def all_gather(x: Pytree, axis, *, tiled: bool = False,
               async_op: bool = False):
    """Every rank's value, stacked on a new dim 0 in coordinate order
    (``jax.lax.all_gather(axis=0)``); ``tiled=True`` concatenates along dim
    0 instead (``all_gather_into_tensor``)."""
    names = axis_names(axis)

    def one(v, name):
        return _over_tree(v, lambda t: _all_gather_leaf(t, name, tiled),
                          True)
    # the last name innermost: gather it first
    p = _sequential(x, names[::-1], one)
    if not tiled and len(names) > 1:
        p = p.then(lambda y: pytree.tree_map(
            lambda t: t.reshape((-1,) + tuple(t.shape[len(names):])), y))
    return p if async_op else p.wait()


def psum_scatter(x: Pytree, axis, *, async_op: bool = False):
    """Sum over a bound axis, each rank keeping its block of dim 0
    (``jax.lax.psum_scatter(scatter_dimension=0, tiled=True)``)."""
    def one(v, name):
        return _over_tree(v, lambda t: _reduce_scatter_leaf(t, name), True)
    p = _sequential(x, axis_names(axis), one)
    return p if async_op else p.wait()


def all_to_all(x: Pytree, axis, *, async_op: bool = False):
    """Block j of dim 0 to rank j; block i of the result from rank i
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``), one axis."""
    (name,) = axis_names(axis)
    return _over_tree(x, lambda t: _all_to_all_leaf(t, name), async_op)


__all__ = [
    "Pending", "all_gather", "all_to_all", "axis_index",
    "axis_names", "axis_size", "counts", "current_mesh", "group",
    "local_block", "maybe_mesh", "mesh_axis_sizes", "pmax", "pmin", "psum",
    "psum_scatter", "reset_counts", "use_mesh",
]
