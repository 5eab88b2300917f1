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
no tensor is moved to another device, but for :func:`ppermute` on gloo,
whose send / recv take host memory only.  ``bool`` tensors cross as
``uint8`` (the JAX package's sketch bitmaps are uint8).

Every collective adds to the counters of its axis (:func:`counts`): calls,
payload bytes (this rank's input) and per-device wire bytes (ring
all-reduce 2(P-1)/P x bytes, all-gather (P-1) x bytes, reduce-scatter and
all-to-all (P-1)/P x bytes, ``ppermute`` the bytes it sends), the
quantities the planner's byte model predicts.

A training forward differentiates through them.  :func:`psum`,
:func:`all_gather` and :func:`all_to_all`, called synchronously on tensors
that require grad with grad mode on, are ``torch.autograd.Function``s whose
backward is the transpose under the invariant of the model's cut products:
a value replicated over the axis has the same cotangent on every rank.  So
``psum`` of partials into a replicated value passes its cotangent through,
``all_gather`` hands back this rank's slice (not a reduce-scatter, which
would count it P times), and ``all_to_all`` runs the inverse
``all_to_all``.  :func:`enter` marks a replicated value entering a cut
computation: the identity forward, the ``psum`` of the rank's partial
cotangents backward.  :func:`take_block` cuts this rank's block out of a
replicated value: its backward gathers the blocks' cotangents, the
transpose of a slice.  Each captures the bound mesh in its forward and
rebinds it in the backward, which autograd may run on a thread of its own
that sees no scope.
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


# ---------------------------------------------------------------------------
# autograd: the transposes a training backward runs
# ---------------------------------------------------------------------------

def _needs_grad(x: Pytree) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in pytree.tree_leaves(x))


def _per_leaf(fn: Callable, x: Pytree):
    """``fn`` on the leaves that require grad; the plain collective (grad
    mode off) on the rest."""
    return pytree.tree_map(lambda t: fn(t) if t.requires_grad else
                           _no_grad(fn, t), x)


def _no_grad(fn, t):
    with torch.no_grad():
        return fn(t)


class _Psum(torch.autograd.Function):
    """psum of partials into a replicated value; backward: the identity."""

    @staticmethod
    def forward(ctx, x, axis):
        return _reduce(x, axis, "sum", False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """A replicated value entering a cut computation; backward: the psum of
    every rank's partial cotangent."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.mesh = axis, _bound(axis_names(axis)[0])
        for name in axis_names(axis):
            _bound(name)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _reduce(g.contiguous(), ctx.axis, "sum", False), None


class _AllGather(torch.autograd.Function):
    """all_gather into a replicated value; backward: this rank's block."""

    @staticmethod
    def forward(ctx, x, axis, tiled):
        ctx.idx, ctx.shape, ctx.tiled = axis_index(axis), x.shape, tiled
        return _all_gather(x, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        if not ctx.tiled:
            return g[ctx.idx], None, None
        n = ctx.shape[0] if len(ctx.shape) else 1
        return g.narrow(0, ctx.idx * n, n).reshape(ctx.shape), None, None


class _AllToAll(torch.autograd.Function):
    """all_to_all; backward: the inverse all_to_all (the same exchange)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.mesh = axis, _bound(axis)
        return _all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return _all_to_all(g.contiguous(), ctx.axis), None


class _TakeBlock(torch.autograd.Function):
    """This rank's block of a replicated value; backward: every rank's
    block of the cotangent, gathered."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, _bound(axis_names(axis)[0])
        return _block(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            whole = _all_gather(g.movedim(ctx.dim, 0).contiguous(), ctx.axis,
                                True)
        return whole.movedim(0, ctx.dim), None, None


def _block(x, dim, axis):
    n = x.shape[dim] // axis_size(axis)
    return x.narrow(dim, axis_index(axis) * n, n).contiguous()


def take_block(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """This rank's block (``axis_index``-th of ``axis_size`` equal blocks)
    of ``x`` along ``dim``, ``x`` replicated over the bound axis.
    Differentiable under grad: the backward gathers every rank's block of
    the cotangent, so ``x``'s cotangent is whole on every rank."""
    if _needs_grad(x):
        return _TakeBlock.apply(x, dim, axis)
    return _block(x, dim, axis)


def enter(x: Pytree, axis):
    """``x`` (replicated over a bound axis) as the input of a computation
    cut over it: the identity forward; the backward sums the ranks'
    partial cotangents over the axis, so the cotangent of ``x`` is the
    same on every rank.  Without grad, ``x`` itself."""
    if not axis_names(axis) or not _needs_grad(x):
        return x
    return pytree.tree_map(lambda t: _Enter.apply(t, axis)
                           if t.requires_grad else t, x)


def psum(x: Pytree, axis, *, async_op: bool = False):
    """Sum over a bound axis (``jax.lax.psum``).  Differentiable (the
    identity backward: the sum is a replicated value) when called
    synchronously on tensors that require grad."""
    if not async_op and _needs_grad(x):
        return _per_leaf(lambda t: _Psum.apply(t, axis), x)
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
    0 instead (``all_gather_into_tensor``).  Differentiable (backward: this
    rank's block of the cotangent) when called synchronously on tensors
    that require grad."""
    if not async_op and _needs_grad(x):
        return _per_leaf(lambda t: _AllGather.apply(t, axis, tiled), x)
    return _all_gather(x, axis, tiled, async_op)


def _all_gather(x: Pytree, axis, tiled: bool, async_op: bool = False):
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


def _ppermute_leaf(x, name, perm) -> Pending:
    g = group(name)
    me = axis_index(name)
    y, back = _wire(x)
    # gloo's send / recv take host memory only (every other gloo call takes
    # the card's): the one place a tensor crosses through the host
    host = tdist.get_backend(g) == "gloo" and y.device.type != "cpu"
    send = y.to("cpu") if host else y.clone()
    out = torch.zeros_like(send)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(tdist.P2POp(tdist.isend, send,
                                   tdist.get_global_rank(g, dst), g))
        if dst == me:
            ops.append(tdist.P2POp(tdist.irecv, out,
                                   tdist.get_global_rank(g, src), g))
    sends = sum(1 for s, _ in perm if s == me)
    _count(name, _nbytes(y) * sends, float(_nbytes(y)) * sends)
    works = tdist.batch_isend_irecv(ops) if ops else []
    return Pending(works, lambda: back(out.to(y.device) if host else out))


def ppermute(x: Pytree, axis, perm: Sequence[Tuple[int, int]], *,
             async_op: bool = False):
    """Send this rank's value to the coordinates ``perm`` maps it to
    (``(source, destination)`` pairs of coordinates along one bound axis)
    and return what arrives (``jax.lax.ppermute``): zeros where no pair
    names this rank as a destination.  One ``batch_isend_irecv`` within the
    axis's group; counted like the other collectives (its payload and wire
    bytes are what this rank sends)."""
    (name,) = axis_names(axis)
    perm = [(int(s), int(d)) for s, d in perm]
    for pos in (0, 1):
        ends = [p[pos] for p in perm]
        if len(set(ends)) != len(ends):
            raise ValueError(f"ppermute over {name!r}: {perm} repeats a "
                             f"{('source', 'destination')[pos]}")
    return _over_tree(x, lambda t: _ppermute_leaf(t, name, perm), async_op)


def all_to_all(x: Pytree, axis, *, async_op: bool = False):
    """Block j of dim 0 to rank j; block i of the result from rank i
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``), one axis.
    Differentiable (backward: the same exchange of the cotangent) when
    called synchronously on tensors that require grad."""
    if not async_op and _needs_grad(x):
        return _per_leaf(lambda t: _AllToAll.apply(t, axis), x)
    return _all_to_all(x, axis, async_op)


def _all_to_all(x: Pytree, axis, async_op: bool = False):
    (name,) = axis_names(axis)
    return _over_tree(x, lambda t: _all_to_all_leaf(t, name), async_op)


__all__ = [
    "Pending", "all_gather", "all_to_all", "axis_index",
    "axis_names", "axis_size", "counts", "current_mesh", "enter", "group",
    "local_block", "maybe_mesh", "mesh_axis_sizes", "pmax", "pmin",
    "ppermute", "psum",
    "psum_scatter", "reset_counts", "take_block", "use_mesh",
]
