"""Two-level (MaxText-style) logical sharding as explicit per-rank shards:
the port of the JAX package's ``dist/sharding.py``.

Models name the dimensions of their parameters and activations with
*logical* axes (``"batch"``, ``"embed"``, ``"mlp"``, ...); one rule table
maps each logical name to one mesh axis, a tuple of mesh axes, or ``None``
(replicated).  The tables and :func:`spec_for` are the JAX package's,
entry for entry: :func:`spec_for` returns the tuple the reference's
``PartitionSpec`` holds (a mesh axis that does not divide the dimension,
or that an earlier dimension already took, is dropped; trailing ``None``
entries are trimmed).

The JAX package hands the specs to ``jax.jit`` and lets GSPMD place the
blocks.  Here each rank holds its own block of every leaf
(:func:`shard_params`, :func:`block_of`) and the model code calls the
collectives itself (``repro_torch.dist``): a dimension cut over mesh axes ``A`` holds this
rank's block ``axis_index(A)`` of ``size / axis_size(A)`` entries, in
mesh-lexicographic order (the first name outermost), as a
``NamedSharding`` lays the blocks out.  :func:`gather_params` is the
inverse, by ``all_gather``.

:func:`use_rules` opens the scope the model reads: :func:`cut` says which
mesh axes a dimension of a leaf is cut over (none outside a scope, so the
model runs unsharded without a mesh), and :func:`act` checks that an
activation block has the shape its logical names give it and moves no
data.  A mesh is a ``DeviceMesh`` or, for the functions that need no
world (:func:`trim_rules`, :func:`spec_for`, :func:`param_shardings`), a
``{axis name: size}`` mapping.

A leaf may pack equal parts side by side along one dimension (Mamba's
``w_in`` and mLSTM's ``w_up``: x, then the gate z, each ``d_inner``
wide).  Its logical name is then :class:`Packed` (the plain name with a
part count), and a cut of that dimension cuts every part alike: a rank's
block holds its channels' x columns, then the same channels' z columns,
so it lines up with the per-channel leaves (the conv, ``A_log``,
``ln_g``, the state) and the model splits it with no collective.
:func:`spec_for` gives such a dimension a spec entry that equals the plain
one (so specs compare equal to the reference's) and carries the part
count, which :func:`block_of`, :func:`gather_leaf` and
:func:`gather_params` read: they stay inverse to each other, and the
whole leaf (a checkpoint's layout) is the reference's.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from . import axis_index, mesh_axis_sizes

Pytree = Any
Rules = Dict[str, Any]          # logical name -> mesh axis | tuple | None
Spec = Tuple[Any, ...]          # PartitionSpec entries


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

TRAIN_RULES: Rules = {
    # -- data dimensions
    "batch": ("pod", "data"),     # DP across pods (DCN) and within (ICI)
    "seq": None,                  # override seq="model" for sequence parallel
    "kv_seq": None,
    # -- parameter / activation feature dimensions
    "embed": None,                # residual stream replicated over 'model'
    "vocab": "model",
    "mlp": "model",
    "d_inner": "model",           # SSM/xLSTM inner dim (the 'mlp' of those blocks)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "expert": "model",            # expert parallelism shares the 'model' axis
    "q_lora": None,
    "kv_lora": None,
    "d_state": None,
    "layers": None,               # stacked scan (period) dimension
}

# Serving stays within one pod; otherwise the same two-level scheme.
SERVE_RULES: Rules = dict(TRAIN_RULES, batch=("data",))


class Packed(str):
    """The logical name of a dimension that packs ``parts`` equal blocks
    side by side: the plain name to the rule tables and to comparisons."""

    def __new__(cls, name: str, parts: int):
        out = super().__new__(cls, name)
        out.parts = int(parts)
        return out

    def __reduce__(self):
        return Packed, (str(self), self.parts)


class _PackedAxis(str):
    """A spec entry (one mesh axis) of a packed dimension."""

    def __new__(cls, axis: str, parts: int):
        out = super().__new__(cls, axis)
        out.parts = parts
        return out

    def __reduce__(self):
        return _PackedAxis, (str(self), self.parts)


class _PackedAxes(tuple):
    """A spec entry (a tuple of mesh axes) of a packed dimension."""

    def __new__(cls, axes, parts: int):
        out = super().__new__(cls, axes)
        out.parts = parts
        return out

    def __reduce__(self):
        return _PackedAxes, (tuple(self), self.parts)


def parts_of(entry) -> int:
    """How many packed parts a spec entry's dimension holds (1: none)."""
    return getattr(entry, "parts", 1)


def _axes_tuple(rule: Any) -> Tuple[str, ...]:
    """Normalize a rule value (str | tuple | None) to a tuple of mesh axes."""
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (str(rule),)
    return tuple(str(a) for a in rule)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mapping; {} for anything
    else (an object without named dimensions)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if getattr(mesh, "mesh_dim_names", None):
        return mesh_axis_sizes(mesh)
    return {}


def trim_rules(rules: Rules, mesh) -> Rules:
    """Drop mesh axes the current mesh doesn't have (e.g. 'pod' on 1 pod)."""
    sizes = mesh_sizes(mesh)
    out = {}
    for k, v in rules.items():
        axes = tuple(a for a in _axes_tuple(v) if a in sizes)
        out[k] = axes if len(axes) > 1 else (axes[0] if axes else None)
    return out


# ---------------------------------------------------------------------------
# logical names -> spec
# ---------------------------------------------------------------------------

def spec_for(names: Sequence[Optional[str]], rules: Rules, mesh, *,
             shape: Optional[Sequence[int]] = None) -> Spec:
    """The spec of one tensor's logical names under a rule table: the
    entries of the JAX package's ``PartitionSpec``, as a tuple.

    Per dimension, mesh axes are kept left-to-right subject to:
      * the axis exists in ``mesh``;
      * no earlier dimension already used it (first logical dimension
        wins);
      * if ``shape`` is given, the kept axes' product divides the dimension.

    ``names`` may be shorter than the tensor rank (unnamed trailing
    dimensions are replicated).  A :class:`Packed` name's parts are cut
    alike: the kept axes must divide one part, and the entry carries the
    part count.
    """
    names = tuple(names)
    sizes = mesh_sizes(mesh)
    if shape is not None:
        assert len(names) <= len(shape), (names, shape)
    used: set = set()
    entries: List[Any] = []
    for i, name in enumerate(names):
        kept, prod = [], 1
        parts = getattr(name, "parts", 1)
        for a in _axes_tuple(rules.get(name)) if name is not None else ():
            if a not in sizes or a in used:
                continue
            if shape is not None and (shape[i] % parts or
                                      (shape[i] // parts) %
                                      (prod * sizes[a]) != 0):
                continue
            kept.append(a)
            used.add(a)
            prod *= sizes[a]
        entry = tuple(kept) if len(kept) > 1 else (kept[0] if kept else None)
        if entry is not None and parts > 1:
            entry = _PackedAxes(entry, parts) if len(kept) > 1 else \
                _PackedAxis(entry, parts)
        entries.append(entry)
    while entries and entries[-1] is None:   # trailing Nones are noise
        entries.pop()
    return tuple(entries)


def block_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes_tuple(entry):
            out[d] //= sizes[a]
    return tuple(out)


def _walk(fn: Callable, tree, *others):
    """``fn`` over the leaves of a params-like tree (dicts, lists and tuples
    of leaves), zipped with trees of the same structure (a spec tree among
    them: its tuples are leaves, so it never comes first)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def param_shardings(shapes: Pytree, axes: Pytree, mesh,
                    rules: Rules) -> Pytree:
    """The spec of every leaf of a parameter tree: ``shapes`` (tensors,
    e.g. ``models.param_shapes(cfg)`` on the meta device) and
    ``axes`` (``models.param_axes(cfg)``: tuple-of-names leaves) have the
    same structure; the JAX package's returns ``NamedSharding`` leaves."""
    return _walk(lambda s, ax: spec_for(tuple(ax), rules, mesh,
                                        shape=tuple(s.shape)), shapes, axes)


# ---------------------------------------------------------------------------
# per-rank blocks
# ---------------------------------------------------------------------------

def _coords(mesh, coords: Optional[Dict[str, int]]) -> Dict[str, int]:
    if coords is not None:
        return dict(coords)
    if not getattr(mesh, "mesh_dim_names", None):
        raise ValueError("a {axis: size} mesh names no rank: pass coords=")
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def _block_index(entry, sizes, coords) -> Tuple[int, int]:
    """(this rank's block, number of blocks) along one spec entry."""
    idx, parts = 0, 1
    for a in _axes_tuple(entry):
        idx = idx * sizes[a] + coords[a]
        parts *= sizes[a]
    return idx, parts


def block_of(x: torch.Tensor, spec: Spec, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a copy of its own when a
    dimension is cut, so the full tensor can be freed: a narrowed view
    would keep the whole storage); ``coords`` ({axis: index}) stands for
    the rank on a mapping mesh.  A packed dimension gives the rank its
    block of every part, the parts in order."""
    sizes, coords = mesh_sizes(mesh), _coords(mesh, coords)
    out = x
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, blocks = _block_index(entry, sizes, coords)
        k = parts_of(entry)
        part = x.shape[d] // k
        n = part // blocks
        out = torch.cat([out.narrow(d, j * part + idx * n, n)
                         for j in range(k)], d) if k > 1 else \
            out.narrow(d, idx * n, n)
    return out.clone(memory_format=torch.contiguous_format) \
        if out is not x else x


def shard_params(params: Pytree, axes: Pytree, mesh, rules: Rules, *,
                 coords: Optional[Dict[str, int]] = None) -> Pytree:
    """This rank's block of every leaf of ``params`` (the global tensors)
    under the rule table, per :func:`spec_for` of the leaf's logical
    ``axes`` and its shape."""
    rules = trim_rules(rules, mesh)
    return _walk(lambda t, ax: block_of(
        t, spec_for(tuple(ax), rules, mesh, shape=tuple(t.shape)), mesh,
        coords), params, axes)


def gather_leaf(block: torch.Tensor, spec: Spec, mesh=None) -> torch.Tensor:
    """The whole leaf from this rank's ``block`` under ``spec``: one
    ``all_gather`` per cut dimension, inside ``mesh``'s scope (None: the
    bound mesh), a collective every rank calls."""
    from . import all_gather, maybe_mesh
    out = block
    with maybe_mesh(mesh):
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            k = parts_of(entry)
            names = _axes_tuple(entry)
            if k > 1:               # each part's blocks, then the parts
                out = all_gather(out.unflatten(d, (k, -1)).movedim(d + 1, 0),
                                 names, tiled=True).movedim(0, d + 1)
                out = out.flatten(d, d + 1)
            else:
                out = all_gather(out.movedim(d, 0), names,
                                 tiled=True).movedim(0, d)
    return out.contiguous()


def _assemble_leaf(blocks: List[torch.Tensor], spec: Spec, mesh,
                   shape: Tuple[int, ...]) -> torch.Tensor:
    sizes = mesh_sizes(mesh)
    names = list(sizes)
    out = blocks[0].new_empty(shape)
    for r, block in enumerate(blocks):
        coords, rest = {}, r
        for n in reversed(names):             # row-major rank order
            coords[n] = rest % sizes[n]
            rest //= sizes[n]
        view, shift = out, 0
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            idx, nb = _block_index(entry, sizes, coords)
            k, dd = parts_of(entry), d + shift
            if k > 1:              # the block of every part: one more dim
                view = view.unflatten(dd, (k, -1))
                block = block.unflatten(dd, (k, -1))
                shift, dd = shift + 1, dd + 1
            n = view.shape[dd] // nb
            view = view.narrow(dd, idx * n, n)
        if r and _is_copy(spec, sizes, coords) and \
                not torch.equal(view, block):
            raise ValueError(f"rank {r}'s replicated block differs")
        view.copy_(block)
    return out


def _is_copy(spec: Spec, sizes, coords) -> bool:
    """True when a rank holds a copy of a block another rank also holds:
    some mesh axis cuts no dimension and the rank is not at its 0."""
    cut = {a for e in spec for a in _axes_tuple(e)}
    return any(coords[a] for a in sizes if a not in cut)


def gather_params(local: Pytree, axes: Pytree, mesh, rules: Rules,
                  shapes: Pytree) -> Pytree:
    """The inverse of :func:`shard_params`: the global leaves (``shapes``:
    their shapes, e.g. ``models.param_shapes(cfg)``).  On a DeviceMesh each
    rank passes its blocks and every rank gets the whole tree (one
    ``all_gather`` per cut dimension, inside the mesh's scope).  On a
    mapping mesh ``local`` is the list of every rank's blocks in row-major
    rank order (a simulated world), and replicated copies must agree."""
    rules = trim_rules(rules, mesh)
    specs = param_shardings(shapes, axes, mesh, rules)
    if not getattr(mesh, "mesh_dim_names", None):
        return _walk(lambda s, spec, *blocks: _assemble_leaf(
            list(blocks), spec, mesh, tuple(s.shape)), shapes, specs,
            *local)
    from . import use_mesh
    with use_mesh(mesh):
        return _walk(lambda b, spec: gather_leaf(b, spec), local, specs)


# ---------------------------------------------------------------------------
# the scope the model reads
# ---------------------------------------------------------------------------

# The active (mesh, rules) scope.  Models call cut() / act()
# unconditionally; outside a use_rules() scope nothing is cut, so model
# code never needs a mesh to run.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_scope", default=None)


@contextlib.contextmanager
def use_rules(mesh, rules: Rules):
    """Activate (mesh, rules) for :func:`cut` and :func:`act`; a
    DeviceMesh is also bound for the collectives (``dist.use_mesh``)."""
    from . import maybe_mesh
    token = _ACTIVE.set((mesh, trim_rules(rules, mesh)))
    try:
        with maybe_mesh(mesh if getattr(mesh, "mesh_dim_names", None)
                        else None):
            yield
    finally:
        _ACTIVE.reset(token)


def current_rules() -> Optional[Tuple[Any, Rules]]:
    """The active (mesh, rules), or None outside any use_rules scope."""
    return _ACTIVE.get()


def capture() -> Tuple[Any, Any]:
    """The open scope (the active rules and the bound mesh), for code that
    runs later and maybe on another thread (a checkpointed layer's
    recompute, an autograd backward), where the context is not seen."""
    from . import current_mesh
    return _ACTIVE.get(), current_mesh()


@contextlib.contextmanager
def use_scope(captured: Tuple[Any, Any]):
    """Reopen a :func:`capture`d scope."""
    from . import maybe_mesh
    active, mesh = captured
    token = _ACTIVE.set(active)
    try:
        with maybe_mesh(mesh):
            yield
    finally:
        _ACTIVE.reset(token)


def cut(names: Sequence[Optional[str]], shape: Sequence[int],
        dim: int) -> Tuple[str, ...]:
    """The mesh axes dimension ``dim`` of a tensor with logical ``names``
    and global ``shape`` is cut over in the active scope; () outside one."""
    scope = _ACTIVE.get()
    if scope is None:
        return ()
    mesh, rules = scope
    spec = spec_for(tuple(names), rules, mesh, shape=tuple(shape))
    return _axes_tuple(spec[dim]) if dim < len(spec) else ()


def block_start(axes: Tuple[str, ...], size: int) -> int:
    """The first global index of this rank's block of a ``size``-long
    dimension cut over ``axes`` (0 when nothing is cut)."""
    if not axes:
        return 0
    from . import axis_size
    return axis_index(axes) * (size // axis_size(axes))


def local_shape(names: Sequence[Optional[str]],
                shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of this rank's block of a ``shape`` tensor with logical
    ``names`` in the active scope (``shape`` outside one)."""
    scope = _ACTIVE.get()
    if scope is None:
        return tuple(shape)
    mesh, rules = scope
    return block_shape(shape, spec_for(tuple(names), rules, mesh,
                                       shape=tuple(shape)), mesh)


def reblock(x: torch.Tensor, dim: int, have: Tuple[str, ...],
            want: Tuple[str, ...]) -> torch.Tensor:
    """``x``, this rank's block along ``dim`` of a dimension cut over the
    mesh axes ``have`` (() when whole), as the block ``want`` gives this
    rank: ``x`` itself when the two agree, else gathered over
    ``have`` and cut to ``want``'s block.  Differentiable, each step the
    transpose of the other: the gather's backward keeps this rank's block
    of the cotangent, the cut's gathers the blocks' cotangents."""
    have, want = tuple(have), tuple(want)
    if have == want:
        return x
    from . import all_gather, take_block
    if have:
        x = all_gather(x.movedim(dim, 0), have, tiled=True).movedim(0, dim)
    if want:
        x = take_block(x, dim, want)
    return x


def act(x: torch.Tensor, names: Sequence[Optional[str]], *,
        shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Check an activation block against its logical names (a no-op when
    no rules are active): ``x`` must have the shape of this rank's block of
    a ``shape`` tensor (default ``x.shape``: nothing cut).  Moves no data;
    ``names`` must match ``x``'s rank."""
    scope = _ACTIVE.get()
    if scope is None:
        return x
    mesh, rules = scope
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if len(names) != x.dim():
        raise ValueError(f"act: {len(names)} names for a {x.dim()}-d tensor")
    want = block_shape(shape, spec_for(tuple(names), rules, mesh,
                                       shape=shape), mesh)
    if tuple(x.shape) != want:
        raise ValueError(f"act: a block of {tuple(x.shape)} where "
                         f"{tuple(names)} of {shape} gives {want}")
    return x


__all__ = [
    "SERVE_RULES", "TRAIN_RULES", "act", "block_shape", "block_start",
    "block_of", "capture", "current_rules", "cut", "gather_leaf",
    "gather_params", "local_shape", "mesh_sizes", "Packed",
    "param_shardings", "parts_of", "reblock", "shard_params", "spec_for",
    "trim_rules", "use_rules", "use_scope",
]
