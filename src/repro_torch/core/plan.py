"""The monoid execution planner: ONE lowering path for every fold.

The port of ``repro/core/plan.py``.  :func:`execute_fold` lowers a flat or
keyed fold to a local tier:

  kernel      the registered lowering onto the hand-written CUDA segment-fold
              kernel (``kernels/segment_fold.py``) when the monoid has one,
  segment     ``index_add_`` / ``scatter_reduce_`` for the monoids PyTorch
              reduces natively by key,
  scan        the serial in-mapper fold (Algorithm 4) that works for ANY
              monoid, keyed or flat,
  tree        the log-depth tree fold (Algorithm 3's combiner), flat only.

:func:`plan_fold` is the cost model behind it: ``layout='auto'`` is an argmin
over predicted microseconds from :mod:`repro_torch.core.calibration`, after a
feasibility filter.  The kernel tier is feasible when the values live on a
CUDA device, the monoid has a registered lowering, every leaf has a dtype the
kernel takes, and the float32 accumulator is exact for the inputs.  Forcing
``layout='kernel'`` on CPU tensors runs the kernel's plain version.
Planning works on concrete tensors or ``meta``-device tensors alike.

followed, with ``mesh_axes=``, by the collective tier: the combine across
the named axes of the mesh bound by ``repro_torch.dist.use_mesh`` (or passed
as ``mesh=``), ICI axes before the DCN ``pod`` axis, each axis's shuffle
(reduce-scatter + all-gather or allreduce) chosen by the link model
(``dist/collectives.py``).  ``lossy=`` crosses DCN compressed with error
feedback; ``layout='async'`` pipelines each microbatch's DCN crossing
against the next one's compute.  ``plan_fold`` prices both shapes, and
``pre_combine=False`` the un-combined pair shuffle of Algorithm 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from ..dist import maybe_mesh, mesh_axis_sizes
from .aggregation import _PMAX_LIKE, _PMIN_LIKE, _PSUM_LIKE, tree_bytes
from .calibration import Calibration, get_calibration, pipeline_exposed_us
from .monoid import (KernelLowering, Monoid, Pytree, register_kernel_lowering,
                     scan_fold, tree_fold)

LAYOUTS = ("auto", "kernel", "segment", "scan", "tree", "async")

# layout spelling (user-facing) -> calibration tier kind (TierPlan.kind).
# 'async' is absent on purpose: it is a whole-plan shape (fused local +
# pipelined crossings), not a local tier the per-record model prices.
_LAYOUT_TIER_KIND = {"kernel": "kernel", "segment": "segment_ops",
                     "scan": "scan", "tree": "tree"}

# TierPlan.kind values that are collective (shuffle) stages, not local folds
_COLLECTIVE_KINDS = ("gather_pairs", "allreduce", "reduce_scatter")

# monoids PyTorch reduces natively by key (tier 2): scatter reduction name
_SEGMENT_OPS = {
    "sum": "sum",
    "count": "sum",
    "mean": "sum",          # applied leaf-wise to (sum, count)
    "max": "amax",
    "min": "amin",
    "bitwise_or": "amax",   # 0/1 bitmaps: OR == max
}
_SEGMENT_OP_NAMES = {"sum": "index_add_", "amax": "scatter_reduce_[amax]",
                     "amin": "scatter_reduce_[amin]"}

# ---------------------------------------------------------------------------
# kernel lowerings for the zoo
# ---------------------------------------------------------------------------

def _semiring_lowering(semiring: str) -> KernelLowering:
    """Leaf-wise lowering onto the semiring kernel: each leaf (N, ...) is
    flattened to (N, D), folded by key, and reshaped to (S, ...).  Integer
    leaves round-trip to their dtype."""

    def lower(values: Pytree, seg_ids: torch.Tensor, num_segments: int, *,
              valid_mask: Optional[torch.Tensor] = None) -> Pytree:
        from ..kernels.segment_fold import segment_fold

        def per_leaf(v):
            flat = v.reshape(v.shape[0], -1)
            out = segment_fold(flat, seg_ids, num_segments, semiring=semiring,
                               valid_mask=valid_mask)
            return out.reshape((num_segments,) + tuple(v.shape[1:]))

        return pytree.tree_map(per_leaf, values)

    return KernelLowering(semiring=semiring, fn=lower)


def _mean_pair_lowering() -> KernelLowering:
    """Mean's (sum, count) pair in ONE launch: the count leaf rides as one
    more column of the sums (the paper's running example); pytree-valued
    sums fall back to leaf-wise."""
    leafwise = _semiring_lowering("sum").fn

    def lower(values: Pytree, seg_ids: torch.Tensor, num_segments: int, *,
              valid_mask: Optional[torch.Tensor] = None) -> Pytree:
        from ..kernels.segment_fold import segment_fold

        s, c = values
        s_leaves, treedef = pytree.tree_flatten(s)
        if len(s_leaves) != 1 or c.dim() != 1:
            return leafwise(values, seg_ids, num_segments,
                            valid_mask=valid_mask)
        (sv,) = s_leaves
        flat = torch.cat([sv.reshape(sv.shape[0], -1).to(torch.float32),
                          c.reshape(-1, 1).to(torch.float32)], dim=1)
        out = segment_fold(flat, seg_ids, num_segments, valid_mask=valid_mask)
        sums = out[:, :-1].reshape((num_segments,) + tuple(sv.shape[1:]))
        if not sv.dtype.is_floating_point:
            sums = sums.to(sv.dtype)
        counts = out[:, -1]
        if not c.dtype.is_floating_point:
            counts = counts.to(c.dtype)
        return (pytree.tree_unflatten([sums], treedef), counts)

    return KernelLowering(semiring="sum", fn=lower)


for _name in ("sum", "count"):
    register_kernel_lowering(_name, _semiring_lowering("sum"))
register_kernel_lowering("mean", _mean_pair_lowering())
register_kernel_lowering("max", _semiring_lowering("max"))
register_kernel_lowering("bitwise_or", _semiring_lowering("max"))
register_kernel_lowering("min", _semiring_lowering("min"))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierPlan:
    """One stage of a lowered fold.

    kind: 'kernel' | 'segment_ops' | 'scan' | 'tree' | 'gather_pairs' |
          'allreduce' | 'reduce_scatter'.
    wire_bytes: predicted bytes this stage puts on the wire, summed over the
      participants of one reduction group (0 for on-device stages).
    predicted_us: modeled wall time under the active calibration (0 when
      the model has nothing to say, e.g. an unknown axis size).
    candidate_us: the (candidate, predicted_us) table the planner chose
      from — layouts for the local tier, shuffle algorithms for a
      collective tier.
    """

    kind: str
    detail: str
    out_bytes: int
    wire_bytes: int = 0
    predicted_us: float = 0.0
    candidate_us: Tuple[Tuple[str, float], ...] = ()


@dataclasses.dataclass(frozen=True)
class Plan:
    """A lowered fold: the local tier and any collective tiers.
    ``num_valid`` is the count of rows a concrete ``valid_mask`` keeps
    (None without a mask or for a ``meta`` mask); only valid rows count in
    the shuffle byte model."""

    monoid: Monoid
    tiers: Tuple[TierPlan, ...]
    num_records: int
    num_segments: Optional[int]
    value_bytes: int          # bytes of ONE lifted monoid value
    out_bytes: int            # bytes of the final local result (table/value)
    num_valid: Optional[int] = None
    # -- overlap / compression annotations (flat mesh folds) ----------------
    lossy: Optional[str] = None        # LossySpec.describe() when annotated
    overlap_modeled: float = 0.0       # modeled hidden fraction of DCN time
    dense_wire_bytes: int = 0          # per-device DCN bytes of a dense sync
                                       #   crossing (0: no DCN axis planned)
    lossy_wire_bytes: int = 0          # per-device DCN bytes actually planned
                                       #   (== dense_wire_bytes when not lossy)
    plan_candidate_us: Tuple[Tuple[str, float], ...] = ()
                                       # whole-plan (sync vs async) argmin
                                       #   table when both shapes were priced

    @property
    def local_tier(self) -> TierPlan:
        return next(t for t in self.tiers if t.kind not in _COLLECTIVE_KINDS)

    @property
    def collective_wire_bytes(self) -> int:
        return sum(t.wire_bytes for t in self.tiers)

    @property
    def predicted_us(self) -> float:
        return float(sum(t.predicted_us for t in self.tiers))

    @property
    def candidate_us(self) -> dict:
        """Predicted microseconds per feasible local layout — the table
        ``layout='auto'`` argmins over."""
        return dict(self.local_tier.candidate_us)

    @property
    def shuffle_algorithm(self) -> Optional[str]:
        """'reduce_scatter' | 'allreduce' for the first collective stage
        (None when the plan has no collective stage) — what
        ``MapReduceJob.run_sharded`` executes."""
        for t in self.tiers:
            if t.kind in ("allreduce", "reduce_scatter"):
                return t.kind
        return None

    @property
    def shuffle_candidate_us(self) -> dict:
        """Predicted microseconds per shuffle algorithm on the first
        collective axis (empty when there is none or its size is unknown)."""
        for t in self.tiers:
            if t.kind in ("allreduce", "reduce_scatter"):
                return dict(t.candidate_us)
        return {}

    def describe(self) -> str:
        parts = []
        for t in self.tiers:
            us = f" ~{t.predicted_us:.1f}us" if t.predicted_us > 0 else ""
            parts.append(f"{t.kind}[{t.detail}{us}]")
        s = " -> ".join(parts)
        if self.lossy:
            s += (f" [lossy={self.lossy}: dcn {self.lossy_wire_bytes}B"
                  f" vs {self.dense_wire_bytes}B dense]")
        if self.overlap_modeled > 0.0:
            s += f" [overlap modeled {self.overlap_modeled:.0%}]"
        return s


def collective_algorithm(m: Monoid) -> str:
    """'ring' when the monoid's cross-device combine is a sum/max/min-family
    reduction, 'gather' for the generic fallback."""
    name = m.name
    if (name in _PSUM_LIKE or name in _PMAX_LIKE or name in _PMIN_LIKE
            or name in ("mean", "logsumexp", "attn_state")
            or name.startswith("hll") or name.startswith("cms")):
        return "ring"
    return "gather"


def collective_wire_bytes(nbytes: int, axis_size: int, algorithm: str) -> int:
    """Total wire bytes across one reduction group of ``axis_size`` devices."""
    if axis_size <= 1:
        return 0
    if algorithm in ("ring", "reduce_scatter"):
        # ring allreduce = reduce-scatter + all-gather: 2(P-1)/P x nbytes each
        return int(2 * nbytes * (axis_size - 1))
    if algorithm == "gather":     # every device replicates its value P-1 times
        return int(nbytes * (axis_size - 1) * axis_size)
    raise ValueError(algorithm)


def _per_device_shuffle_bytes(nbytes: int, axis_size: int, shuffle_kind: str,
                              allreduce_algo: str) -> float:
    """Wire bytes ONE device moves for a table shuffle — what the link model
    prices.  reduce_scatter moves 2(P-1)/P x nbytes for any monoid;
    allreduce matches it for the ring family and degrades to a (P-1) x
    nbytes gather for generic monoids."""
    if axis_size <= 1:
        return 0.0
    if shuffle_kind == "reduce_scatter" or allreduce_algo == "ring":
        return 2.0 * nbytes * (axis_size - 1) / axis_size
    return float(nbytes) * (axis_size - 1)


def _split_ici_dcn(mesh_axes: Sequence[Any]) -> Tuple[Tuple, Tuple]:
    # delegate to dist: planning order must match execution order exactly
    from ..dist.collectives import split_axis_names
    return split_axis_names(mesh_axes)


def _link_domain(ax: Any) -> str:
    """'dcn' for axes wired over DCN, 'ici' otherwise."""
    return "dcn" if _split_ici_dcn((ax,))[1] else "ici"


def _plan_collective_tier(calib: Calibration, label: str, ax: Any,
                          P: Optional[int], nbytes: int,
                          num_segments: Optional[int],
                          allreduce_algo: str) -> TierPlan:
    """One collective stage, its shuffle algorithm chosen by predicted cost:
    'reduce_scatter' (keyed tables whose key count divides the axis size)
    or 'allreduce'; a predicted tie prefers reduce_scatter.  An unknown or
    trivial axis size plans a 0-cost allreduce."""
    candidates = ["allreduce"]
    if num_segments is not None and P and P > 1 and num_segments % P == 0:
        candidates.insert(0, "reduce_scatter")   # ties prefer reduce_scatter
    if not P or P <= 1:
        wire = collective_wire_bytes(nbytes, P, allreduce_algo) if P else 0
        return TierPlan("allreduce",
                        f"{label}:{ax} {allreduce_algo}"
                        + ("" if P else " (size unknown)"),
                        nbytes, wire)
    cand_us = tuple(
        (kind, calib.predict_link_us(
            label, _per_device_shuffle_bytes(nbytes, P, kind, allreduce_algo)))
        for kind in candidates)
    costs = dict(cand_us)
    kind = min(candidates, key=costs.get)
    if kind == "reduce_scatter":
        return TierPlan("reduce_scatter",
                        f"{label}:{ax} reduce_scatter+all_gather",
                        nbytes, collective_wire_bytes(nbytes, P, kind),
                        predicted_us=costs[kind], candidate_us=cand_us)
    return TierPlan("allreduce", f"{label}:{ax} {allreduce_algo}",
                    nbytes, collective_wire_bytes(nbytes, P, allreduce_algo),
                    predicted_us=costs[kind], candidate_us=cand_us)


def _plan_lossy_dcn_tier(calib: Calibration, ax: Any, P: Optional[int],
                         comp_bytes: int, dense_bytes: int,
                         spec) -> TierPlan:
    """The DCN crossing of a ``lossy=`` fold: compressed messages gathered
    and combined on-device (concat + scatter-add / dequant-sum — the lossy
    monoid's exact regime), priced at the COMPRESSED bytes."""
    detail = f"dcn:{ax} lossy[{spec.describe()}] {comp_bytes}B/{dense_bytes}B"
    if not P or P <= 1:
        return TierPlan("allreduce", detail + ("" if P else " (size unknown)"),
                        comp_bytes, 0)
    per_dev = float(comp_bytes) * (P - 1)    # gather: each message replicated
    return TierPlan("allreduce", detail, comp_bytes,
                    int(comp_bytes * (P - 1) * P),
                    predicted_us=calib.predict_link_us("dcn", per_dev))


def _plan_async_tier(calib: Calibration, *, n: int, value_bytes: int,
                     out_bytes: int, local_us_total: float,
                     ici: Sequence[Any], dcn: Sequence[Any],
                     sizes: Mapping[Any, int], spec, comp_bytes: int,
                     algo: str) -> Tuple[TierPlan, float, float]:
    """Price the double-buffered shape: n ICI-combined partials, the DCN
    crossing of partial i pipelined against the compute of partial i+1.

    The per-microbatch ICI combines and the compute slot hide nothing (they
    ARE the foreground work); of the n DCN crossings, n-1 are pipelined and
    the epilogue is exposed.  How much of the pipelined time is hidden is
    the DCN link's calibrated ``overlap_frac``.

    Returns (tier, total_us, modeled hidden fraction of DCN time).
    """
    ici_us, ici_wire = 0.0, 0
    for ax in ici:
        P = sizes.get(ax)
        if P and P > 1:
            ici_us += calib.predict_link_us(
                "ici", _per_device_shuffle_bytes(value_bytes, P,
                                                 "allreduce", algo))
            ici_wire += collective_wire_bytes(value_bytes, P, algo)
    cross_us, dcn_wire = 0.0, 0
    for ax in dcn:
        P = sizes.get(ax)
        if P and P > 1:
            if spec is not None:
                cross_us += calib.predict_link_us(
                    "dcn", float(comp_bytes) * (P - 1))
                dcn_wire += comp_bytes * (P - 1) * P
            else:
                cross_us += calib.predict_link_us(
                    "dcn", _per_device_shuffle_bytes(value_bytes, P,
                                                     "allreduce", algo))
                dcn_wire += collective_wire_bytes(value_bytes, P, algo)
    slot_us = local_us_total / n + ici_us
    exposed, hideable = pipeline_exposed_us(
        num_crossings=n, slot_us=slot_us, cross_us=cross_us)
    ofrac = min(max(calib.link_coeff("dcn").overlap_frac, 0.0), 1.0)
    hidden = hideable * ofrac
    total_cross = n * cross_us
    total = local_us_total + n * ici_us + total_cross - hidden
    modeled = hidden / total_cross if total_cross > 0.0 else 0.0
    detail = (f"double-buffered x{n} microbatch crossings"
              + (f" lossy[{spec.describe()}]" if spec is not None else "")
              + f", modeled overlap {modeled:.0%}")
    tier = TierPlan("async", detail, out_bytes,
                    n * (ici_wire + dcn_wire), predicted_us=total)
    return tier, total, modeled


def _leading_dim(values: Pytree) -> int:
    return pytree.tree_leaves(values)[0].shape[0]


def _one_slice(values: Pytree) -> Pytree:
    """One record of ``values`` as ``meta`` tensors (shape/dtype only)."""
    return pytree.tree_map(
        lambda v: torch.empty(tuple(v.shape[1:]), dtype=v.dtype,
                              device="meta"), values)


def _lifted_value_shape(m: Monoid, values: Pytree, lifted: bool,
                        map_fn: Optional[Callable]) -> Pytree:
    """``meta`` pytree of ONE lifted monoid value (no FLOPs spent)."""
    one = _one_slice(values)
    if map_fn is not None:
        return m.lift(map_fn(one))
    if not lifted:
        return m.lift(one)
    return one


def _static_valid_count(valid_mask) -> Optional[int]:
    """Number of True rows for a concrete mask; None for a ``meta`` one."""
    if valid_mask is None or valid_mask.device.type == "meta":
        return None
    return int(valid_mask.to(torch.bool).sum())


def _check_valid_mask(valid_mask, n: int) -> None:
    if tuple(valid_mask.shape) != (n,):
        raise ValueError(
            f"valid_mask must be one flag per record, shape ({n},); got "
            f"shape {tuple(valid_mask.shape)}")


def _on_cuda(values: Pytree) -> bool:
    leaves = pytree.tree_leaves(values)
    return bool(leaves) and all(isinstance(v, torch.Tensor)
                                and v.device.type == "cuda" for v in leaves)


def _kernel_infeasible_reason(m: Monoid, value_shape: Pytree) -> Optional[str]:
    """Why the kernel tier cannot lower this fold — None when it can.  The
    text names the offending leaf (tree path) and its dtype."""
    from ..kernels.segment_fold import KERNEL_DTYPES

    if m.kernel_lowering() is None:
        return (f"monoid {m.name!r} has no registered CUDA kernel lowering "
                "(see register_kernel_lowering)")
    leaves, _ = pytree.tree_flatten_with_path(value_shape)
    for path, leaf in leaves:
        if leaf.dtype not in KERNEL_DTYPES:
            where = pytree.keystr(path) or "<value>"
            return (f"value leaf {where!r} has dtype {leaf.dtype}, which the "
                    "CUDA segment-fold kernel cannot lower (it takes "
                    f"{', '.join(str(d) for d in KERNEL_DTYPES)})")
    return None


def _kernel_exact(value_shape: Pytree, num_records: int) -> bool:
    """Whether the kernel's float32 accumulator is exact for these inputs:
    integer leaves stay on the kernel tier under ``auto`` only when even the
    worst case (every record at the dtype's extreme, all in one key) stays
    below 2**24.  Forcing ``layout='kernel'`` bypasses this."""
    for leaf in pytree.tree_leaves(value_shape):
        if not leaf.dtype.is_floating_point:
            info = torch.iinfo(leaf.dtype)
            extreme = max(abs(int(info.min)), int(info.max))
            if extreme * max(num_records, 1) >= 2 ** 24:
                return False
    return True


def plan_fold(m: Monoid, values: Pytree, *, segment_ids=None,
              num_segments: Optional[int] = None, valid_mask=None,
              mesh_axes: Optional[Sequence[Any]] = None, layout: str = "auto",
              lifted: bool = True, map_fn: Optional[Callable] = None,
              mesh=None, axis_sizes: Optional[Mapping[Any, int]] = None,
              pre_combine: bool = True, lossy=None,
              calibration: Optional[Calibration] = None,
              value_shape: Optional[Pytree] = None) -> Plan:
    """Lower a fold to a :class:`Plan` without executing it.

    ``values`` may be concrete or ``meta``-device tensors — planning costs
    no FLOPs.  ``layout='auto'`` argmins the calibrated time model over the
    FEASIBLE tiers; a forced layout that is infeasible raises here with the
    offending leaf named.  ``valid_mask`` (one bool per record) makes the
    fold ragged; a concrete mask is counted into ``Plan.num_valid``.

    ``mesh_axes`` (with their sizes from ``mesh`` — a DeviceMesh — or
    ``axis_sizes``; an unknown size predicts 0 wire bytes) adds the
    collective stages that combine the local result across those axes, ICI
    axes first, each stage's shuffle algorithm chosen by the link model.
    ``pre_combine=False`` models the paper's Algorithm 1 (no combiner:
    every valid lifted pair crosses the wire, receivers fold) for byte
    accounting.

    ``layout='async'`` plans the double-buffered shape of
    :func:`repro_torch.dist.collectives.async_microbatch_fold` — the DCN
    crossing of record *i*'s ICI-combined partial pipelined against record
    *i+1*'s compute.  It is a flat-fold layout and needs ``mesh_axes=``;
    under ``layout='auto'`` the shape joins the argmin (priced with the
    DCN link's calibrated ``overlap_frac``), a predicted tie going to the
    sync shape.

    ``lossy=`` (a :class:`repro_torch.optim.compress.LossySpec` or its
    string spelling, e.g. ``"topk:0.01"``) annotates a flat additive fold:
    the DCN crossing moves the compressed representation, and the byte and
    time model prices the compressed bytes (``Plan.lossy_wire_bytes`` vs
    ``Plan.dense_wire_bytes``).

    ``value_shape`` is one lifted value's shape when the caller already
    has it; ``map_fn`` is then not run on ``meta`` tensors.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}")
    keyed = segment_ids is not None
    if keyed and num_segments is None:
        raise ValueError(
            "segment_ids= was passed without num_segments=: a keyed fold "
            "returns a static (num_segments, ...) table, so pass the key-"
            "space size as num_segments=")
    spec = None
    if lossy is not None:
        from ..optim.compress import LossySpec  # lazy: optim imports core
        spec = LossySpec.parse(lossy)
        if keyed:
            raise ValueError(
                "lossy= compression applies to flat (gradient) folds; keyed "
                "tables cross the wire dense")
        if m.name != "sum":
            raise ValueError(
                f"lossy= compression needs an additive fold; got monoid "
                f"{m.name!r}")
    if layout == "async":
        if keyed:
            raise ValueError(
                "layout='async' overlaps the DCN crossing of a flat "
                "microbatch fold; keyed folds use kernel/segment/scan")
        if not mesh_axes:
            raise ValueError(
                "layout='async' needs mesh_axes= — without a mesh there is "
                "no crossing to overlap")

    n = _leading_dim(values)
    if valid_mask is not None:
        _check_valid_mask(valid_mask, n)
    num_valid = _static_valid_count(valid_mask)
    n_model = n if num_valid is None else num_valid
    if value_shape is None:
        value_shape = _lifted_value_shape(m, values, lifted, map_fn)
    vbytes = tree_bytes(value_shape)
    out_bytes = (num_segments * vbytes) if keyed else vbytes
    masked = " +mask" if valid_mask is not None else ""

    calib = calibration if calibration is not None else get_calibration()
    leaves = pytree.tree_leaves(value_shape)
    dtype_key = str(leaves[0].dtype).replace("torch.", "") if leaves else "*"

    def local_us(layout_name: str) -> float:
        return calib.predict_local_us(
            _LAYOUT_TIER_KIND[layout_name], monoid=m.name, dtype=dtype_key,
            num_records=n, record_bytes=vbytes)

    if keyed:
        if layout == "tree":
            raise ValueError("layout='tree' is a flat-fold layout; keyed "
                             "folds use kernel/segment/scan")
        kernel_reason = _kernel_infeasible_reason(m, value_shape)
        candidates = []
        # feasibility only: WHICH feasible tier runs is the cost model's call
        if (kernel_reason is None and _kernel_exact(value_shape, n_model)
                and _on_cuda(values)):
            candidates.append("kernel")
        if m.name in _SEGMENT_OPS:
            candidates.append("segment")
        candidates.append("scan")
        shown = candidates + ([layout] if layout not in ("auto", *candidates)
                              else [])
        candidate_us = tuple((c, local_us(c)) for c in shown)
        costs = dict(candidate_us)
        kind = min(candidates, key=costs.get) if layout == "auto" else layout
        if kind == "kernel":
            if kernel_reason is not None:
                raise ValueError(
                    f"layout='kernel' was requested but is infeasible: "
                    f"{kernel_reason}. Use layout='segment' or "
                    "layout='scan', or leave layout='auto' to let the cost "
                    "model pick among feasible tiers.")
            low = m.kernel_lowering()
            where = "cuda" if _on_cuda(values) else "plain version"
            local = TierPlan("kernel",
                             f"segment_fold[{low.semiring}] {where}{masked}",
                             out_bytes, predicted_us=costs["kernel"],
                             candidate_us=candidate_us)
        elif kind == "segment":
            op = _SEGMENT_OPS.get(m.name)
            if op is None:
                raise ValueError(
                    f"layout='segment' was requested but monoid {m.name!r} "
                    "has no PyTorch scatter reduction (index_add_/"
                    "scatter_reduce_); use layout='scan', or leave "
                    "layout='auto' to let the cost model pick among "
                    "feasible tiers.")
            local = TierPlan("segment_ops",
                             f"torch.{_SEGMENT_OP_NAMES[op]}{masked}",
                             out_bytes, predicted_us=costs["segment"],
                             candidate_us=candidate_us)
        else:
            local = TierPlan("scan",
                             f"serial scan (any monoid, Alg 4){masked}",
                             out_bytes, predicted_us=costs["scan"],
                             candidate_us=candidate_us)
    else:
        if layout in ("kernel", "segment"):
            raise ValueError(
                f"layout={layout!r} lowers a KEYED fold but no segment_ids= "
                "were given: pass segment_ids= (one key per record) and "
                "num_segments=, or use layout='tree'/'scan' for a flat fold")
        # with map_fn the point is O(1) live values: auto keeps the fused scan
        candidates = ["scan"] if map_fn is not None else ["tree", "scan"]
        # 'async' fuses an in-mapper scan with pipelined crossings: its
        # local work is the scan tier's, chosen here; the whole-plan shape
        # is decided after the sync collectives are priced below
        eff_layout = "auto" if layout == "async" else layout
        shown = candidates + ([eff_layout]
                              if eff_layout not in ("auto", *candidates)
                              else [])
        candidate_us = tuple((c, local_us(c)) for c in shown)
        costs = dict(candidate_us)
        kind = (min(candidates, key=costs.get) if eff_layout == "auto"
                else eff_layout)
        if kind == "tree":
            local = TierPlan("tree",
                             f"log-depth tree fold (Alg 3 combiner){masked}",
                             out_bytes, predicted_us=costs["tree"],
                             candidate_us=candidate_us)
        else:
            local = TierPlan("scan",
                             f"in-mapper scan (Alg 4, O(1) live){masked}",
                             out_bytes, predicted_us=costs["scan"],
                             candidate_us=candidate_us)

    # -- collective tiers: ICI first, then DCN ------------------------------
    sizes = dict(axis_sizes or {})
    if mesh is not None:
        for ax, sz in mesh_axis_sizes(mesh).items():
            sizes.setdefault(ax, sz)
    algo = collective_algorithm(m)
    mesh_axes = tuple(mesh_axes or ())
    ici, dcn = _split_ici_dcn(mesh_axes)
    comp_bytes = spec.wire_bytes(value_shape) if spec is not None else 0
    if not pre_combine:
        # Algorithm 1: every VALID lifted pair crosses the wire un-combined
        pair_bytes = n_model * vbytes
        wire = sum(collective_wire_bytes(pair_bytes, sizes.get(ax, 1),
                                         "gather") for ax in mesh_axes)
        pred = sum(calib.predict_link_us(_link_domain(ax),
                                         float(pair_bytes) * (sizes[ax] - 1))
                   for ax in mesh_axes if sizes.get(ax) and sizes[ax] > 1)
        tiers = [TierPlan("gather_pairs",
                          "no combiner: all pairs shuffled (Alg 1)",
                          pair_bytes, wire, predicted_us=float(pred)), local]
    else:
        tiers = [local] + [
            _plan_collective_tier(calib, "ici", ax, sizes.get(ax), out_bytes,
                                  num_segments if keyed else None, algo)
            for ax in ici]
        for ax in dcn:
            if spec is not None:
                tiers.append(_plan_lossy_dcn_tier(
                    calib, ax, sizes.get(ax), comp_bytes, out_bytes, spec))
            else:
                tiers.append(_plan_collective_tier(
                    calib, "dcn", ax, sizes.get(ax), out_bytes,
                    num_segments if keyed else None, algo))

    # -- overlap / compression annotations + the sync-vs-async argmin --------
    overlap_modeled = 0.0
    dense_wire = lossy_wire = 0
    plan_cand: Tuple[Tuple[str, float], ...] = ()
    if not keyed and mesh_axes and pre_combine:
        for ax in dcn:
            P = sizes.get(ax)
            if P and P > 1:
                dense = int(_per_device_shuffle_bytes(out_bytes, P,
                                                      "allreduce", algo))
                dense_wire += dense
                lossy_wire += (comp_bytes * (P - 1) if spec is not None
                               else dense)
        if n > 1 and layout in ("auto", "async"):
            async_tier, async_total, modeled = _plan_async_tier(
                calib, n=n, value_bytes=vbytes, out_bytes=out_bytes,
                local_us_total=local.predicted_us, ici=ici, dcn=dcn,
                sizes=sizes, spec=spec, comp_bytes=comp_bytes, algo=algo)
            sync_total = float(sum(t.predicted_us for t in tiers))
            plan_cand = (("sync", sync_total), ("async", async_total))
            # a predicted tie goes to sync: one crossing beats n crossings
            # whenever the model cannot prove the extra n-1 are hidden
            if layout == "async" or async_total < sync_total:
                tiers = [dataclasses.replace(async_tier,
                                             candidate_us=plan_cand)]
                overlap_modeled = modeled
                lossy_wire = (comp_bytes * sum(
                    sizes[ax] - 1 for ax in dcn
                    if sizes.get(ax) and sizes[ax] > 1) * n
                    if spec is not None else dense_wire * n)
                dense_wire *= n
    return Plan(monoid=m, tiers=tuple(tiers), num_records=n,
                num_segments=num_segments, value_bytes=vbytes,
                out_bytes=out_bytes, num_valid=num_valid,
                lossy=spec.describe() if spec is not None else None,
                overlap_modeled=overlap_modeled,
                dense_wire_bytes=dense_wire, lossy_wire_bytes=lossy_wire,
                plan_candidate_us=plan_cand)


# ---------------------------------------------------------------------------
# tier implementations
# ---------------------------------------------------------------------------

def _seg_add_init(m: Monoid, folded: Pytree, init: Optional[Pytree]) -> Pytree:
    if init is None:
        return folded
    return vmap(m.combine)(init, folded)


def _materialize_lifted(m: Monoid, values: Pytree, lifted: bool,
                        map_fn: Optional[Callable]) -> Pytree:
    if map_fn is not None:
        return vmap(lambda x: m.lift(map_fn(x)))(values)
    if not lifted:
        return vmap(m.lift)(values)
    return values


def _identity_rows(m: Monoid, values: Pytree) -> Pytree:
    """The monoid identity shaped like one record of a lifted batch."""
    return m.identity_like(pytree.tree_map(lambda v: v[0], values))


def _mask_rows_to_identity(m: Monoid, values: Pytree,
                           valid_mask: torch.Tensor) -> Pytree:
    """Replace invalid rows of a LIFTED batch with the monoid identity, so
    they are no-ops under combine — the ragged lowering for ANY monoid."""
    mask = valid_mask.to(torch.bool)
    one = _identity_rows(m, values)
    return pytree.tree_map(
        lambda v, i: torch.where(
            mask.reshape(mask.shape + (1,) * (v.dim() - 1)), v,
            torch.as_tensor(i, dtype=v.dtype, device=v.device)),
        values, one)


def _segment_reduce(v: torch.Tensor, ids: torch.Tensor, num_segments: int,
                    op: str) -> torch.Tensor:
    """Scatter-reduce a leaf (N, ...) by key into (S, ...); ``ids`` routes
    dropped rows to the spare row S.  Empty max/min keys get -inf/+inf for
    floats and iinfo.min/max for integers, like jax.ops.segment_max/min."""
    n = v.shape[0]
    flat = v.reshape(n, -1)
    w = flat.shape[1]
    if op == "sum":
        out = flat.new_zeros((num_segments + 1, w)).index_add_(0, ids, flat)
    else:
        if v.dtype.is_floating_point:
            fill = float("-inf") if op == "amax" else float("inf")
        else:
            info = torch.iinfo(v.dtype)
            fill = info.min if op == "amax" else info.max
        out = flat.new_full((num_segments + 1, w), fill).scatter_reduce_(
            0, ids[:, None].expand(n, w), flat, reduce=op, include_self=True)
    return out[:num_segments].reshape((num_segments,) + tuple(v.shape[1:]))


def _segment_fold_generic(m: Monoid, values: Pytree, segment_ids: torch.Tensor,
                          num_segments: int, init: Optional[Pytree] = None, *,
                          lifted: bool = True,
                          map_fn: Optional[Callable] = None,
                          valid_mask: Optional[torch.Tensor] = None) -> Pytree:
    """O(N) serial fold that works for ANY monoid (the associative array of
    Algorithm 4).  With ``lifted=False``/``map_fn`` the lift runs per record,
    so lifted values are never materialized.  Masked rows and ids outside
    ``[0, S)`` fold nothing — the identity, a combine no-op."""
    def prep(x):
        if map_fn is not None:
            return m.lift(map_fn(x))
        return x if lifted else m.lift(x)

    def row(i):
        return pytree.tree_map(lambda v: v[i], values)

    n = _leading_dim(values)
    if init is None:
        one = m.identity_like(prep(row(0)))
        acc = pytree.tree_map(
            lambda leaf: leaf.expand((num_segments,) + tuple(leaf.shape))
            .clone(), one)
    else:
        acc = pytree.tree_map(torch.clone, init)
    keys = segment_ids.tolist()
    keep = [True] * n if valid_mask is None else \
        valid_mask.to(torch.bool).tolist()
    for i, k in enumerate(keys):
        if not keep[i] or not 0 <= k < num_segments:
            continue
        cur = pytree.tree_map(lambda a: a[k], acc)
        new = m.combine(cur, prep(row(i)))

        def put(a, x):
            a[k] = x
        pytree.tree_map(put, acc, new)
    return acc


def _scan_fold_map(m: Monoid, values: Pytree, map_fn: Callable, axis: int,
                   valid_mask: Optional[torch.Tensor] = None) -> Pytree:
    """Flat in-mapper fold: lift(map_fn(x)) folded into one accumulator.
    Invalid rows fold nothing (the identity)."""
    if axis != 0:
        values = pytree.tree_map(lambda x: torch.movedim(x, axis, 0), values)
    n = _leading_dim(values)
    keep = [True] * n if valid_mask is None else \
        valid_mask.to(torch.bool).tolist()
    acc = None
    for i in range(n):
        v = m.lift(map_fn(pytree.tree_map(lambda x: x[i], values)))
        if acc is None:
            acc = m.identity_like(v)
        if keep[i]:
            acc = m.combine(acc, v)
    return acc


# ---------------------------------------------------------------------------
# the single entry point
# ---------------------------------------------------------------------------

def execute_fold(m: Monoid, values: Pytree, *, segment_ids=None,
                 num_segments: Optional[int] = None, valid_mask=None,
                 mesh_axes=None, layout: str = "auto", lifted: bool = True,
                 map_fn: Optional[Callable] = None,
                 init: Optional[Pytree] = None, axis: int = 0, mesh=None,
                 axis_sizes: Optional[Mapping[Any, int]] = None, lossy=None,
                 ef: Optional[Pytree] = None,
                 calibration: Optional[Calibration] = None,
                 with_plan: bool = False) -> Any:
    """Fold monoid values through the planner-chosen tiers.

    values: pytree with a leading (or ``axis``) batch dim.  With
    ``segment_ids`` (and ``num_segments``) the fold is keyed — a MapReduce
    'reduce by key' returning a (num_segments, ...) table, combined onto
    ``init`` when given.  ``valid_mask`` (one bool per record) makes the
    fold ragged: invalid rows contribute the monoid identity on every tier,
    so the result equals the fold over only the valid rows.

    layout: 'auto' argmins the calibrated cost model over the feasible
    tiers (see :func:`plan_fold`); 'kernel' / 'segment' / 'scan' / 'tree'
    force a tier.  ``map_fn`` maps raw inputs (then ``m.lift``) without
    materializing them on the scan tiers; ``lifted=False`` applies
    ``m.lift`` to each element first.

    With ``mesh_axes`` each rank's local result is combined across the named
    axes of the bound mesh (``repro_torch.dist.use_mesh``, or ``mesh=``,
    which also gives the planner the axis sizes; ``axis_sizes=`` gives them
    alone), fast ICI axes before the slow DCN ``pod`` axis, each axis's
    shuffle executed as the plan chose it.  ``lossy=`` (flat additive
    folds) crosses DCN compressed with error feedback: the result becomes
    ``(folded, new_ef)``, ``new_ef`` the residual to pass back as ``ef=``
    (``None`` starts from zeros; with no DCN axis it stays zero).
    ``layout='async'`` runs the double-buffered microbatch fold of
    :func:`repro_torch.dist.collectives.async_microbatch_fold`.

    Returns the folded value — or ``(value, plan)`` with ``with_plan=True``.
    A flat fold forced onto the scan with a ``map_fn`` runs before it is
    planned, and is planned from the folded value's shape: the scan needs
    no shape to be chosen, and a map that runs a model (a forward and
    backward) cannot be sized on ``meta`` tensors.
    """
    if valid_mask is not None and axis != 0:
        raise ValueError("valid_mask requires the batch axis at 0")
    plan_mask = valid_mask
    if valid_mask is not None:
        _check_valid_mask(valid_mask, _leading_dim(values))
        # plan from the mask's SHAPE only: counting a device mask would
        # synchronize just for byte bookkeeping
        plan_mask = torch.empty(tuple(valid_mask.shape), dtype=torch.bool,
                                device="meta")
    out = value_shape = None
    if (segment_ids is None and init is None and map_fn is not None
            and layout == "scan"):
        out = _scan_fold_map(m, values, map_fn, axis, valid_mask=valid_mask)
        value_shape = pytree.tree_map(
            lambda t: torch.empty_like(t, device="meta"), out)
    plan = plan_fold(m, values, segment_ids=segment_ids,
                     num_segments=num_segments, valid_mask=plan_mask,
                     mesh_axes=mesh_axes, layout=layout, lifted=lifted,
                     map_fn=map_fn, mesh=mesh, axis_sizes=axis_sizes,
                     lossy=lossy, calibration=calibration,
                     value_shape=value_shape)
    kind = plan.local_tier.kind
    keyed = segment_ids is not None
    spec = None
    if lossy is not None:
        from ..optim.compress import LossySpec
        spec = LossySpec.parse(lossy)

    def result(value, new_ef=None):
        if spec is not None:
            if new_ef is None:   # lossy annotation but no mesh crossing
                new_ef = ef if ef is not None else pytree.tree_map(
                    lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                          device=l.device), value)
            value = (value, new_ef)
        return (value, plan) if with_plan else value

    with maybe_mesh(mesh):
        if kind == "async":
            if valid_mask is not None:
                raise ValueError("layout='async' does not support "
                                 "valid_mask; mask rows to the identity "
                                 "before the fold")
            if axis != 0:
                raise ValueError("async folds require the batch axis at 0")
            if init is not None:
                raise ValueError("init is only supported for keyed folds")
            from ..dist.collectives import async_microbatch_fold
            if spec is not None and ef is None:
                one = _lifted_value_shape(m, values, lifted, map_fn)
                dev = pytree.tree_leaves(values)[0].device
                ef = pytree.tree_map(
                    lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                          device=dev), one)
            out, new_ef = async_microbatch_fold(m, values, mesh_axes,
                                                map_fn=map_fn, lifted=lifted,
                                                lossy=spec, ef=ef)
            return result(out, new_ef if spec is not None else None)
        if out is None:
            out = _local_fold(m, values, kind, segment_ids, num_segments,
                              valid_mask, lifted, map_fn, init, axis)
        if not mesh_axes:
            return result(out)
        from ..dist.collectives import (combine_keyed_table,
                                        cross_axes_allreduce,
                                        lossy_cross_axes)
        if spec is not None:
            if ef is None:
                ef = pytree.tree_map(
                    lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                          device=l.device), out)
            out, ef = lossy_cross_axes(spec, out, mesh_axes, ef=ef)
            return result(out, ef)
        coll = [t for t in plan.tiers
                if t.kind in ("allreduce", "reduce_scatter")]
        if keyed and any(t.kind == "reduce_scatter" for t in coll):
            # execute the plan's per-axis shuffle choice: the axis order
            # here (ICI then DCN) is the planner's tier order by construction
            ici, dcn = _split_ici_dcn(mesh_axes)
            for ax, tier in zip(ici + dcn, coll):
                out = combine_keyed_table(m, out, ax, algorithm=tier.kind)
        else:
            out = cross_axes_allreduce(m, out, mesh_axes)
        return result(out)


def _local_fold(m: Monoid, values: Pytree, kind: str, segment_ids,
                num_segments: Optional[int], valid_mask, lifted: bool,
                map_fn: Optional[Callable], init: Optional[Pytree],
                axis: int) -> Pytree:
    """Run the plan's local tier."""
    if segment_ids is not None:
        if axis != 0:
            raise ValueError("keyed folds require the batch axis at 0")
        if kind == "kernel":
            mat = _materialize_lifted(m, values, lifted, map_fn)
            folded = m.kernel_lowering().fn(mat, segment_ids, num_segments,
                                            valid_mask=valid_mask)
            return _seg_add_init(m, folded, init)
        if kind == "segment_ops":
            mat = _materialize_lifted(m, values, lifted, map_fn)
            keep = (segment_ids >= 0) & (segment_ids < num_segments)
            if valid_mask is not None:
                keep = keep & valid_mask.to(torch.bool)
            ids = torch.where(keep, segment_ids.long(), num_segments)
            op = _SEGMENT_OPS[m.name]
            folded = pytree.tree_map(
                lambda v: _segment_reduce(v, ids, num_segments, op), mat)
            return _seg_add_init(m, folded, init)
        return _segment_fold_generic(m, values, segment_ids, num_segments,
                                     init, lifted=lifted, map_fn=map_fn,
                                     valid_mask=valid_mask)
    if init is not None:
        raise ValueError("init is only supported for keyed folds")
    if kind == "tree":
        mat = _materialize_lifted(m, values, lifted, map_fn)
        if valid_mask is not None:
            mat = _mask_rows_to_identity(m, mat, valid_mask)
        return tree_fold(m, mat, axis=axis)
    if map_fn is not None:
        return _scan_fold_map(m, values, map_fn, axis, valid_mask=valid_mask)
    mat = _materialize_lifted(m, values, lifted, map_fn)
    if valid_mask is not None:
        mat = _mask_rows_to_identity(m, mat, valid_mask)
    return scan_fold(m, mat, axis=axis)


# ---------------------------------------------------------------------------
# keyed-fold compatibility wrapper (the pre-planner public API)
# ---------------------------------------------------------------------------

def segment_fold(m: Monoid, values: Pytree, segment_ids: torch.Tensor,
                 num_segments: int, *, init: Optional[Pytree] = None,
                 impl: str = "auto") -> Pytree:
    """Key-grouped monoid fold: MapReduce 'reduce by key', shapes static.

    Thin wrapper over :func:`execute_fold` kept for callers that predate the
    planner, with the JAX package's ``impl`` values.  'auto': the segment
    tier (``index_add_`` / ``scatter_reduce_``) when the monoid has one,
    else the generic scan; 'onehot' (additive monoids only): the CUDA
    segment-fold kernel when the values lie on the card and the kernel
    takes their dtypes, else the one-hot matmul in float32 (ids outside
    ``[0, S)`` fold nothing), either way cast back to each input leaf's
    dtype; 'scan': the generic path.
    """
    if impl == "onehot":
        if m.name not in ("sum", "mean", "count"):
            raise ValueError("onehot impl is only meaningful for additive "
                             "monoids")
        if _on_cuda(values) and _kernel_infeasible_reason(
                m, _one_slice(values)) is None:
            out = execute_fold(m, values, segment_ids=segment_ids,
                               num_segments=num_segments, init=init,
                               layout="kernel")
            return pytree.tree_map(lambda o, v: o.to(v.dtype), out, values)

        def onehot_sum(v):
            flat = v.reshape(v.shape[0], -1).to(torch.float32)
            oh = (segment_ids.to(torch.long)[None, :] == torch.arange(
                num_segments, device=v.device)[:, None]).to(torch.float32)
            out = oh @ flat                               # (S, V)
            return out.reshape((num_segments,) + tuple(v.shape[1:])).to(
                v.dtype)
        folded = pytree.tree_map(onehot_sum, values)
        return _seg_add_init(m, folded, init)
    if impl == "scan":
        layout = "scan"
    elif impl == "auto":
        layout = "segment" if m.name in _SEGMENT_OPS else "scan"
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return execute_fold(m, values, segment_ids=segment_ids,
                        num_segments=num_segments, init=init, layout=layout)
