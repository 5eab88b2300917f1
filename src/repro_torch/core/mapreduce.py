"""The paper's MapReduce algorithms (1-5) as jobs over PyTorch tensors.

A :class:`MapReduceJob` is the paper's program model made static-shaped:

    mapper  : records -> (keys (N,), raws (N, ...))   key in [0, num_keys)
    monoid  : lift/combine/identity/extract over the intermediate value
    reducer : the monoid combine + extract (never user-written — that is
              exactly the paper's point)

The mapper is BATCHED (it maps a whole shard of records at once, in PyTorch
idiom) where the JAX package vmaps a per-record mapper; the simulated
mappers of :meth:`MapReduceJob.run_local` are a loop over shards.  Three
strategies mirror the paper's algorithms:

* ``naive``     — Algorithm 1: every lifted pair reaches the reduce side.
* ``combiner``  — Algorithm 3: lifted pairs are materialised, then
                  segment-folded into a dense per-key table per shard (the
                  planner's kernel tier — the ``segment_fold`` CUDA kernel —
                  on the card); only ``num_keys`` values per shard are
                  shuffled.
* ``in_mapper`` — Algorithm 4: the per-key table is the scan carry; lifted
                  pairs are never materialised.

Algorithm 2 (the combiner that changes the value type) is rejected by
:func:`validate_combiner`.  Byte accounting (:meth:`MapReduceJob.stats`) is
read off the planner's :class:`~repro_torch.core.plan.Plan` across a shard
axis.  :meth:`MapReduceJob.run_sharded` runs the job across the ranks of a
mesh axis: each rank maps and combines its block of the records, then the
monoid shuffle the plan chose combines the tables (``dist/collectives.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .monoid import Monoid, MonoidTypeError, Pytree, tree_fold
from .plan import (Plan, _leading_dim, _static_valid_count, execute_fold,
                   plan_fold)

STRATEGIES = ("naive", "combiner", "in_mapper")


@dataclasses.dataclass(frozen=True)
class ShuffleStats:
    """The paper's efficiency story in numbers (per strategy, whole job).

    intermediate_values: monoid values materialised map-side (Alg 1/3: one
      per record; Alg 4: only the table).
    shuffle_values: monoid values that cross the wire.
    shuffle_bytes_mapreduce: shuffle_values x bytes(value) — the paper's model.
    shuffle_bytes_xla: bytes the planned collectives move across the shard
      axis (the JAX package's name for the field).
    shuffle_algorithm: the planner's shuffle choice ('reduce_scatter' |
      'allreduce'; '' when the plan has no table shuffle).
    predicted_us: the plan's modeled wall time under the active calibration.
    measured_us: an observed wall time attached with :meth:`with_measured`.
    overlap_modeled: the plan's modeled hidden fraction of DCN crossing time
      (0 for sync plans: nothing is pipelined, nothing can hide).
    overlap_measured: the observed hidden fraction, attached with
      :meth:`with_measured` — a straggling host shows up here as collapsing
      overlap before it shows up as a timeout (runtime/fault_tolerance.py).
    dense_wire_bytes / lossy_wire_bytes: per-device DCN bytes of the dense
      sync crossing vs what the plan moves (equal unless ``lossy``).
    lossy: the compression annotation (``LossySpec.describe()``; '' = dense).
    """

    strategy: str
    num_records: int
    num_keys: int
    value_bytes: int
    intermediate_values: int
    shuffle_values: int
    shuffle_bytes_mapreduce: int
    shuffle_bytes_xla: int
    plan: str = ""
    shuffle_algorithm: str = ""
    predicted_us: float = 0.0
    measured_us: Optional[float] = None
    overlap_modeled: float = 0.0
    overlap_measured: Optional[float] = None
    dense_wire_bytes: int = 0
    lossy_wire_bytes: int = 0
    lossy: str = ""

    def reduction_vs_naive(self) -> float:
        naive = self.num_records * self.value_bytes
        return naive / max(self.shuffle_bytes_mapreduce, 1)

    def with_measured(self, us: float, *,
                      overlap: Optional[float] = None) -> "ShuffleStats":
        """Attach an observed wall time (microseconds) — and optionally the
        observed hidden-overlap fraction — to compare with the model."""
        return dataclasses.replace(
            self, measured_us=float(us),
            overlap_measured=(self.overlap_measured if overlap is None
                              else float(overlap)))

    def model_error(self) -> Optional[float]:
        """measured/predicted ratio (None until both sides exist)."""
        if self.measured_us is None or self.predicted_us <= 0:
            return None
        return self.measured_us / self.predicted_us

    def compression_ratio(self) -> float:
        """dense/actual DCN bytes (1.0 when the crossing is dense)."""
        if self.lossy_wire_bytes <= 0:
            return 1.0
        return self.dense_wire_bytes / self.lossy_wire_bytes

    def overlap_collapse(self) -> Optional[float]:
        """modeled - measured overlap fraction: how much of the promised
        hiding did NOT happen (None until a measurement is attached; only
        meaningful for async plans, where overlap_modeled > 0)."""
        if self.overlap_measured is None:
            return None
        return self.overlap_modeled - self.overlap_measured


def fold_stats(plan: Plan, *, strategy: str = "fold") -> ShuffleStats:
    """:class:`ShuffleStats` for a planner-lowered FLAT fold (a gradient or
    metrics fold), every figure read off the :class:`Plan`, the overlap and
    compression annotations included: the per-step record the training
    loop hands to ``runtime.fault_tolerance``."""
    crossings = plan.num_records if plan.local_tier.kind == "async" else 1
    return ShuffleStats(
        strategy=strategy, num_records=plan.num_records,
        num_keys=plan.num_segments or 0, value_bytes=plan.value_bytes,
        intermediate_values=plan.num_records, shuffle_values=crossings,
        shuffle_bytes_mapreduce=crossings * plan.value_bytes,
        shuffle_bytes_xla=plan.collective_wire_bytes,
        plan=plan.describe(), shuffle_algorithm=plan.shuffle_algorithm or "",
        predicted_us=plan.predicted_us,
        overlap_modeled=plan.overlap_modeled,
        dense_wire_bytes=plan.dense_wire_bytes,
        lossy_wire_bytes=plan.lossy_wire_bytes,
        lossy=plan.lossy or "")


def _to_meta(tree: Pytree) -> Pytree:
    return pytree.tree_map(lambda x: torch.as_tensor(x).to("meta"), tree)


def validate_combiner(monoid: Monoid, example_value: Pytree,
                      combiner_fn: Optional[Callable[[Pytree, Pytree],
                                                     Pytree]] = None) -> None:
    """The MapReduce combiner contract: combine must map M x M -> M.

    The paper's Algorithm 2 fails this check (its combiner turns a value
    into a ``(sum, count)`` pair).  The combiner runs on ``meta`` tensors,
    so no FLOPs are spent; raises :class:`MonoidTypeError` on violation.
    """
    fn = combiner_fn if combiner_fn is not None else monoid.combine
    example = _to_meta(example_value)
    out = fn(example, example)
    s_in = pytree.tree_structure(example)
    s_out = pytree.tree_structure(out)
    if s_in != s_out:
        raise MonoidTypeError(
            f"combiner output structure {s_out} != input value structure "
            f"{s_in}: a combiner may run zero, one, or many times, so its "
            "output type must equal its input type (paper, Algorithm 2).")
    for li, lo in zip(pytree.tree_leaves(example), pytree.tree_leaves(out)):
        lo = torch.as_tensor(lo)
        if li.shape != lo.shape or li.dtype != lo.dtype:
            raise MonoidTypeError(
                f"combiner changed leaf {tuple(li.shape)}/{li.dtype} -> "
                f"{tuple(lo.shape)}/{lo.dtype} (paper, Algorithm 2).")


def _shaped(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor of ``shape`` on ``device`` that holds ONE element (a
    broadcast view): planning sees the device without allocating pairs."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.empty((), dtype=dtype, device=device).expand(shape)


@dataclasses.dataclass(frozen=True)
class MapReduceJob:
    """A static-shaped MapReduce job over a fixed key space.

    mapper: records -> (keys (N,), raws with leading axis N); batched.
    monoid: the intermediate-value monoid (lift applied to each raw value).
    num_keys: size of the key space (hash-bucket open key spaces).
    """

    mapper: Callable[[Pytree], Tuple[torch.Tensor, Pytree]]
    monoid: Monoid
    num_keys: int

    # -- map side -------------------------------------------------------------
    def _map_records(self, records: Pytree) -> Tuple[torch.Tensor, Pytree]:
        keys, raws = self.mapper(records)
        return keys.to(torch.int32), raws

    def _local_table(self, records: Pytree, strategy: str) -> Pytree:
        """Algorithm 3 (``combiner``: the planner picks the tier for the
        materialised lifted pairs) or Algorithm 4 (``in_mapper``: the scan
        tier with the lift fused into each step)."""
        keys, raws = self._map_records(records)
        return execute_fold(self.monoid, raws, segment_ids=keys,
                            num_segments=self.num_keys, lifted=False,
                            layout="scan" if strategy == "in_mapper"
                            else "auto")

    # -- single-host execution -----------------------------------------------
    def run_local(self, records: Pytree, *, strategy: str = "in_mapper",
                  num_shards: int = 1, extract: bool = True) -> Pytree:
        """Execution with ``num_shards`` simulated mappers, on the records'
        device.  Records' leading axis must divide by num_shards."""
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        n = _leading_dim(records)
        if n % num_shards:
            raise ValueError(f"{n} records do not split into {num_shards} "
                             "shards")
        per = n // num_shards
        shards = [pytree.tree_map(lambda x: x[i * per:(i + 1) * per], records)
                  for i in range(num_shards)]
        if strategy == "naive":
            # every lifted pair survives to the "reduce" side
            mapped = [self._map_records(s) for s in shards]
            keys = torch.cat([k for k, _ in mapped])
            raws = pytree.tree_map(lambda *xs: torch.cat(xs),
                                   *[r for _, r in mapped])
            lifted = vmap(self.monoid.lift)(raws)
            table = execute_fold(self.monoid, lifted, segment_ids=keys,
                                 num_segments=self.num_keys)
        else:
            tables = [self._local_table(s, strategy) for s in shards]
            stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *tables)
            table = tree_fold(self.monoid, stacked, axis=0)
        return self._finish(table, extract)

    # -- mesh execution ---------------------------------------------------------
    def run_sharded(self, records: Pytree, mesh, *, axis_name: str = "data",
                    strategy: str = "in_mapper",
                    extract: bool = True) -> Pytree:
        """Execution across the ranks of ``mesh``'s ``axis_name`` axis.

        records: globally-batched pytree (the same on every rank), leading
        axis divisible by the axis size; each rank runs the map+combine
        phase on its block (``dist.local_block``), then the dense key table
        is combined across ranks with whatever shuffle the PLAN chose
        (``Plan.shuffle_algorithm`` — reduce-scatter + all-gather when the
        cost model prefers it, allreduce otherwise):

          naive     -> all pairs cross the wire (all-gather), receivers fold
          combiner / in_mapper -> the plan's shuffle of the dense table

        The result is the full (num_keys, ...) extracted table, replicated
        on every rank.  ``mesh=None`` runs on the mesh bound by
        ``dist.use_mesh``.
        """
        from .. import dist
        from ..dist.collectives import combine_keyed_table

        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        with dist.maybe_mesh(mesh):
            P = dist.axis_size(axis_name)      # an unbound axis raises here
            plan = self.plan(records, strategy=strategy, num_shards=P,
                             axis_name=axis_name)
            shuffle = plan.shuffle_algorithm or "allreduce"
            recs = dist.local_block(records, dist.current_mesh(), axis_name)
            if strategy == "naive":
                keys, raws = self._map_records(recs)
                lifted = vmap(self.monoid.lift)(raws)
                table = execute_fold(
                    self.monoid, dist.all_gather(lifted, axis_name,
                                                 tiled=True),
                    segment_ids=dist.all_gather(keys, axis_name, tiled=True),
                    num_segments=self.num_keys)
            else:
                table = combine_keyed_table(
                    self.monoid, self._local_table(recs, strategy),
                    axis_name, algorithm=shuffle)
        return self._finish(table, extract)

    def _finish(self, table: Pytree, extract: bool) -> Pytree:
        if not extract:
            return table
        return vmap(self.monoid.extract)(table)

    # -- accounting --------------------------------------------------------------
    def plan(self, records: Pytree, *, strategy: str, num_shards: int,
             valid_mask=None, axis_name: str = "shard") -> Plan:
        """The execution plan for this job's per-shard fold + shuffle,
        built without FLOPs: the mapper and lift run on ``meta`` tensors,
        and one shard's pairs are broadcast views on the records' device
        (so the kernel tier's feasibility sees the device).  strategy=
        'naive' models Algorithm 1 (``pre_combine=False``); 'combiner' /
        'in_mapper' differ only in the local tier.  ``valid_mask`` (one bool
        per record, whole job) marks padding rows; shard 0's slice stands
        for every shard in the masked byte model."""
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        n = _leading_dim(records)
        local_n = max(1, n // num_shards)
        device = pytree.tree_leaves(records)[0].device
        one = pytree.tree_map(
            lambda x: torch.empty((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device="meta"), records)
        _, raw = self._map_records(one)
        value = self.monoid.lift(pytree.tree_map(lambda r: r[0], raw))
        pairs = pytree.tree_map(
            lambda v: _shaped((local_n,) + tuple(v.shape), v.dtype, device),
            value)
        seg = _shaped((local_n,), torch.int32, device)
        shard_mask = None
        if valid_mask is not None:
            shard_mask = valid_mask.to(torch.bool)[:local_n]
        return plan_fold(
            self.monoid, pairs, segment_ids=seg, num_segments=self.num_keys,
            valid_mask=shard_mask, mesh_axes=(axis_name,),
            axis_sizes={axis_name: num_shards},
            layout="scan" if strategy == "in_mapper" else "auto",
            pre_combine=strategy != "naive")

    def stats(self, records: Pytree, *, strategy: str, num_shards: int,
              valid_mask=None) -> ShuffleStats:
        """The paper's cost model for this job on ``num_shards`` mappers —
        every byte figure is read off the execution plan.  With a ragged
        ``valid_mask`` only valid rows become pairs."""
        n = _leading_dim(records)
        plan = self.plan(records, strategy=strategy, num_shards=num_shards,
                         valid_mask=valid_mask)
        n_valid = _static_valid_count(valid_mask)
        if n_valid is None:       # no mask, or a meta one: count every row
            n_valid = n
        vbytes = plan.value_bytes
        table_values = self.num_keys * num_shards
        if strategy == "naive":
            inter, shuffled = n_valid, n_valid
        elif strategy == "combiner":
            inter, shuffled = n_valid + table_values, table_values
        else:  # in_mapper: only the table is ever live
            inter, shuffled = table_values, table_values
        return ShuffleStats(
            strategy=strategy, num_records=n, num_keys=self.num_keys,
            value_bytes=vbytes, intermediate_values=inter,
            shuffle_values=shuffled,
            shuffle_bytes_mapreduce=shuffled * vbytes,
            shuffle_bytes_xla=plan.collective_wire_bytes,
            plan=plan.describe(),
            shuffle_algorithm=plan.shuffle_algorithm or "",
            predicted_us=plan.predicted_us)


# ---------------------------------------------------------------------------
# The paper's running example: average of values by key (Algorithms 1/3/4)
# ---------------------------------------------------------------------------

def average_by_key_job(num_keys: int) -> MapReduceJob:
    """Mean-by-key: the paper's running example with the (sum, count)
    monoid.  Records are ``{"key": (N,) int, "value": (N, ...)}``."""
    from . import monoids

    def mapper(records):
        return records["key"], records["value"]

    return MapReduceJob(mapper=mapper, monoid=monoids.mean, num_keys=num_keys)


def algorithm2_combiner(t_and_r, _ignored):
    """The paper's ILLEGAL Algorithm 2 combiner: values -> (sum, count).
    Provided so a test can show the engine rejecting it."""
    return (t_and_r, torch.ones((), dtype=torch.int32))


def word_count_job(vocab: int) -> MapReduceJob:
    """The canonical MapReduce hello-world as a monoid job over token ids."""
    from . import monoids

    def mapper(tokens):
        return tokens, torch.ones_like(tokens, dtype=torch.int32)

    return MapReduceJob(mapper=mapper, monoid=monoids.sum_, num_keys=vocab)


def cooccurrence_stripes_job(vocab: int, window: int) -> MapReduceJob:
    """Algorithm 5 (stripes): records are (N, 2*window+1) token windows;
    key = the center word, value = its stripe (neighbour counts over the
    vocab, ids in [0, vocab))."""
    from . import monoids

    def mapper(wins):
        neigh = torch.cat([wins[:, :window], wins[:, window + 1:]], dim=1)
        stripe = (neigh[..., None] == torch.arange(vocab, device=wins.device)
                  ).sum(dim=1).to(torch.int32)
        return wins[:, window], stripe

    return MapReduceJob(mapper=mapper, monoid=monoids.stripes,
                        num_keys=vocab)
