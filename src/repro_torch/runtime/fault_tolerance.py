"""Fault-tolerance control plane: preemption, elastic re-mesh, stragglers.

The port of the JAX package's ``runtime/fault_tolerance.py``: host Python
with no tensors, the same decisions (mesh shapes, excluded hosts,
checkpoint cadence) on the same inputs.

Monoid tie-ins:
* restart = combine(checkpointed aggregate, new partial aggregate);
* elastic re-mesh re-brackets the data-parallel reduction over a different
  axis size -- legal because gradient / metric aggregation is associative
  and commutative;
* straggler-tolerant aggregation can combine the K fastest shards' partial
  metrics first and fold in late arrivals -- again only legal for monoids.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import threading
from typing import Callable, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful checkpoint-and-exit flag.

    A scheduler's maintenance events arrive as SIGTERM with a grace window;
    the train loop polls ``should_stop`` each step and saves before exiting.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._on_signal)

    def _on_signal(self, signum, frame):
        self._flag.set()

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:         # for tests / manual drain
        self._flag.set()

    def restore(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_hosts: int
    global_batch_scale: float   # rescale factor vs the nominal batch


def plan_remesh(healthy_devices: int, *, model_parallel: int = 16,
                pods: int = 1, nominal_data: int = 16) -> Optional[MeshPlan]:
    """Largest (pod, data, model) mesh that fits the surviving devices.

    Keeps the model axis fixed (TP degree is a property of the model fit) and
    shrinks the data axis to the largest power of two that fits — training
    continues at reduced global batch (scale reported so the caller can adjust
    LR / accumulation). Returns None if even (1, model_parallel) doesn't fit.
    """
    per_pod = healthy_devices // max(pods, 1)
    data = per_pod // model_parallel
    if data < 1:
        return None
    data = 1 << int(math.floor(math.log2(data)))
    shape: Tuple[int, ...]
    if pods > 1:
        shape, axes = (pods, data, model_parallel), ("pod", "data", "model")
        used = pods * data * model_parallel
    else:
        shape, axes = (data, model_parallel), ("data", "model")
        used = data * model_parallel
    return MeshPlan(shape=shape, axes=axes,
                    dropped_hosts=healthy_devices - used,
                    global_batch_scale=(pods * data) / max(nominal_data * pods, 1))


class ElasticController:
    """Decides when to re-mesh: on failure, shrink; on recovery, grow.

    ``on_remesh(plan)`` is the integration point: rebuild the mesh and the
    step (same code; only the mesh changes), and restore state from the
    latest checkpoint (the layout is mesh-agnostic:
    ``CheckpointStore.restore(shardings=)`` keeps each rank's block of the
    new mesh).
    """

    def __init__(self, total_devices: int, *, model_parallel: int = 16,
                 pods: int = 1, on_remesh: Optional[Callable] = None):
        self.total = total_devices
        self.model_parallel = model_parallel
        self.pods = pods
        self.healthy = total_devices
        self.on_remesh = on_remesh
        self.current = plan_remesh(total_devices, model_parallel=model_parallel,
                                   pods=pods)
        self.suspects: List[int] = []   # overlap-collapse early warnings
        self._downed: set = set()       # hosts already counted as failed

    def report_failure(self, num_devices: int) -> Optional[MeshPlan]:
        self.healthy = max(0, self.healthy - num_devices)
        return self._maybe_remesh()

    def ingest(self, report: StragglerReport, *,
               devices_per_host: int = 1) -> Optional[MeshPlan]:
        """Consume a :class:`StragglerReport` (from ``observe_stats``).

        Hosts flagged slow (EWMA past threshold for ``patience`` steps) are
        treated as failed and may trigger a re-mesh; hosts whose overlap
        merely collapsed this step become ``suspects`` — the pre-timeout
        warning a scheduler acts on (drain, re-balance input shards) without
        yet shrinking the mesh.
        """
        self.suspects = sorted(set(report.collapsing_hosts)
                               - set(report.slow_hosts) - self._downed)
        newly = [h for h in report.slow_hosts if h not in self._downed]
        if not newly:
            return None
        self._downed.update(newly)
        return self.report_failure(len(newly) * devices_per_host)

    def report_recovery(self, num_devices: int) -> Optional[MeshPlan]:
        self.healthy = min(self.total, self.healthy + num_devices)
        return self._maybe_remesh()

    def _maybe_remesh(self) -> Optional[MeshPlan]:
        plan = plan_remesh(self.healthy, model_parallel=self.model_parallel,
                           pods=self.pods)
        if plan is None:
            raise RuntimeError(
                f"unrecoverable: {self.healthy} devices cannot host "
                f"model_parallel={self.model_parallel}")
        if self.current is None or plan.shape != self.current.shape:
            self.current = plan
            if self.on_remesh:
                self.on_remesh(plan)
            return plan
        return None


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerReport:
    step: int
    slow_hosts: List[int]
    median_s: float
    threshold_s: float
    # hosts whose measured shuffle overlap collapsed below the model this
    # step — the EARLY signal: a slow host drags the pipelined DCN crossing
    # out from under everyone's compute (overlap fraction drops fleet-wide,
    # worst at the culprit) several steps before its EWMA step time trips
    # the timeout threshold above.  Empty when stats carry no overlap data.
    collapsing_hosts: List[int] = dataclasses.field(default_factory=list)
    median_overlap: Optional[float] = None


class StragglerMonitor:
    """EWMA per-host step-time tracking with a median-multiple threshold.

    A host whose smoothed step time exceeds ``ratio x`` the fleet median for
    ``patience`` consecutive steps is flagged. The controller's actions (in
    order): (1) re-balance input sharding away from the host's data shard,
    (2) raise checkpoint cadence, (3) treat as failed -> elastic re-mesh.
    On real fleets the timings come from per-host step barriers; tests feed
    synthetic timings.
    """

    def __init__(self, num_hosts: int, *, alpha: float = 0.3,
                 ratio: float = 1.5, patience: int = 3,
                 collapse_ratio: float = 0.5):
        self.alpha = alpha
        self.ratio = ratio
        self.patience = patience
        # a host whose measured overlap falls below collapse_ratio x its
        # modeled overlap is flagged immediately (no patience): overlap
        # collapse is a leading indicator, timeouts a trailing one
        self.collapse_ratio = collapse_ratio
        self.ewma = [0.0] * num_hosts
        self.strikes = [0] * num_hosts
        self.step = 0

    def observe(self, step_times: Sequence[float]) -> StragglerReport:
        self.step += 1
        for i, t in enumerate(step_times):
            self.ewma[i] = t if self.ewma[i] == 0.0 else \
                self.alpha * t + (1 - self.alpha) * self.ewma[i]
        med = sorted(self.ewma)[len(self.ewma) // 2]
        thr = self.ratio * med
        slow = []
        for i, e in enumerate(self.ewma):
            if e > thr:
                self.strikes[i] += 1
                if self.strikes[i] >= self.patience:
                    slow.append(i)
            else:
                self.strikes[i] = 0
        return StragglerReport(step=self.step, slow_hosts=slow,
                               median_s=med, threshold_s=thr)

    def observe_stats(self, per_host_stats: Sequence) -> StragglerReport:
        """Feed one ``core.mapreduce.ShuffleStats`` per host for this step.

        Step times come from ``measured_us`` (falling back to the model when
        a host reported none) and flow through the EWMA/patience machinery
        of :meth:`observe`.  Additionally, hosts running an overlapped
        (async) plan whose ``overlap_measured`` fell below
        ``collapse_ratio x overlap_modeled`` are flagged as collapsing THIS
        step — the same per-step record the benchmarks emit doubles as the
        health signal, and a struggling host is visible here while its step
        time is still inside the timeout threshold.
        """
        times = [
            (s.measured_us if s.measured_us is not None else s.predicted_us)
            / 1e6
            for s in per_host_stats]
        report = self.observe(times)
        collapsing = []
        overlaps = []
        for i, s in enumerate(per_host_stats):
            if s.overlap_modeled > 0.0 and s.overlap_measured is not None:
                overlaps.append(s.overlap_measured)
                if s.overlap_measured < self.collapse_ratio * s.overlap_modeled:
                    collapsing.append(i)
        report.collapsing_hosts = collapsing
        if overlaps:
            report.median_overlap = sorted(overlaps)[len(overlaps) // 2]
        return report


# ---------------------------------------------------------------------------
# checkpoint cadence
# ---------------------------------------------------------------------------

def checkpoint_interval(step_time_s: float, *, mtbf_hours: float = 24.0,
                        num_nodes: int = 1000, write_time_s: float = 30.0) -> int:
    """Young/Daly optimal checkpoint interval, in steps.

    t_opt = sqrt(2 * write_time * MTBF_system); MTBF_system = MTBF_node/nodes.
    At 1000 nodes x 24h MTBF => system MTBF 86s?? -- no: 86400*24/1000 ~ 86s
    would make training impossible; realistic node MTBF is years. The point
    of exposing the formula is that cadence is *derived*, not hard-coded.
    """
    mtbf_system_s = mtbf_hours * 3600.0 / max(num_nodes, 1)
    t_opt_s = math.sqrt(2.0 * write_time_s * mtbf_system_s)
    return max(1, int(t_opt_s / max(step_time_s, 1e-6)))
