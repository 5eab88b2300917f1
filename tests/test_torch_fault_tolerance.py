"""The port's fault-tolerance control plane (``repro_torch.runtime.
fault_tolerance``, host Python) against the JAX package's on the same
inputs: twins of ``tests/test_fault_tolerance.py``'s straggler, escalation,
remesh and cadence tests, fed the JAX package's per-host ``ShuffleStats``
(async plans carry the overlap fields), and ``observe_stats`` on the
port's own ``ShuffleStats``, sync (modeled overlap 0) and async (the JAX
plan's modeled overlap)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.runtime.fault_tolerance as jft
from repro.core import monoids as jm
from repro.core import plan_fold as jax_plan_fold
from repro.core.mapreduce import fold_stats as jax_fold_stats
from repro_torch.core import monoids as tm
from repro_torch.core import plan_fold
from repro_torch.core.mapreduce import fold_stats
from repro_torch.runtime.fault_tolerance import (ElasticController,
                                                 MeshPlan, PreemptionHandler,
                                                 StragglerMonitor,
                                                 checkpoint_interval,
                                                 plan_remesh)

_SIZES = {"x": 4, "pod": 2}


def _jax_stats(layout="async"):
    shape = jax.ShapeDtypeStruct((4, 1024), jnp.float32)
    return jax_fold_stats(jax_plan_fold(jm.sum_, shape, mesh_axes=("x", "pod"),
                                        layout=layout, axis_sizes=_SIZES))


def _host_stats(base, measured_us, overlap):
    return [base.with_measured(us, overlap=ov)
            for us, ov in zip(measured_us, overlap)]


def _same_report(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _both(n, **kw):
    return StragglerMonitor(n, **kw), jft.StragglerMonitor(n, **kw)


def test_collapse_flagged_while_step_time_still_healthy():
    base = _jax_stats()
    mod = base.overlap_modeled
    stats = _host_stats(base, [1e6] * 4, [mod, mod, 0.1 * mod, mod])
    tmon, jmon = _both(4, patience=3, collapse_ratio=0.5)
    t, j = tmon.observe_stats(stats), jmon.observe_stats(stats)
    _same_report(t, j)
    assert t.collapsing_hosts == [2] and t.slow_hosts == []
    assert t.median_overlap == pytest.approx(mod)


@pytest.mark.parametrize("slow_us,patience", [(8e6, 3), (2e6, 2), (9e6, 1)])
def test_sustained_slowdown_escalates_like_jax(slow_us, patience):
    base = _jax_stats()
    mod = base.overlap_modeled
    tmon, jmon = _both(4, patience=patience, collapse_ratio=0.5)
    for _ in range(6):
        stats = _host_stats(base, [1e6, 1e6, slow_us, 1e6],
                            [mod, mod, 0.0, mod])
        t, j = tmon.observe_stats(stats), jmon.observe_stats(stats)
        _same_report(t, j)
    assert t.slow_hosts == [2]
    assert tmon.ewma == jmon.ewma and tmon.strikes == jmon.strikes


def test_observe_stats_falls_back_to_modeled_time():
    base = _jax_stats()
    stats = [base.with_measured(2e6), base, base, base]
    tmon, jmon = _both(4, patience=1)
    t, j = tmon.observe_stats(stats), jmon.observe_stats(stats)
    _same_report(t, j)
    assert t.slow_hosts == [0]


def test_sync_stats_never_flag_collapse():
    base = _jax_stats("scan")                 # overlap_modeled 0
    stats = _host_stats(base, [1e6, 1e6], [0.0, 0.0])
    tmon, jmon = _both(2)
    t, j = tmon.observe_stats(stats), jmon.observe_stats(stats)
    _same_report(t, j)
    assert t.collapsing_hosts == [] and t.median_overlap is None


def test_observe_stats_reads_the_ports_sync_stats():
    """The port's sync ShuffleStats models no overlap (0, as the JAX
    package's sync record), so it flags no collapse and reports no median
    overlap, and its step times drive the EWMA as the JAX package's sync
    record does."""
    plan = plan_fold(tm.sum_, torch.empty((4, 1024), device="meta"),
                     layout="scan")
    base = fold_stats(plan)
    assert base.overlap_modeled == 0.0 and base.overlap_measured is None
    jbase = _jax_stats("scan")
    times = [[1e6, 1e6, 5e6], [1e6, 1.2e6, 6e6], [1e6, 1e6, 7e6]]
    tmon, jmon = _both(3, patience=2)
    for us in times:
        t = tmon.observe_stats([base.with_measured(x) for x in us])
        j = jmon.observe_stats(_host_stats(jbase, us, [None] * 3))
        _same_report(t, j)
    assert t.slow_hosts == [2] and t.collapsing_hosts == []
    assert t.median_overlap is None
    silent = StragglerMonitor(2).observe_stats([base, base])
    assert silent.median_s == pytest.approx(base.predicted_us / 1e6)


def test_observe_stats_reads_the_ports_async_stats():
    """The port's async plan models the JAX plan's overlap, and its
    per-host records flag the same collapsing hosts and median overlap."""
    plan = plan_fold(tm.sum_, torch.empty((4, 1024), device="meta"),
                     mesh_axes=("x", "pod"), layout="async",
                     axis_sizes=_SIZES)
    base, jbase = fold_stats(plan), _jax_stats("async")
    mod = jbase.overlap_modeled
    assert mod > 0 and base.overlap_modeled == pytest.approx(mod, rel=1e-9)
    tmon, jmon = _both(4, patience=2)
    for overlap in ([mod] * 4, [mod, mod, 0.1 * mod, mod],
                    [0.2 * mod, mod, mod, mod]):
        t = tmon.observe_stats([base.with_measured(1e6, overlap=ov)
                                for ov in overlap])
        j = jmon.observe_stats(_host_stats(jbase, [1e6] * 4, overlap))
        _same_report(t, j)
    assert t.collapsing_hosts == [0]


def test_ingest_records_suspects_without_remesh():
    base = _jax_stats()
    mod = base.overlap_modeled
    stats = _host_stats(base, [1e6] * 4, [mod, mod, 0.1 * mod, mod])
    report = StragglerMonitor(4, patience=3).observe_stats(stats)
    ctl = ElasticController(64, model_parallel=16, on_remesh=None)
    jctl = jft.ElasticController(64, model_parallel=16, on_remesh=None)
    shape = ctl.current.shape
    assert ctl.ingest(report) is None
    assert jctl.ingest(jft.StragglerMonitor(4, patience=3)
                       .observe_stats(stats)) is None
    assert ctl.suspects == jctl.suspects == [2]
    assert ctl.current.shape == shape


def test_ingest_escalation_downs_host_once():
    base = _jax_stats()
    mod = base.overlap_modeled
    tmon, jmon = _both(4, patience=2)
    t_remesh, j_remesh = [], []
    ctl = ElasticController(64, model_parallel=16,
                            on_remesh=t_remesh.append)
    jctl = jft.ElasticController(64, model_parallel=16,
                                 on_remesh=j_remesh.append)
    plan = jplan = None
    for _ in range(4):
        stats = _host_stats(base, [1e6, 1e6, 9e6, 1e6], [mod, mod, 0.0, mod])
        plan = ctl.ingest(tmon.observe_stats(stats),
                          devices_per_host=16) or plan
        jplan = jctl.ingest(jmon.observe_stats(stats),
                            devices_per_host=16) or jplan
    assert plan is not None and plan.shape == jplan.shape == (2, 16)
    assert len(t_remesh) == len(j_remesh) == 1
    assert ctl.suspects == jctl.suspects == []
    assert ctl.healthy == jctl.healthy


@pytest.mark.parametrize("devices,mp,pods,nominal", [
    (15, 16, 1, 16), (16, 16, 1, 16), (64, 16, 1, 16), (100, 8, 1, 16),
    (256, 16, 2, 8), (250, 4, 3, 16), (3, 1, 1, 4)])
def test_plan_remesh_matches_jax(devices, mp, pods, nominal):
    got = plan_remesh(devices, model_parallel=mp, pods=pods,
                      nominal_data=nominal)
    want = jft.plan_remesh(devices, model_parallel=mp, pods=pods,
                           nominal_data=nominal)
    if want is None:
        assert got is None
    else:
        assert isinstance(got, MeshPlan)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_controller_failure_and_recovery_like_jax():
    ctl = ElasticController(64, model_parallel=16)
    jctl = jft.ElasticController(64, model_parallel=16)
    for op, n in (("report_failure", 20), ("report_failure", 3),
                  ("report_recovery", 23)):
        got, want = getattr(ctl, op)(n), getattr(jctl, op)(n)
        assert (got is None) == (want is None)
        assert ctl.current.shape == jctl.current.shape
    with pytest.raises(RuntimeError, match="unrecoverable"):
        ctl.report_failure(60)


@pytest.mark.parametrize("step_s,mtbf,nodes,write", [
    (2.0, 24.0, 1000, 30.0), (1e9, 1.0, 10**6, 30.0), (2.0, 24.0, 10, 30.0),
    (0.5, 8760.0, 4096, 120.0)])
def test_checkpoint_interval_matches_jax(step_s, mtbf, nodes, write):
    got = checkpoint_interval(step_s, mtbf_hours=mtbf, num_nodes=nodes,
                              write_time_s=write)
    assert got == jft.checkpoint_interval(step_s, mtbf_hours=mtbf,
                                          num_nodes=nodes,
                                          write_time_s=write)
    assert got >= 1
    assert checkpoint_interval(2.0, num_nodes=10) > \
        checkpoint_interval(2.0, num_nodes=1000)


def test_preemption_handler_flag_and_restore():
    import signal
    prev = signal.getsignal(signal.SIGUSR1)
    h = PreemptionHandler(signals=(signal.SIGUSR1,))
    assert not h.should_stop
    signal.raise_signal(signal.SIGUSR1)
    assert h.should_stop
    h.restore()
    assert signal.getsignal(signal.SIGUSR1) is prev
    h2 = PreemptionHandler(signals=())
    h2.trigger()
    assert h2.should_stop
