"""The port's MapReduce jobs (Algorithms 1-5) vs the JAX package's.

Every case of ``tests/test_mapreduce.py``, with the same records through
both packages' jobs: results (integer tables exactly, float means within
1e-5 — the packages sum in different orders) and the cost model's
``ShuffleStats`` field for field (integers exactly, ``predicted_us`` to rel
1e-6, ``shuffle_algorithm`` equal; the plan strings name each package's own
ops).  Both planners price with their shipped default tables.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MapReduceJob as JMapReduceJob
from repro.core import average_by_key_job as j_average_by_key_job
from repro.core import cooccurrence_stripes_job as j_cooccurrence_stripes_job
from repro.core import monoids as jm
from repro.core import word_count_job as j_word_count_job
from repro.core.plan import plan_fold as j_plan_fold
from repro_torch.core import (STRATEGIES, MapReduceJob, MonoidTypeError,
                              algorithm2_combiner, average_by_key_job,
                              cooccurrence_stripes_job, fold_stats, monoids,
                              plan_fold, validate_combiner, word_count_job)
from repro_torch.core.calibration import default_calibration, use_calibration
from repro.core.mapreduce import fold_stats as j_fold_stats


@pytest.fixture(autouse=True)
def _shipped_calibration():
    with use_calibration(default_calibration()):
        yield


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 8, 96)
    vals = rng.normal(size=96).astype(np.float32)
    oracle = np.array([vals[keys == k].mean() if (keys == k).any() else 0.0
                       for k in range(8)])
    return keys, vals, oracle


def _both(keys, vals):
    return ({"key": torch.from_numpy(keys), "value": torch.from_numpy(vals)},
            {"key": jnp.asarray(keys), "value": jnp.asarray(vals)})


def _assert_stats_equal(got, want):
    """Every field, against the JAX record's field of the same name (the
    async and lossy annotations included)."""
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if name == "plan":
            continue
        if name in ("predicted_us", "overlap_modeled"):
            assert a == pytest.approx(b, rel=1e-6), name
        else:
            assert a == b, (name, a, b)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("num_shards", [1, 4])
def test_mean_by_key_all_strategies(records, strategy, num_shards):
    """Algorithms 1, 3 and 4 compute the JAX package's mean-by-key, and the
    cost model agrees field for field."""
    keys, vals, oracle = records
    t_rec, j_rec = _both(keys, vals)
    out = average_by_key_job(8).run_local(t_rec, strategy=strategy,
                                          num_shards=num_shards)
    want = np.asarray(j_average_by_key_job(8).run_local(
        j_rec, strategy=strategy, num_shards=num_shards))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), oracle, atol=1e-5)
    _assert_stats_equal(
        average_by_key_job(8).stats(t_rec, strategy=strategy,
                                    num_shards=num_shards),
        j_average_by_key_job(8).stats(j_rec, strategy=strategy,
                                      num_shards=num_shards))


def test_algorithm2_rejected():
    job = average_by_key_job(8)
    with pytest.raises(MonoidTypeError):
        validate_combiner(job.monoid, torch.tensor(1.0), algorithm2_combiner)
    bad_dtype = MapReduceJob(mapper=None, monoid=monoids.mean, num_keys=1)
    with pytest.raises(MonoidTypeError, match="leaf"):
        validate_combiner(bad_dtype.monoid,
                          monoids.mean.lift(torch.tensor(1.0)),
                          lambda a, b: (a[0].double(), a[1]))


def test_legal_combiner_accepted():
    validate_combiner(monoids.mean, monoids.mean.lift(torch.tensor(1.0)))


def test_shuffle_accounting_ordering(records):
    keys, vals, _ = records
    t_rec, j_rec = _both(keys, vals)
    job = average_by_key_job(8)
    st = {s: job.stats(t_rec, strategy=s, num_shards=4) for s in STRATEGIES}
    assert st["naive"].shuffle_bytes_mapreduce >= \
        st["combiner"].shuffle_bytes_mapreduce
    assert st["combiner"].shuffle_bytes_mapreduce == \
        st["in_mapper"].shuffle_bytes_mapreduce
    assert st["in_mapper"].intermediate_values < \
        st["combiner"].intermediate_values
    assert st["naive"].reduction_vs_naive() == 1.0
    assert st["in_mapper"].reduction_vs_naive() > 1.0
    # ragged: only valid rows become pairs, as in the JAX package
    mask = np.arange(96) % 3 != 0
    for s in STRATEGIES:
        _assert_stats_equal(
            job.stats(t_rec, strategy=s, num_shards=4,
                      valid_mask=torch.from_numpy(mask)),
            j_average_by_key_job(8).stats(j_rec, strategy=s, num_shards=4,
                                          valid_mask=jnp.asarray(mask)))


def test_word_count(records):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 50, 400)
    for s in STRATEGIES:
        out = word_count_job(50).run_local(torch.from_numpy(toks),
                                           strategy=s, num_shards=4)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(),
                                      np.bincount(toks, minlength=50))
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(j_word_count_job(50).run_local(
                jnp.asarray(toks), strategy=s, num_shards=4)))
        _assert_stats_equal(
            word_count_job(50).stats(torch.from_numpy(toks), strategy=s,
                                     num_shards=4),
            j_word_count_job(50).stats(jnp.asarray(toks), strategy=s,
                                       num_shards=4))


def test_stripes_cooccurrence_job():
    """Algorithm 5: windowed co-occurrence via the stripes monoid."""
    rng = np.random.default_rng(2)
    vocab, window, n = 16, 2, 64
    toks = rng.integers(0, vocab, n)
    wins = np.stack([toks[i - window:i + window + 1]
                     for i in range(window, n - window)])
    job = cooccurrence_stripes_job(vocab, window)
    out = job.run_local(torch.from_numpy(wins), strategy="in_mapper",
                        num_shards=4)
    oracle = np.zeros((vocab, vocab), np.int64)
    for i in range(window, n - window):
        for off in range(-window, window + 1):
            if off != 0:
                oracle[toks[i], toks[i + off]] += 1
    np.testing.assert_array_equal(out.numpy(), oracle)
    jout = j_cooccurrence_stripes_job(vocab, window).run_local(
        jnp.asarray(wins), strategy="in_mapper", num_shards=4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    for s in ("naive", "combiner"):
        np.testing.assert_array_equal(
            job.run_local(torch.from_numpy(wins), strategy=s,
                          num_shards=4).numpy(), oracle)


def test_strategies_agree_on_random_monoid_jobs():
    """max-by-key with the max monoid (non-additive path)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 5, 64)
    vals = rng.normal(size=64).astype(np.float32)

    job = MapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                       monoid=monoids.max_, num_keys=5)
    jjob = JMapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                         monoid=jm.max_, num_keys=5)
    t_rec, j_rec = _both(keys, vals)
    outs = [job.run_local(t_rec, strategy=s, num_shards=4).numpy()
            for s in STRATEGIES]
    oracle = np.array([vals[keys == k].max() if (keys == k).any() else -np.inf
                       for k in range(5)])
    for s, o in zip(STRATEGIES, outs):
        np.testing.assert_array_equal(o, oracle)
        np.testing.assert_array_equal(
            o, np.asarray(jjob.run_local(j_rec, strategy=s, num_shards=4)))


def test_run_local_contract():
    job = word_count_job(4)
    with pytest.raises(ValueError, match="strategy"):
        job.run_local(torch.arange(4), strategy="bogus")
    with pytest.raises(ValueError, match="shards"):
        job.run_local(torch.arange(5), num_shards=2)
    # across ranks it runs on a bound mesh (tests/test_torch_dist.py); an
    # unbound axis raises, naming it
    with pytest.raises(ValueError, match="'data' is not bound"):
        job.run_sharded(torch.arange(4), None)


@pytest.mark.parametrize("axes,sizes", [
    (("data",), {"data": 4}), (("data", "pod"), {"data": 4, "pod": 2}),
    (("data",), {}), (("pod",), {"pod": 3})])
def test_collective_plans_match(axes, sizes):
    """plan_fold across shard axes: the same tiers, bytes, algorithms and
    predicted times as the JAX planner (keyed and flat folds)."""
    vals = np.ones((40, 3), np.float32)
    seg = np.arange(40, dtype=np.int32) % 12
    for keyed in (True, False):
        kw = dict(segment_ids=seg, num_segments=12) if keyed else {}
        got = plan_fold(monoids.sum_, torch.from_numpy(vals),
                        **{k: (torch.from_numpy(v) if k == "segment_ids"
                               else v) for k, v in kw.items()},
                        mesh_axes=axes, axis_sizes=sizes)
        want = j_plan_fold(jm.sum_, jnp.asarray(vals),
                           **{k: (jnp.asarray(v) if k == "segment_ids"
                                  else v) for k, v in kw.items()},
                           mesh_axes=axes, axis_sizes=sizes,
                           layout="auto" if keyed else "tree")
        assert [t.kind for t in got.tiers] == [t.kind for t in want.tiers]
        assert [t.wire_bytes for t in got.tiers] == \
            [t.wire_bytes for t in want.tiers]
        assert got.predicted_us == pytest.approx(want.predicted_us, rel=1e-6)
        assert got.shuffle_algorithm == want.shuffle_algorithm
        assert got.collective_wire_bytes == want.collective_wire_bytes
        if not keyed:
            _assert_stats_equal(fold_stats(got), j_fold_stats(want))


@pytest.mark.parametrize("layout,lossy", [
    ("async", None), ("async", "int8"), ("scan", "topk:0.01"),
    ("auto", None)])
def test_fold_stats_carry_overlap_and_wire_fields(layout, lossy):
    """fold_stats of an async / lossy plan: the overlap and DCN wire-byte
    fields, crossings and bytes as the JAX record's, and with_measured /
    compression_ratio / overlap_collapse read them alike."""
    vals = np.zeros((6, 512), np.float32)
    sizes = {"x": 4, "pod": 2}
    got = fold_stats(plan_fold(monoids.sum_, torch.from_numpy(vals),
                               mesh_axes=("x", "pod"), axis_sizes=sizes,
                               layout=layout, lossy=lossy))
    want = j_fold_stats(j_plan_fold(jm.sum_, jnp.asarray(vals),
                                    mesh_axes=("x", "pod"), axis_sizes=sizes,
                                    layout=layout, lossy=lossy))
    _assert_stats_equal(got, want)
    assert got.lossy == (lossy or "")
    for us, ov in ((1500.0, None), (900.0, 0.3)):
        g, w = got.with_measured(us, overlap=ov), want.with_measured(
            us, overlap=ov)
        _assert_stats_equal(g, w)
        assert g.model_error() == pytest.approx(w.model_error(), rel=1e-6)
        assert g.compression_ratio() == pytest.approx(w.compression_ratio())
        if w.overlap_collapse() is None:
            assert g.overlap_collapse() is None
        else:
            assert g.overlap_collapse() == pytest.approx(
                w.overlap_collapse(), rel=1e-6)
