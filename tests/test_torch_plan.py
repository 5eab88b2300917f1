"""The port's planner (``repro_torch.core.plan``) vs the JAX package's.

The same numpy inputs go through both ``execute_fold``s, tier by tier:
``kernel`` forced (the Pallas kernel in interpret mode vs the CUDA kernel's
plain version, which is what the port runs for CPU tensors), ``segment``,
``scan`` and ``auto``, with ``valid_mask``, ``init=`` and ``map_fn``.
Integer, max and min results are exact; float sums use rtol=1e-5,
atol=1e-5 (the tiers sum in different orders).  The port's planner prices
tiers with the shipped default table, pinned here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.core import execute_fold as jax_execute_fold
from repro.core import monoids as jm
from repro_torch.core import Monoid, execute_fold, monoids as tm, plan_fold
from repro_torch.core.calibration import default_calibration, use_calibration

N, D, S = 23, 3, 5


@pytest.fixture(autouse=True)
def _shipped_calibration():
    with use_calibration(default_calibration()):
        yield


def _samples(name, rng):
    """(jax monoid, torch monoid, numpy values pytree, numpy init pytree)."""
    vals = rng.normal(size=(N, D)).astype(np.float32)
    init = rng.normal(size=(S, D)).astype(np.float32)
    if name in ("sum", "max", "min"):
        return getattr(jm, name + "_"), getattr(tm, name + "_"), vals, init
    if name == "count":
        return jm.count, tm.count, np.ones((N,), np.int32), \
            rng.integers(0, 9, S).astype(np.int32)
    if name == "mean":       # pre-combined states: counts are not all 1
        return jm.mean, tm.mean, (vals, rng.integers(1, 4, N).astype(np.int32)), \
            (init, rng.integers(0, 9, S).astype(np.int32))
    if name == "bitwise_or":
        return jm.bitwise_or, tm.bitwise_or, \
            rng.integers(0, 2, (N, D)).astype(np.uint8), \
            rng.integers(0, 2, (S, D)).astype(np.uint8)
    raise ValueError(name)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return pytree.tree_map(torch.from_numpy, tree)


def _assert_tree_same(got, want):
    g_leaves = pytree.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["kernel", "segment", "scan", "auto"])
@pytest.mark.parametrize("name", ["sum", "max", "min", "count", "mean",
                                  "bitwise_or"])
def test_keyed_fold_matches_jax(name, layout):
    rng = np.random.default_rng(len(name) * 13 + len(layout))
    jmon, tmon, vals, init = _samples(name, rng)
    segs = rng.integers(0, S, N).astype(np.int32)
    mask = rng.random(N) < 0.6
    kw = dict(num_segments=S, layout=layout)
    want = jax_execute_fold(jmon, _j(vals), segment_ids=jnp.asarray(segs),
                            valid_mask=jnp.asarray(mask), init=_j(init),
                            block_n=16, **kw)
    got = execute_fold(tmon, _t(vals), segment_ids=torch.from_numpy(segs),
                       valid_mask=torch.from_numpy(mask), init=_t(init), **kw)
    _assert_tree_same(got, want)
    # and without mask or init: the dense fold
    want = jax_execute_fold(jmon, _j(vals), segment_ids=jnp.asarray(segs),
                            block_n=16, **kw)
    got = execute_fold(tmon, _t(vals), segment_ids=torch.from_numpy(segs),
                       **kw)
    _assert_tree_same(got, want)


@pytest.mark.parametrize("layout", ["segment", "scan"])
def test_keyed_map_fn_matches_jax(layout):
    """map_fn + lift on the keyed tiers (mean of 3x, the paper's example)."""
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(N,)).astype(np.float32)
    segs = rng.integers(0, S, N).astype(np.int32)
    mask = rng.random(N) < 0.7
    want = jax_execute_fold(jm.mean, jnp.asarray(xs), map_fn=lambda x: x * 3,
                            segment_ids=jnp.asarray(segs), num_segments=S,
                            valid_mask=jnp.asarray(mask), layout=layout)
    got = execute_fold(tm.mean, torch.from_numpy(xs), map_fn=lambda x: x * 3,
                       segment_ids=torch.from_numpy(segs), num_segments=S,
                       valid_mask=torch.from_numpy(mask), layout=layout)
    _assert_tree_same(got, want)


@pytest.mark.parametrize("layout", ["tree", "scan", "auto"])
def test_flat_fold_matches_jax(layout):
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(N, D)).astype(np.float32)
    mask = rng.random(N) < 0.5
    want = jax_execute_fold(jm.sum_, jnp.asarray(vals),
                            valid_mask=jnp.asarray(mask), layout=layout)
    got = execute_fold(tm.sum_, torch.from_numpy(vals),
                       valid_mask=torch.from_numpy(mask), layout=layout)
    _assert_tree_same(got, want)
    xs = vals[:, 0]
    want = jax_execute_fold(jm.mean, jnp.asarray(xs), map_fn=lambda x: x * 3,
                            valid_mask=jnp.asarray(mask), layout="scan")
    got = execute_fold(tm.mean, torch.from_numpy(xs), map_fn=lambda x: x * 3,
                       valid_mask=torch.from_numpy(mask), layout="scan")
    _assert_tree_same(got, want)
    np.testing.assert_allclose(float(tm.mean.extract(got)),
                               float(jm.mean.extract(want)), rtol=1e-6)


def test_auto_picks_segment_tier_for_cpu_tensors():
    """The kernel tier needs CUDA values: under auto, CPU (and meta)
    tensors never see it; forcing it runs the plain version."""
    vals = torch.zeros((8, 3))
    segs = torch.zeros((8,), dtype=torch.int32)
    for v in (vals, vals.to("meta")):
        p = plan_fold(tm.sum_, v, segment_ids=segs.to(v.device),
                      num_segments=4)
        assert p.local_tier.kind == "segment_ops"
        assert "kernel" not in p.candidate_us
        assert set(p.candidate_us) == {"segment", "scan"}
    forced = plan_fold(tm.sum_, vals, segment_ids=segs, num_segments=4,
                       layout="kernel")
    assert forced.local_tier.kind == "kernel"
    assert "plain version" in forced.local_tier.detail
    flat = plan_fold(tm.sum_, vals)
    assert flat.local_tier.kind == "tree"


def test_plan_counts_a_concrete_mask_but_not_a_meta_one():
    vals = torch.zeros((10, 2))
    segs = torch.zeros((10,), dtype=torch.int32)
    mask = torch.zeros((10,), dtype=torch.bool)
    mask[:4] = True
    p = plan_fold(tm.sum_, vals, segment_ids=segs, num_segments=3,
                  valid_mask=mask)
    assert p.num_valid == 4 and "+mask" in p.local_tier.detail
    p = plan_fold(tm.sum_, vals, segment_ids=segs, num_segments=3,
                  valid_mask=mask.to("meta"))
    assert p.num_valid is None and "+mask" in p.local_tier.detail
    assert p.value_bytes == 8 and p.out_bytes == 24
    with pytest.raises(ValueError, match="valid_mask"):
        plan_fold(tm.sum_, vals, segment_ids=segs, num_segments=3,
                  valid_mask=torch.ones((11,), dtype=torch.bool))


def test_wide_integers_leave_the_kernel_tier_under_auto():
    """_kernel_exact: int32 sums could exceed 2**24 in float32, so auto
    never offers the kernel for them (forcing it is the caller's call)."""
    from repro_torch.core.plan import _kernel_exact

    one = torch.empty((3,), dtype=torch.int32, device="meta")
    assert not _kernel_exact(one, 8)
    assert _kernel_exact(torch.empty((3,), dtype=torch.uint8, device="meta"), 8)
    assert _kernel_exact(torch.empty((3,), device="meta"), 10 ** 9)


def test_infeasible_layouts_raise_actionable_errors():
    vals = torch.ones((8, 2))
    segs = torch.zeros((8,), dtype=torch.int32)
    prod = Monoid(name="prod", combine=torch.mul,
                  identity_fn=lambda *, example: torch.ones_like(example))
    with pytest.raises(ValueError, match="no registered CUDA kernel lowering"):
        execute_fold(prod, vals, segment_ids=segs, num_segments=2,
                     layout="kernel")
    with pytest.raises(ValueError, match=r"dtype torch.float64.*'\[0\]'|"
                       r"'\[0\]'.*float64"):
        execute_fold(tm.sum_, (vals.double(),), segment_ids=segs,
                     num_segments=2, layout="kernel")
    with pytest.raises(ValueError, match="layout='scan'"):
        execute_fold(prod, vals, segment_ids=segs, num_segments=2,
                     layout="segment")
    with pytest.raises(ValueError, match="flat-fold"):
        execute_fold(tm.sum_, vals, segment_ids=segs, num_segments=2,
                     layout="tree")
    with pytest.raises(ValueError, match="num_segments="):
        execute_fold(tm.sum_, vals, segment_ids=segs)
    for layout in ("kernel", "segment"):
        with pytest.raises(ValueError, match="segment_ids="):
            execute_fold(tm.sum_, vals, layout=layout)
    with pytest.raises(ValueError, match="init"):
        execute_fold(tm.sum_, vals, init=torch.zeros(2))
    # the generic scan tier still runs any monoid
    out = execute_fold(prod, vals * 2, segment_ids=segs, num_segments=2,
                       layout="scan")
    assert torch.equal(out[0], torch.full((2,), 256.0))
    assert torch.equal(out[1], torch.ones(2))


@pytest.mark.parametrize("kw", [dict(mesh_axes=("data",)),
                                dict(lossy="topk:0.01"),
                                dict(layout="async")])
def test_mesh_tier_is_a_later_slice(kw):
    """The mesh tier's contract with no mesh bound (the mesh runs in
    tests/test_torch_dist.py): ``mesh_axes=`` raises ValueError naming the
    axis; ``lossy=`` returns ``(out, zero ef)`` as the JAX package does;
    ``layout='async'`` raises the JAX package's ValueError."""
    vals = torch.ones((4, 2))
    if "mesh_axes" in kw:
        with pytest.raises(ValueError, match="'data' is not bound"):
            execute_fold(tm.sum_, vals, **kw)
    elif "lossy" in kw:
        out, ef = execute_fold(tm.sum_, vals, **kw)
        jout, jef = jax_execute_fold(jm.sum_, jnp.ones((4, 2)), **kw)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(ef.numpy(), np.asarray(jef))
        assert ef.dtype == torch.float32 and not ef.any()
    else:
        with pytest.raises(ValueError, match="needs mesh_axes="):
            execute_fold(tm.sum_, vals, **kw)
        with pytest.raises(ValueError, match="needs mesh_axes="):
            jax_execute_fold(jm.sum_, jnp.ones((4, 2)), **kw)


def test_calibration_has_its_own_cache(tmp_path, monkeypatch):
    """The port reads $REPRO_TORCH_CALIB (never the JAX package's
    $REPRO_CALIB); a table of another version is ignored; a loaded table
    drives the tier choice."""
    import json

    from repro_torch.core import calibration as cal

    path = tmp_path / "calib.json"
    table = cal.default_calibration().to_json()
    table["source"] = "measured"
    table["tiers"]["scan"]["*"]["us_per_record"] = 0.0   # scan now cheapest
    path.write_text(json.dumps(table))
    monkeypatch.setenv("REPRO_CALIB", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_CALIB", str(path))
    assert cal.calibration_path() == str(path)
    loaded = cal.load_calibration()
    assert loaded is not None and loaded.source == "measured"
    p = plan_fold(tm.sum_, torch.zeros((8, 2)),
                  segment_ids=torch.zeros((8,), dtype=torch.int32),
                  num_segments=2, calibration=loaded)
    assert p.local_tier.kind == "scan"
    path.write_text(json.dumps({**table, "version": cal.CALIB_VERSION + 1}))
    assert cal.load_calibration() is None
    monkeypatch.setenv("REPRO_TORCH_CALIB", "default")
    assert cal.calibration_path() is None
    monkeypatch.delenv("REPRO_TORCH_CALIB")
    assert cal.calibration_path().endswith("repro_torch/calib.json")


_ASYNC_LOSSY_CASES = [
    ("async", None, ("x", "pod"), {"x": 4, "pod": 2}),
    ("auto", None, ("x", "pod"), {"x": 4, "pod": 2}),
    ("scan", None, ("x", "pod"), {"x": 4, "pod": 2}),
    ("scan", "topk:0.01", ("x", "pod"), {"x": 4, "pod": 2}),
    ("async", "int8", ("x", "pod"), {"x": 4, "pod": 2}),
    ("auto", "blocktopk:0.001", ("data", "pod"), {"data": 2, "pod": 3}),
    ("tree", "int8", ("x",), {"x": 4}),
    ("async", None, ("x", "pod"), {}),
    ("async", "topk:0.25", ("pod",), {"pod": 8}),
]


@pytest.mark.parametrize("layout,lossy,axes,sizes", _ASYNC_LOSSY_CASES)
def test_async_and_lossy_plans_match_jax(layout, lossy, axes, sizes):
    """plan_fold(layout='async' | lossy=, mesh_axes=, axis_sizes=): the JAX
    plan's tiers and their wire bytes and predicted times, the sync-vs-
    async table, the modeled overlap and the dense / lossy DCN bytes."""
    rng = np.random.default_rng(3)
    vals = {"w": rng.normal(size=(5, 64, 48)).astype(np.float32),
            "b": rng.normal(size=(5, 7)).astype(np.float32)}
    got = plan_fold(tm.sum_, _t(vals), mesh_axes=axes, axis_sizes=sizes,
                    layout=layout, lossy=lossy)
    from repro.core import plan_fold as jax_plan_fold
    want = jax_plan_fold(jm.sum_, _j(vals), mesh_axes=axes,
                         axis_sizes=sizes, layout=layout, lossy=lossy)
    assert [t.kind for t in got.tiers] == [t.kind for t in want.tiers]
    assert [t.wire_bytes for t in got.tiers] == \
        [t.wire_bytes for t in want.tiers]
    for g, w in zip(got.tiers, want.tiers):
        assert g.predicted_us == pytest.approx(w.predicted_us, rel=1e-9)
        if g.kind not in ("tree", "scan"):     # the local tiers name ops
            assert g.detail == w.detail
    assert got.lossy == want.lossy
    assert got.overlap_modeled == pytest.approx(want.overlap_modeled,
                                                rel=1e-9)
    assert (got.dense_wire_bytes, got.lossy_wire_bytes) == \
        (want.dense_wire_bytes, want.lossy_wire_bytes)
    assert [c for c, _ in got.plan_candidate_us] == \
        [c for c, _ in want.plan_candidate_us]
    for (_, g), (_, w) in zip(got.plan_candidate_us, want.plan_candidate_us):
        assert g == pytest.approx(w, rel=1e-9)
    assert got.predicted_us == pytest.approx(want.predicted_us, rel=1e-9)
    assert got.shuffle_candidate_us.keys() == want.shuffle_candidate_us.keys()


@pytest.mark.parametrize("kw", [
    dict(lossy="int8", segment_ids=True), dict(lossy="topk:0.1", monoid="max"),
    dict(layout="async", segment_ids=True), dict(lossy="zip")])
def test_async_and_lossy_refusals_match_jax(kw):
    kw = dict(kw)
    name = kw.pop("monoid", "sum_")
    name = name if name.endswith("_") else name + "_"
    keyed = kw.pop("segment_ids", False)
    vals = np.ones((4, 3), np.float32)
    ids = np.arange(4, dtype=np.int32) % 2
    t_seg = dict(segment_ids=torch.from_numpy(ids), num_segments=2) \
        if keyed else {}
    j_seg = dict(segment_ids=jnp.asarray(ids), num_segments=2) \
        if keyed else {}
    with pytest.raises(ValueError) as t_err:
        plan_fold(getattr(tm, name), torch.from_numpy(vals),
                  mesh_axes=("pod",), **t_seg, **kw)
    from repro.core import plan_fold as jax_plan_fold
    with pytest.raises(ValueError) as j_err:
        jax_plan_fold(getattr(jm, name), jnp.asarray(vals),
                      mesh_axes=("pod",), **j_seg, **kw)
    assert str(t_err.value) == str(j_err.value)


def test_calibration_overlap_model_and_fits_match_jax():
    """pipeline_exposed_us, predict_overlap, fit_tier_coeff, fit_link_coeff
    and fit_overlap_frac: the JAX package's numbers on the same inputs,
    and the shipped link priors (with their overlap_frac) equal."""
    import dataclasses

    from repro.core import calibration as jcal
    from repro_torch.core import calibration as tcal

    for name in ("ici", "dcn"):
        assert dataclasses.asdict(tcal.default_calibration().link_coeff(
            name)) == dataclasses.asdict(
                jcal.default_calibration().link_coeff(name))
    for n, slot, cross in ((0, 5.0, 3.0), (1, 5.0, 3.0), (4, 5.0, 3.0),
                           (4, 1.0, 3.0), (7, -1.0, 2.5), (3, 2.0, 0.0)):
        assert tcal.pipeline_exposed_us(
            num_crossings=n, slot_us=slot, cross_us=cross) == \
            jcal.pipeline_exposed_us(num_crossings=n, slot_us=slot,
                                     cross_us=cross)
    for dom in ("ici", "dcn"):
        for n, slot, wire in ((1, 10.0, 1e5), (4, 50.0, 2e6),
                              (8, 1e4, 3e5), (2, 0.0, 0.0)):
            assert tcal.predict_overlap(
                tcal.default_calibration(), dom, num_crossings=n,
                slot_us=slot, wire_bytes=wire) == pytest.approx(
                jcal.predict_overlap(jcal.default_calibration(), dom,
                                     num_crossings=n, slot_us=slot,
                                     wire_bytes=wire), rel=1e-12)
    kw = dict(n1=100, b1=8, t11_us=12.0, n2=1000, t21_us=40.0, b2=64,
              t22_us=90.0)
    assert dataclasses.asdict(tcal.fit_tier_coeff(**kw)) == \
        dataclasses.asdict(jcal.fit_tier_coeff(**kw))
    kw = dict(bytes1=1 << 10, t1_us=20.0, bytes2=1 << 20, t2_us=900.0,
              overlap_frac=0.4)
    assert dataclasses.asdict(tcal.fit_link_coeff(**kw)) == \
        dataclasses.asdict(jcal.fit_link_coeff(**kw))
    for t in ((100.0, 60.0, 20.0), (100.0, 120.0, 20.0), (10.0, 5.0, 30.0),
              (100.0, 10.0, 20.0)):
        kw = dict(zip(("t_serial_us", "t_dbuf_us", "t_compute_us"), t))
        assert tcal.fit_overlap_frac(**kw) == jcal.fit_overlap_frac(**kw)
    for mod in (tcal, jcal):
        with pytest.raises(ValueError):
            mod.fit_tier_coeff(n1=5, b1=1, t11_us=1.0, n2=5, t21_us=1.0,
                               b2=2, t22_us=1.0)
        with pytest.raises(ValueError):
            mod.fit_link_coeff(bytes1=5, t1_us=1.0, bytes2=5, t2_us=1.0)
    # the overlap coefficient round-trips through the JSON table
    table = tcal.Calibration.from_json(tcal.default_calibration().to_json())
    assert table.link_coeff("dcn").overlap_frac == 0.75


def test_async_refuses_a_valid_mask_as_jax_does():
    """execute_fold(layout='async', valid_mask=) raises before any
    collective, with the reference's message."""
    vals = np.ones((4, 3), np.float32)
    mask = np.array([True, False, True, True])
    with pytest.raises(ValueError) as t_err:
        execute_fold(tm.sum_, torch.from_numpy(vals), mesh_axes=("pod",),
                     layout="async", valid_mask=torch.from_numpy(mask))
    with pytest.raises(ValueError) as j_err:
        jax_execute_fold(jm.sum_, jnp.asarray(vals), mesh_axes=("pod",),
                         layout="async", valid_mask=jnp.asarray(mask))
    assert str(t_err.value) == str(j_err.value)
    assert "valid_mask" in str(t_err.value)
