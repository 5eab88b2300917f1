"""The port's streaming windows vs the JAX package's ``repro.data.windows``.

The same numpy-seeded events go through both packages:

* ``SlidingWindow`` over the zoo (sum, max, mean, CMS, HLL and a
  non-commutative 2x2 matrix product): every query, and the flip-combine
  count, equal the reference's: bit for bit for the integer sketches, max
  and the integer-valued float sums; float means and matrix products at the
  reference tests' rtol = atol = 1e-5.
* ``TumblingWindow`` (closed windows, bounds, values, time travel rejected),
  ``tumbling_ids`` (float32 floor, edge timestamps included) and
  ``tumbling_fold`` (out-of-range events and a caller mask) bit for bit.
* ``sessionize`` ids and counts equal; ``session_fold`` bit for bit.
* ``WindowedMetrics`` fed the same stream events: per-user windows, token
  rates, fleet tokens and fleet prefix counters at 1e-5; and the same
  consumer on the port's engine.
* The slice as a whole: path 4 of the port's streaming example prints the
  JAX example's lines; ``core.segment_fold(impl=)`` and ``set_calibration``.
"""
import contextlib
import io
import re
import runpy
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import monoids as jm
from repro.core.monoid import Monoid as JaxMonoid
from repro.core.plan import segment_fold as jax_segment_fold
from repro.data import windows as jw
from repro.runtime.engine import RequestResult as JaxRequestResult
from repro.runtime.engine import StreamEvent as JaxStreamEvent
from repro_torch.core import monoids as tm
from repro_torch.core import (default_calibration, get_calibration,
                              segment_fold, set_calibration, use_calibration)
from repro_torch.core.monoid import Monoid
from repro_torch.data import (SlidingWindow, TumblingWindow, WindowedMetrics,
                              WindowResult, session_fold, sessionize,
                              tumbling_fold, tumbling_ids)
from repro_torch.serving import RequestResult, StreamEvent

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _shipped_calibration():
    with use_calibration(default_calibration()):
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [_np(tree)]


def assert_same(got, want, exact, rtol=1e-5, atol=1e-5):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.shape == w.shape
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the zoo: (port monoid, JAX monoid, raw items, exact?)
# ---------------------------------------------------------------------------

def _mat2_pair():
    def jid(*, example=None):
        return jnp.eye(2, dtype=jnp.float32)

    def tid(*, example=None):
        return torch.eye(2, dtype=torch.float32)
    return (Monoid(name="mat2", combine=lambda a, b: a @ b, identity_fn=tid,
                   commutative=False),
            JaxMonoid(name="mat2", combine=lambda a, b: a @ b,
                      identity_fn=jid, commutative=False))


def _items(name, rng, n):
    if name in ("cms", "hll"):
        return rng.integers(0, 100, n).astype(np.int32)
    if name == "mat2":
        a = rng.integers(-3, 4, n).astype(np.float32)
        out = np.zeros((n, 2, 2), np.float32)
        out[:, 0, 0] = out[:, 1, 1] = 1.0
        out[0::2, 0, 1] = a[0::2]
        out[1::2, 1, 0] = a[1::2]
        return out
    if name == "mean":
        return rng.normal(size=n).astype(np.float32)
    return rng.integers(-8, 8, n).astype(np.float32)


ZOO = {
    "sum": (lambda: (tm.sum_, jm.sum_), True),
    "max": (lambda: (tm.max_, jm.max_), True),
    "mean": (lambda: (tm.mean, jm.mean), False),
    "cms": (lambda: (tm.count_min(2, 64), jm.count_min(2, 64)), True),
    "hll": (lambda: (tm.hyperloglog(4), jm.hyperloglog(4)), True),
    "mat2": (_mat2_pair, False),
}


@pytest.mark.parametrize("size", [1, 3, 7])
@pytest.mark.parametrize("name", sorted(ZOO))
def test_sliding_window_matches_jax(name, size):
    (tmono, jmono), exact = ZOO[name][0](), ZOO[name][1]
    items = _items(name, np.random.default_rng(len(name) * 10 + size), 19)
    tw = SlidingWindow(tmono, size, device="cpu")
    jwin = jw.SlidingWindow(jmono, size)
    for x in items:
        tw.push(torch.from_numpy(np.array(x)), lifted=False)
        jwin.push(jnp.asarray(x), lifted=False)
        assert len(tw) == len(jwin)
        assert_same(tw.query(), jwin.query(), exact)
    assert (tw.pushes, tw.flip_combines) == (jwin.pushes, jwin.flip_combines)
    assert tw.flip_combines <= tw.pushes
    # HLL's extract is a float estimate from the (equal) registers
    assert_same(tw.extract(), jwin.extract(), exact and name != "hll")


def test_sliding_window_identity_and_errors():
    w = SlidingWindow(tm.sum_, 3, example=torch.zeros(()), device="cpu")
    assert float(w.query()) == 0.0                 # the identity when empty
    with pytest.raises(ValueError):
        SlidingWindow(tm.sum_, 3, device="cpu").query()
    with pytest.raises(ValueError):
        SlidingWindow(tm.sum_, 0, device="cpu")
    with pytest.raises(ValueError):
        SlidingWindow(tm.sum_, 2, example=torch.zeros(()),
                      device="cpu").evict()
    for v in (1.0, 2.0, 3.0, 4.0):
        w.push(torch.tensor(v))
    assert float(w.query()) == 9.0 and len(w) == 3


def test_window_classes_run_on_the_card_unless_asked_for_the_cpu():
    """The default device is cuda; without a card asking for it raises
    (no silent CPU fallback)."""
    if torch.cuda.is_available():
        assert SlidingWindow(tm.sum_, 2).device.type == "cuda"
        return
    for make in (lambda: SlidingWindow(tm.sum_, 2),
                 lambda: TumblingWindow(tm.sum_, 1.0),
                 lambda: WindowedMetrics(),
                 lambda: tumbling_ids(np.zeros(3), width=1.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# tumbling windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_tumbling_stream_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.0, 12.0, 60))
    vals = rng.integers(-10, 10, 60).astype(np.float32)
    tw = TumblingWindow(tm.sum_, 2.0, t0=0.5, device="cpu")
    jwt = jw.TumblingWindow(jm.sum_, 2.0, t0=0.5)
    got, want = [], []
    for v, t in zip(vals, ts):
        got += tw.push(torch.tensor(v), float(t))
        want += jwt.push(jnp.asarray(v), float(t))
    got += tw.flush()
    want += jwt.flush()
    assert tw.flush() == [] and tw.events == jwt.events == 60
    assert [(r.index, r.start, r.end) for r in got] == \
        [(r.index, r.start, r.end) for r in want]
    for a, b in zip(got, want):
        assert isinstance(a, WindowResult)
        assert_same(a.value, b.value, exact=True)


def test_tumbling_rejects_time_travel():
    tw = TumblingWindow(tm.sum_, 1.0, device="cpu")
    tw.push(torch.tensor(1.0), 5.0)
    with pytest.raises(ValueError, match="time-ordered"):
        tw.push(torch.tensor(1.0), 3.0)
    with pytest.raises(ValueError):
        TumblingWindow(tm.sum_, 0.0, device="cpu")


def test_tumbling_ids_match_jax_float32_floor():
    rng = np.random.default_rng(3)
    width = 0.1
    # timestamps on and around window edges, where float32 rounding decides
    edges = np.arange(-3, 40) * width
    ts = np.concatenate([edges, np.nextafter(edges, np.inf),
                         np.nextafter(edges, -np.inf),
                         rng.uniform(-1.0, 5.0, 200)])
    got = tumbling_ids(ts, width=width, t0=0.05, device="cpu")
    assert got.dtype == torch.int32
    want = np.asarray(jw.tumbling_ids(ts, width=width, t0=0.05))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,dtype", [
    ("sum_", np.float32), ("sum_", np.int32), ("max_", np.float32),
    ("min_", np.int32)])
def test_tumbling_fold_matches_jax(name, dtype):
    """One keyed fold; events outside [t0, t0 + num_windows * width) and
    those the caller masks fold nothing."""
    rng = np.random.default_rng(7)
    n = 300
    ts = np.sort(rng.uniform(-1.0, 9.0, n))
    vals = rng.integers(-50, 50, n).astype(dtype)
    mask = rng.random(n) < 0.9
    got, plan = tumbling_fold(getattr(tm, name), torch.from_numpy(vals), ts,
                              width=0.7, num_windows=10, t0=0.2,
                              valid_mask=mask, with_plan=True)
    assert plan.num_segments == 10
    want = jw.tumbling_fold(getattr(jm, name), jnp.asarray(vals), ts,
                            width=0.7, num_windows=10, t0=0.2,
                            valid_mask=jnp.asarray(mask))
    assert got.dtype == torch.from_numpy(vals).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tumbling_fold_masks_out_of_range_events():
    vals = torch.tensor([1.0, 10.0, 100.0, 1000.0])
    ts = np.array([-0.5, 0.5, 1.5, 99.0])
    table = tumbling_fold(tm.sum_, vals, ts, width=1.0, num_windows=2)
    np.testing.assert_array_equal(table.numpy(), [10.0, 100.0])
    assert tumbling_ids(ts, width=1.0, device="cpu").tolist() == \
        [-1, 0, 1, 99]


# ---------------------------------------------------------------------------
# sessionization
# ---------------------------------------------------------------------------

def _session_case(seed, n=64, users=4):
    rng = np.random.default_rng(seed)
    us = rng.integers(0, users, n)
    ts = np.cumsum(rng.uniform(0.0, 3.0, n))
    vals = rng.integers(-50, 50, n).astype(np.int32)
    return us, ts, vals


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sessionize_matches_jax(seed):
    us, ts, _ = _session_case(seed, n=200, users=7)
    sids, n = sessionize(us, ts, gap=4.0)
    jsids, jn = jw.sessionize(us, ts, gap=4.0)
    assert sids.dtype == np.int32 and n == jn
    np.testing.assert_array_equal(sids, jsids)


def test_sessionize_gap_boundary_and_validation():
    sids, n = sessionize([7, 7, 7], [0.0, 2.0, 4.0 + 1e-9], gap=2.0)
    assert sids.tolist() == [0, 0, 1] and n == 2
    with pytest.raises(ValueError):
        sessionize([1, 1], [2.0, 1.0], gap=1.0)
    with pytest.raises(ValueError):
        sessionize([[1]], [1.0], gap=1.0)


@pytest.mark.parametrize("seed", [3, 4])
def test_session_fold_matches_jax_bit_for_bit(seed):
    us, ts, vals = _session_case(seed)
    sids, n = sessionize(us, ts, gap=4.0)
    got = session_fold(tm.sum_, torch.from_numpy(vals), sids, n)
    want = jw.session_fold(jm.sum_, jnp.asarray(vals), sids, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = np.arange(len(vals)) % 3 != 0
    got = session_fold(tm.max_, torch.from_numpy(vals), sids, n,
                       valid_mask=mask)
    want = jw.session_fold(jm.max_, jnp.asarray(vals), sids, n,
                           valid_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_session_fold_across_hosts_is_the_mesh_tier():
    """``mesh_axes=`` passes through to the planner's mesh tier (held on an
    8-rank world in tests/test_torch_dist.py); with no mesh bound the axis
    is refused by name."""
    sids, n = sessionize([0, 1, 0], [0.0, 1.0, 2.0], gap=5.0)
    with pytest.raises(ValueError, match="'data' is not bound"):
        session_fold(tm.sum_, torch.ones(3), sids, n, mesh_axes=("data",))


# ---------------------------------------------------------------------------
# WindowedMetrics
# ---------------------------------------------------------------------------

def _events(seed, n=80):
    """One stream of (kind, user, t, payload) for both packages."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.uniform(0.0, 0.3))
        kind = ("token", "done", "cache")[int(rng.choice(3, p=[.7, .2, .1]))]
        user = int(rng.integers(0, 3))
        if kind == "done":
            payload = (float(rng.uniform(0.1, 2.0)), float(rng.uniform(0, .1)),
                       int(rng.integers(1, 9)))
        elif kind == "cache":
            prompt = int(rng.integers(4, 40))
            payload = (int(rng.integers(0, prompt)), prompt,
                       int(rng.integers(0, 5000)))
        else:
            payload = None
        out.append((kind, user, t, payload))
    return out


def _event(pkg, kind, user, t, payload):
    Event, Result = ((StreamEvent, RequestResult) if pkg == "port"
                     else (JaxStreamEvent, JaxRequestResult))
    kw = {}
    if kind == "done":
        latency, ttft, ntok = payload
        kw["result"] = Result(uid=0, slot=0, prompt_len=1, bucket=4,
                              user=user, tokens=list(range(ntok)),
                              logprob_sum=0.0, stopped=True, stop_step=1,
                              ttft_s=ttft, latency_s=latency)
    elif kind == "cache":
        kw.update(hit_tokens=payload[0], prompt_tokens=payload[1],
                  bytes_saved=payload[2])
    return Event(uid=0, kind=kind, slot=0, step=0, time_s=t, user=user, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_windowed_metrics_match_jax(seed):
    port = WindowedMetrics(window=3, half_life_s=2.0, tumble_s=0.5,
                           device="cpu")
    ref = jw.WindowedMetrics(window=3, half_life_s=2.0, tumble_s=0.5)
    for ev in _events(seed):
        port.observe(_event("port", *ev))
        ref.observe(_event("jax", *ev))
    assert port.events == ref.events
    assert port.users() == ref.users()
    assert [r.index for r in port.closed_fleet_windows] == \
        [r.index for r in ref.closed_fleet_windows]
    now = 30.0
    got, want = port.summary(now), ref.summary(now)
    assert got.keys() == want.keys()
    for u in got:
        assert got[u]["requests"] == want[u]["requests"]
        for k in ("latency_s", "ttft_s", "tokens", "token_rate"):
            assert got[u][k] == pytest.approx(want[u][k], rel=1e-5,
                                              abs=1e-5), (u, k)
    # the reference's fleet queries close the open window: ask it once,
    # after the port's (which reads it), and compare
    fp = port.fleet_prefix()
    tokens = port.fleet_tokens()
    assert tokens == ref.fleet_tokens()
    jfp = ref.fleet_prefix()
    for k in fp:
        assert fp[k] == pytest.approx(jfp[k], rel=1e-6)


def test_windowed_metrics_semantics():
    m = WindowedMetrics(window=2, half_life_s=60.0, tumble_s=1.0,
                        device="cpu")
    m.observe(_event("port", "token", 1, 0.0, None))
    m.observe(_event("port", "token", 1, 60.0, None))
    assert np.isclose(m.user_token_rate(1, 60.0), 1.5)      # one half-life
    assert m.user_token_rate(2, 60.0) == 0.0
    for t, lat, ttft, n in ((1.0, .4, .1, 3), (2.0, .2, .3, 5),
                            (3.0, .6, .5, 7)):
        m.observe(_event("port", "done", 1, t, (lat, ttft, n)))
    row = m.user_window(1)                # window=2: only the last two
    assert row["requests"] == 2
    assert np.isclose(row["latency_s"], 0.4)
    assert np.isclose(row["ttft_s"], 0.4)
    assert np.isclose(row["tokens"], 6.0)
    assert m.user_window(5)["requests"] == 0
    # fleet queries read the open window and leave it open
    assert m.fleet_tokens() == 2.0 and m.fleet_tokens() == 2.0
    m.observe(_event("port", "token", 1, 60.5, None))
    assert m.fleet_tokens() == 3.0
    assert m.fleet_prefix() == {"hit_tokens": 0.0, "prompt_tokens": 0.0,
                                "bytes_saved": 0.0, "hit_rate": 0.0}


def test_windowed_metrics_consume_the_ports_engine_events():
    """Every engine stream event folds into the consumer: fleet tokens ==
    generated tokens, users partition the requests, the per-user mean
    tokens equal the results'."""
    from test_torch_prefix_cache import drain, toy_engine

    metrics = WindowedMetrics(window=4, half_life_s=60.0, tumble_s=0.5,
                              device="cpu")
    eng = toy_engine(num_slots=2)
    eng.subscribe(metrics.observe)
    uids = {i: eng.submit([1 + i, 2, 3], user=i % 2) for i in range(5)}
    drain(eng)
    total = sum(len(eng.result(u).tokens) for u in uids.values())
    assert metrics.fleet_tokens() == total
    assert metrics.events == total + 2 * len(uids)   # + done + cache each
    assert metrics.users() == [0, 1]
    summary = metrics.summary(now=time.perf_counter())
    assert summary[0]["requests"] == 3 and summary[1]["requests"] == 2
    for u in (0, 1):
        assert summary[u]["token_rate"] > 0
        assert summary[u]["latency_s"] >= summary[u]["ttft_s"] >= 0
    want = np.mean([len(eng.result(uids[i]).tokens) for i in (0, 2, 4)])
    assert np.isclose(summary[0]["tokens"], want)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _path_4(text):
    keep = [line.strip() for line in text.splitlines()
            if re.match(r"\s*(sliding window|tumbling windows|decayed "
                        r"activity|sessionized)", line)]
    assert len(keep) == 4, text
    return keep


def test_streaming_example_path_4_matches_the_jax_example():
    from repro_torch.examples import streaming_analytics

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = streaming_analytics.main(["--device", "cpu"])
    port_out = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / "streaming_analytics.py"),
                       run_name="__main__")
    assert _path_4(port_out) == _path_4(buf.getvalue())
    assert result["tumbling"].sum() == result["sessions"].sum()


@pytest.mark.parametrize("impl", ["auto", "onehot", "scan"])
@pytest.mark.parametrize("name", ["sum_", "mean"])
def test_legacy_segment_fold_matches_jax(impl, name):
    rng = np.random.default_rng(4)
    n, s = 40, 6
    vals = rng.integers(-9, 9, (n, 3)).astype(np.float32)
    # ids outside [0, S) fold nothing on every tier of the port and on the
    # reference's segment and one-hot paths; the reference's scan clamps
    # them onto rows 0 and S - 1 (JAX's out-of-range indexing), so the
    # scan is compared on ids in range
    lo, hi = (0, s) if impl == "scan" else (-1, s + 1)
    ids = rng.integers(lo, hi, n).astype(np.int32)
    tmono, jmono = getattr(tm, name), getattr(jm, name)
    tv, jv = torch.from_numpy(vals), jnp.asarray(vals)
    if name == "mean":
        tv = (tv, torch.ones(n, dtype=torch.int32))
        jv = (jv, jnp.ones(n, jnp.int32))
    got = segment_fold(tmono, tv, torch.from_numpy(ids), s, impl=impl)
    want = jax_segment_fold(jmono, jv, jnp.asarray(ids), s, impl=impl)
    assert_same(got, want, exact=True)
    init = got
    got = segment_fold(tmono, tv, torch.from_numpy(ids), s, impl=impl,
                       init=init)
    want = jax_segment_fold(jmono, jv, jnp.asarray(ids), s, impl=impl,
                            init=want)
    assert_same(got, want, exact=True)


def test_legacy_segment_fold_rejects_what_the_reference_rejects():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="additive"):
        segment_fold(tm.max_, torch.ones(4), ids, 2, impl="onehot")
    with pytest.raises(ValueError, match="unknown impl"):
        segment_fold(tm.sum_, torch.ones(4), ids, 2, impl="pallas")


def test_set_calibration_installs_and_restores():
    calib = default_calibration()
    fake = type(calib)(version=calib.version, backend="test",
                       source="measured", tiers=calib.tiers)
    try:
        set_calibration(fake)
        assert get_calibration() is fake
    finally:
        set_calibration(None)
    assert get_calibration() is not fake
