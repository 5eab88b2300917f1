"""The port's radix prefix KV cache vs the JAX package's, and its engine
path on a toy backend.

* The trie and its monoid bookkeeping: the port's ``PrefixCache`` and the
  reference's, driven by one ``ManualClock`` through the same random
  traces of lookups, inserts, evictions and clock steps (hypothesis, as
  ``tests/test_prefix_cache.py`` drives the reference), agree on every
  lookup, node id and eviction, on ``stats`` field for field, on the bytes
  and hits columns of the folded table exactly, and on the decayed scores
  within 1e-6 relative (the two frameworks' float32 ``exp``).
* Twins of the reference's ``TestEnginePrefix`` on a torch toy backend
  (the reference's toy LM, which has no ``prefill``: the engine runs its
  decode loop from each row's prefix length): a warm hit decodes bit for
  bit as the cold request, partial hits, batched admission, mixed buckets,
  the compile bound over a churny trace, the non-positional opt-out and
  exact byte accounting under churn.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _hyp import HAVE_HYPOTHESIS, given, settings, st  # noqa: F401
from repro.runtime.prefix_cache import PrefixCache as JaxPrefixCache
from repro.runtime.prefix_cache import PrefixCacheConfig as JaxPrefixConfig
from repro_torch.core.calibration import default_calibration, use_calibration
from repro_torch.models.attention import cache_row_update, decode_positions
from repro_torch.serving import (ContinuousEngine, EngineBackend, PrefixCache,
                                 PrefixCacheConfig, PrefixCacheStats,
                                 ServeConfig, StreamEvent)

BLOCK = 2
VOCAB = 13
TOY_SEQ = 32


@pytest.fixture(autouse=True)
def _shipped_calibration():
    with use_calibration(default_calibration()):
        yield


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def jax_payload(prompt, block=BLOCK):
    """The reference test's payload: block i IS the token block."""
    return lambda i: [np.asarray(prompt[i * block:(i + 1) * block],
                                 np.int64)]


def port_payload(prompt, block=BLOCK):
    return lambda i: [torch.tensor(prompt[i * block:(i + 1) * block],
                                   dtype=torch.int64)]


def _pair(clock, **kw):
    return (JaxPrefixCache(JaxPrefixConfig(**kw), clock=clock),
            PrefixCache(PrefixCacheConfig(**kw), clock=clock))


def _assert_same_state(jc, tc):
    """Same trie, same stats, same folded table."""
    assert tc.node_count == jc.node_count
    assert tc.total_bytes == jc.total_bytes
    assert sorted(tc._nodes) == sorted(jc._nodes)
    assert dataclasses.asdict(tc.stats) == dataclasses.asdict(jc.stats)
    jt, tt = jc.table(), tc.table()
    for col in ("bytes", "hits"):
        np.testing.assert_array_equal(tt[col].numpy(), np.asarray(jt[col]))
    np.testing.assert_array_equal(tt["score"][1].numpy(),
                                  np.asarray(jt["score"][1]))
    np.testing.assert_allclose(tt["score"][0].numpy(),
                               np.asarray(jt["score"][0]), rtol=1e-6)
    assert tc.accounted_bytes() == jc.accounted_bytes() == tc.total_bytes


def _assert_same_hit(jh, th, prompt):
    assert th.length == jh.length
    assert th.node_ids == jh.node_ids
    assert th.nbytes == jh.nbytes
    for i, (tb, jb) in enumerate(zip(th.blocks, jh.blocks)):
        np.testing.assert_array_equal(tb[0].numpy(), jb[0])
        assert tb[0].tolist() == list(prompt[i * BLOCK:(i + 1) * BLOCK])


def _drive(ops, *, capacity, half_life, max_bytes=None, events_per_fold=64):
    clock = ManualClock()
    jc, tc = _pair(clock, block=BLOCK, capacity=capacity,
                   half_life_s=half_life, max_bytes=max_bytes,
                   events_per_fold=events_per_fold)
    for op, arg in ops:
        if op == "tick":
            clock.t += arg
        elif op == "lookup":
            _assert_same_hit(jc.lookup(arg), tc.lookup(arg), arg)
        elif op == "insert":
            assert tc.insert(arg, port_payload(arg)) == \
                jc.insert(arg, jax_payload(arg))
        elif op == "evict":
            assert tc.evict(arg) == jc.evict(arg)
        assert sorted(tc._nodes) == sorted(jc._nodes)
        assert tc._free == jc._free
    _assert_same_state(jc, tc)
    np.testing.assert_allclose(tc.scores(clock.t + 3.0),
                               jc.scores(clock.t + 3.0), rtol=1e-6)
    return jc, tc


_PROMPTS = st.lists(st.integers(0, 2), min_size=1, max_size=9)
_OPS = st.lists(st.one_of(
    st.tuples(st.just("tick"), st.sampled_from([0.0, 0.5, 3.0, 40.0])),
    st.tuples(st.just("lookup"), _PROMPTS),
    st.tuples(st.just("insert"), _PROMPTS),
    st.tuples(st.just("evict"), st.integers(1, 2))), min_size=1, max_size=24)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=30, deadline=None)
@given(_OPS)
def test_trie_and_stats_match_jax_on_random_traces(ops):
    """Capacity 6 and a 10 s half life: evictions happen, and their order
    follows the decayed scores (recency against frequency)."""
    _drive(ops, capacity=6, half_life=10.0, events_per_fold=4)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=20, deadline=None)
@given(_OPS)
def test_byte_budget_matches_jax_on_random_traces(ops):
    """A byte budget of three int64 blocks evicts by bytes, not capacity."""
    _drive(ops, capacity=64, half_life=1e6, max_bytes=3 * BLOCK * 8)


@pytest.mark.parametrize("half_life", [1e6, 10.0])
def test_eviction_order_matches_jax(half_life):
    """The reference's two eviction-order cases on both caches: at a near-
    infinite half life the score is the touch count (A < B < C); at 10 s a
    fresh single touch beats six stale ones."""
    ops = [("insert", [1, 1]), ("insert", [2, 2]), ("insert", [3, 3]),
           ("tick", 10.0), ("lookup", [2, 2, 0])] + \
        [("lookup", [3, 3, 0])] * 3 + [("tick", 100.0),
                                       ("insert", [4, 4])] + \
        [("evict", 1), ("lookup", [1, 1, 0]), ("evict", 1),
         ("lookup", [2, 2, 0]), ("lookup", [3, 3, 0]), ("lookup", [4, 4, 0])]
    jc, tc = _drive(ops, capacity=8, half_life=half_life)
    assert tc.stats.evictions == 2


def test_lookup_is_longest_strict_block_prefix():
    c = PrefixCache(PrefixCacheConfig(block=BLOCK, capacity=64))
    for p in ([1, 2, 3, 4, 5], [1, 2, 3, 9], [7, 8]):
        c.insert(p, port_payload(p))
    for prompt, want in (([1, 2, 3, 4, 5, 6], 4), ([1, 2, 3, 9, 9], 4),
                         ([1, 2], 0), ([7, 8, 1], 2), ([1, 2, 3], 2)):
        hit = c.lookup(prompt)
        assert hit.length == want, prompt
        assert len(hit.blocks) == len(hit.node_ids) == want // BLOCK


def test_capacity_eviction_protects_insert_path():
    c = PrefixCache(PrefixCacheConfig(block=BLOCK, capacity=2))
    c.insert([1, 2, 3, 4], port_payload([1, 2, 3, 4]))
    c.insert([5, 6, 7, 8], port_payload([5, 6, 7, 8]))
    assert c.lookup([5, 6, 7, 8, 9]).length == 2 * BLOCK
    assert c.node_count == 2
    assert c.accounted_bytes() == c.total_bytes


def test_one_fold_per_flush_and_compile_counts():
    c = PrefixCache(PrefixCacheConfig(block=BLOCK, capacity=8,
                                      events_per_fold=4))
    for p in ([1, 2], [3, 4], [5, 6]):
        c.insert(p, port_payload(p))
    assert c.flush_stats() == 1                  # 3 events, one chunk
    for p in ([1, 2, 9], [3, 4, 9], [5, 6, 9], [1, 2, 8], [3, 4, 8]):
        c.lookup(p)
    assert c.flush_stats() == 2                  # 5 events, two chunks
    assert c.compile_counts() == {"prefix_stats_fold": 1,
                                  "prefix_row_reset": 0}
    assert c.flush_stats() == 0
    c.evict(1)
    assert c.compile_counts()["prefix_row_reset"] == 1
    assert c.stats.fold_rows == 8 and c.stats.folds == 3


def test_stats_fold_takes_the_references_scan_tier():
    """cache_stats is a product monoid with a decayed column: no kernel
    lowering and no scatter reduction, so the planner takes the serial
    scan tier, as the reference's does."""
    from repro.core import monoids as jm
    from repro.core.plan import plan_fold as jax_plan_fold
    from repro_torch.core import monoids as tm
    from repro_torch.core.plan import plan_fold
    import jax
    import jax.numpy as jnp

    E, C = 64, 256
    rows = {"bytes": torch.zeros(E), "hits": torch.zeros(E),
            "score": (torch.zeros(E), torch.zeros(E))}
    got = plan_fold(tm.cache_stats(60.0), rows,
                    segment_ids=torch.zeros(E, dtype=torch.int32),
                    num_segments=C, valid_mask=torch.ones(E, dtype=torch.bool))
    f32 = jax.ShapeDtypeStruct((E,), jnp.float32)
    want = jax_plan_fold(
        jm.cache_stats(60.0), {"bytes": f32, "hits": f32, "score": (f32, f32)},
        segment_ids=jax.ShapeDtypeStruct((E,), jnp.int32), num_segments=C,
        valid_mask=jax.ShapeDtypeStruct((E,), jnp.bool_))
    assert got.local_tier.kind == want.local_tier.kind == "scan"


def test_decayed_value_matches_jax():
    from repro.core import monoids as jm
    from repro_torch.core import monoids as tm

    v = np.array([0.0, 1.5, 3.0, 2.0], np.float32)
    t = np.array([-np.inf, -4.0, 2.5, 7.0], np.float32)
    for now in (7.0, 30.0):
        got = tm.decayed_value((torch.from_numpy(v), torch.from_numpy(t)),
                               now, 16.0)
        want = jm.decayed_value((v, t), now, 16.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got[0]) == 0.0                  # the identity decays to 0


# ---------------------------------------------------------------------------
# the engine on the toy backend (the reference's TestEnginePrefix twins)
# ---------------------------------------------------------------------------

def toy_decode(params, cache, cur):
    """The reference's toy LM: position- and history-dependent, per row,
    reading only history at positions <= its own pos."""
    batch = cur.shape[0]
    pos = cache["pos"]
    posb = decode_positions(pos, batch)[:, 0].long()
    hist = cache_row_update(cache["hist"], cur, pos)
    valid = torch.arange(hist.shape[1])[None, :] <= posb[:, None]
    s = torch.sum(hist * valid, dim=1)
    tgt = (s * params["a"] + posb * params["b"]) % VOCAB
    logits = 5.0 * torch.nn.functional.one_hot(tgt, VOCAB) + \
        0.01 * torch.arange(VOCAB)
    return logits.to(torch.float32), {"pos": pos + 1, "hist": hist}


def toy_init_cache(batch, pos_per_slot):
    pos0 = torch.zeros((batch,) if pos_per_slot else (), dtype=torch.int32)
    return {"pos": pos0, "hist": torch.zeros((batch, TOY_SEQ),
                                             dtype=torch.int32)}


def toy_backend():
    return EngineBackend(decode=toy_decode, init_cache=toy_init_cache,
                         params={"a": 3, "b": 7}, vocab_size=VOCAB,
                         device=torch.device("cpu"))


def toy_engine(**overrides):
    kw = dict(num_slots=2, prefill_buckets=(4, 8), max_new_tokens=6,
              eos_id=-7)        # eos unreachable: retirement is budget-driven
    kw.update(overrides)
    return ContinuousEngine(toy_backend(), ServeConfig(**kw))


def drain(engine, max_steps=200):
    return list(engine.run(max_steps=max_steps))


def solo_result(prompt, seed, **overrides):
    eng = toy_engine(num_slots=1, **overrides)
    uid = eng.submit(prompt, seed=seed)
    drain(eng)
    return eng.result(uid)


def test_prefix_cache_is_on_by_default():
    cfg = ServeConfig()
    assert cfg.prefix_cache and cfg.prefix_slab == 28
    eng = toy_engine()
    assert eng.prefix is not None and eng.prefix.stats == PrefixCacheStats()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_warm_hit_bit_identical_to_cold(temperature):
    p = [1, 2, 3, 4, 5, 6, 7]
    warm = toy_engine(num_slots=1, prefix_block=2, temperature=temperature)
    cold = toy_engine(num_slots=1, prefix_cache=False,
                      temperature=temperature)
    u1 = warm.submit(p, seed=5)
    drain(warm)
    u2 = warm.submit(p, seed=5)          # second pass hits the trie
    evs = drain(warm)
    uc = cold.submit(p, seed=5)
    drain(cold)
    assert warm.prefix.stats.hits == 1
    assert warm.result(u2).bucket < cold.result(uc).bucket  # suffix bucket
    for uid in (u1, u2):
        got, ref = warm.result(uid), cold.result(uc)
        assert got.tokens == ref.tokens
        assert got.logprob_sum == ref.logprob_sum            # bitwise
        assert got.stopped == ref.stopped
    cache_ev = [e for e in evs if e.kind == "cache"]
    assert len(cache_ev) == 1 and isinstance(cache_ev[0], StreamEvent)
    assert (cache_ev[0].hit_tokens, cache_ev[0].prompt_tokens) == (6, 7)
    assert cache_ev[0].bytes_saved == 6 * 4      # six int32 history rows


def test_partial_hit_and_divergent_suffix():
    warm = toy_engine(num_slots=1, prefix_block=2)
    cold = toy_engine(num_slots=1, prefix_cache=False)
    a, b = [1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 9, 9, 9]
    warm.submit(a, seed=1)
    drain(warm)
    u = warm.submit(b, seed=2)           # hits the shared 4-token prefix
    drain(warm)
    uc = cold.submit(b, seed=2)
    drain(cold)
    assert warm.prefix.stats.hit_tokens == 4
    assert warm.result(u).tokens == cold.result(uc).tokens
    assert warm.result(u).logprob_sum == cold.result(uc).logprob_sum


def test_batched_admission_one_prefill_program():
    eng = toy_engine(num_slots=4, prefill_batch=4)
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 1]]
    uids = [eng.submit(p, seed=20 + i) for i, p in enumerate(prompts)]
    evs = eng.step()
    assert eng.stats.prefill_calls == 1              # ONE (4, bucket) call
    assert eng.stats.batched_admissions == 4
    assert len([e for e in evs
                if e.kind == "token" and e.index == 0]) == 4
    drain(eng)
    for i, (p, uid) in enumerate(zip(prompts, uids)):
        ref = solo_result(p, 20 + i)
        got = eng.result(uid)
        assert got.tokens == ref.tokens
        assert got.logprob_sum == ref.logprob_sum
    assert eng.compile_counts()["prefill_k4_b4"] == 1


def test_batched_warm_admissions_share_one_prefill():
    """Four hits of different prefix lengths in ONE (4, bucket) call, each
    bit for bit its cold twin."""
    shared = [3, 1, 4, 1, 5, 9]
    eng = toy_engine(num_slots=4, prefill_batch=4, prefix_block=2,
                     prefill_buckets=(4, 8, 16))
    eng.submit(shared + [2, 6], seed=1)
    drain(eng)
    prompts = [shared + [7], shared[:4] + [8, 8], shared[:2] + [9, 9, 9],
               shared + [5, 3, 5]]
    uids = [eng.submit(p, seed=30 + i) for i, p in enumerate(prompts)]
    calls = eng.stats.prefill_calls
    eng.step()
    assert eng.stats.prefill_calls == calls + 1
    drain(eng)
    assert eng.prefix.stats.hit_tokens == 6 + 4 + 2 + 6
    for i, (p, uid) in enumerate(zip(prompts, uids)):
        ref = solo_result(p, 30 + i, prefix_cache=False,
                          prefill_buckets=(4, 8, 16))
        assert eng.result(uid).tokens == ref.tokens
        assert eng.result(uid).logprob_sum == ref.logprob_sum


def test_mixed_buckets_group_separately():
    eng = toy_engine(num_slots=4, prefill_batch=4, prefix_cache=False)
    for p in ([1, 2], [3, 4], [1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]):
        eng.submit(p)
    eng.step()
    assert eng.stats.prefill_calls == 2              # one per bucket
    assert eng.stats.batched_admissions == 4


def test_compile_bound_over_churny_warm_trace():
    eng = toy_engine(num_slots=3, prefill_buckets=(2, 4, 8),
                     prefill_batch=2, prefix_block=2)
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 12, 6).tolist()
    for _ in range(14):
        if rng.random() < 0.6:
            extra = rng.integers(1, 12, int(rng.integers(1, 3))).tolist()
            p = shared + extra
        else:
            p = rng.integers(1, 12, int(rng.integers(1, 9))).tolist()
        eng.submit(p, max_new_tokens=int(rng.integers(1, 6)))
    drain(eng, max_steps=500)
    assert eng.prefix.stats.hits > 0
    counts = eng.compile_counts()
    for key, n in counts.items():
        assert n <= 1, (key, n)
    assert counts["gather_k1"] == 1 and counts["prefix_stats_fold"] == 1
    assert sum(counts.values()) <= eng.compile_bound() == 1 + 2 * 3 + 2 + 4


def test_prefix_disabled_on_non_positional_backend():
    backend = toy_backend()
    backend.prefix_sharing = False
    eng = ContinuousEngine(backend, ServeConfig(
        num_slots=2, prefill_buckets=(4, 8), max_new_tokens=4, eos_id=-7))
    assert eng.prefix is None
    u = eng.submit([1, 2, 3])
    evs = drain(eng)
    assert len(eng.result(u).tokens) == 4
    assert not [e for e in evs if e.kind == "cache"]
    assert eng.compile_bound() == 1 + 2 + 1


def test_accounting_stays_exact_under_engine_churn():
    eng = toy_engine(num_slots=2, prefix_block=2, prefix_capacity=4)
    rng = np.random.default_rng(3)
    for _ in range(10):
        eng.submit(rng.integers(1, 12, int(rng.integers(2, 8))).tolist())
    drain(eng, max_steps=500)
    assert eng.prefix.stats.evictions > 0            # capacity 4 churns
    assert eng.prefix.accounted_bytes() == eng.prefix.total_bytes
    assert eng.compile_counts()["prefix_row_reset"] == 1
