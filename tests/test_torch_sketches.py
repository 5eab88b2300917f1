"""The port's §3 sketch monoids vs the JAX package's.

The same numpy ids go through both zoos.  ``_uhash`` must be bit-identical
to JAX's uint32 arithmetic (edge ids included), so every sketch result —
count-min tables, HyperLogLog registers, Bloom bits, ``cms_query`` and
``bloom_contains`` — is compared exactly; the HyperLogLog estimate (a float
sum over registers, summed in another order) within rel 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis, or skip-stub when absent

from repro.core import monoids as jm
from repro_torch.core import check_laws
from repro_torch.core import monoids as tm

EDGES = np.array([0, 1, -1, -2 ** 31, 2 ** 31 - 1, 2, 65535, 65536, -65536],
                 np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(12))
def test_uhash_bit_identical(seed):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([EDGES, rng.integers(-2 ** 31, 2 ** 31, 4096,
                                              dtype=np.int64).astype(np.int32)])
    got = tm._uhash(torch.from_numpy(ids), seed)
    want = np.asarray(jm._uhash(jnp.asarray(ids), seed)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    # int64 ids hash their low 32 bits, as JAX's int32 -> uint32 convert
    wide = torch.from_numpy(ids.astype(np.int64))
    assert torch.equal(tm._uhash(wide, seed), got)
    assert torch.equal(tm._uhash(wide + (1 << 32), seed), got)
    assert int(tm._uhash(int(ids[5]), seed)) == int(want[5])


def test_hash_primes_are_the_jax_packages():
    assert [int(p) for p in jm._HASH_PRIMES] == list(tm._HASH_PRIMES)


@pytest.mark.parametrize("bits", [4, 8, 22, 31])
def test_rho_matches(bits):
    rng = np.random.default_rng(bits)
    v = np.concatenate([[0, 1, (1 << bits) - 1, 1 << (bits - 1)],
                        rng.integers(0, 1 << bits, 500)]).astype(np.uint32)
    got = tm._rho(torch.from_numpy(v.astype(np.int64)), bits)
    _eq(got, jm._rho(jnp.asarray(v), bits))


def _factories():
    return [(lambda mod: mod.count_min(3, 64)),
            (lambda mod: mod.hyperloglog(6)),
            (lambda mod: mod.bloom_filter(256, 3))]


@pytest.mark.parametrize("k", range(3), ids=["cms", "hll", "bloom"])
def test_lift_combine_and_laws_match(k):
    make = _factories()[k]
    t, j = make(tm), make(jm)
    assert t.name == j.name
    ids = [int(x) for x in EDGES[:6]]
    t_vals = [t.lift(torch.tensor(x, dtype=torch.int32)) for x in ids]
    j_vals = [j.lift(jnp.int32(x)) for x in ids]
    for a, b in zip(t_vals, j_vals):
        _eq(a, b)
    _eq(t.combine(t_vals[0], t_vals[3]), j.combine(j_vals[0], j_vals[3]))
    _eq(t.identity(), j.identity())
    check_laws(t, t_vals[:3])


@settings(max_examples=6, deadline=None)
@given(st.lists(st.integers(-(1 << 31), (1 << 31) - 1), min_size=3,
                max_size=6))
def test_sketch_laws_on_any_ids(items):
    for make in _factories():
        m = make(tm)
        check_laws(m, [m.lift(torch.tensor(i, dtype=torch.int32))
                       for i in items[:3]])


def test_lift_runs_under_vmap():
    """The planner lifts record batches with torch.func.vmap."""
    from torch.func import vmap
    ids = torch.tensor([3, -7, 11, 2 ** 31 - 1], dtype=torch.int32)
    for make in _factories():
        m = make(tm)
        batched = vmap(m.lift)(ids)
        for i, x in enumerate(ids):
            assert torch.equal(batched[i], m.lift(x))


@pytest.mark.parametrize("weighted", [False, True])
def test_cms_update_batch_and_query_match(weighted):
    rng = np.random.default_rng(5)
    items = np.concatenate([EDGES, rng.integers(-50, 1000, 3000)]
                           ).astype(np.int32)
    weights = rng.integers(0, 2, items.shape[0]).astype(np.int32) \
        if weighted else None
    t0 = torch.from_numpy(rng.integers(0, 9, (4, 256)).astype(np.int32))
    got = tm.cms_update_batch(t0, torch.from_numpy(items),
                              None if weights is None
                              else torch.from_numpy(weights))
    want = jm.cms_update_batch(jnp.asarray(t0.numpy()), jnp.asarray(items),
                               None if weights is None
                               else jnp.asarray(weights))
    _eq(got, want)
    for x in list(EDGES) + [7, 999]:
        assert int(tm.cms_query(got, int(x))) == \
            int(jm.cms_query(want, jnp.int32(int(x))))


@pytest.mark.parametrize("masked", [False, True])
def test_hll_update_batch_and_extract_match(masked):
    rng = np.random.default_rng(6)
    items = np.concatenate([EDGES, rng.integers(0, 10 ** 7, 5000)]
                           ).astype(np.int32)
    mask = rng.random(items.shape[0]) < 0.7 if masked else None
    t, j = tm.hyperloglog(10), jm.hyperloglog(10)
    got = tm.hll_update_batch(t.identity(), torch.from_numpy(items),
                              None if mask is None
                              else torch.from_numpy(mask))
    want = jm.hll_update_batch(j.identity(), jnp.asarray(items),
                               None if mask is None else jnp.asarray(mask))
    _eq(got, want)
    est_t, est_j = float(t.extract(got)), float(j.extract(want))
    assert abs(est_t - est_j) <= 1e-6 * abs(est_j)
    # the small-range (linear counting) branch too
    few_t = tm.hll_update_batch(t.identity(), torch.arange(40))
    few_j = jm.hll_update_batch(j.identity(), jnp.arange(40))
    assert abs(float(t.extract(few_t)) - float(j.extract(few_j))) <= \
        1e-6 * float(j.extract(few_j))


def test_bloom_contains_matches():
    rng = np.random.default_rng(7)
    present = rng.integers(-10 ** 6, 10 ** 6, 300).astype(np.int32)
    t, j = tm.bloom_filter(1 << 12), jm.bloom_filter(1 << 12)
    ft, fj = t.identity(), j.identity()
    for x in present:
        ft = t.combine(ft, t.lift(torch.tensor(x)))
        fj = j.combine(fj, j.lift(jnp.int32(x)))
    _eq(ft, fj)
    probes = np.concatenate([present[:50], rng.integers(0, 10 ** 7, 300)])
    for x in probes:
        assert bool(tm.bloom_contains(ft, int(x))) == \
            bool(jm.bloom_contains(fj, jnp.int32(int(x))))
    assert all(bool(tm.bloom_contains(ft, int(x))) for x in present)


def test_product_and_stripe_of_window_match():
    stats_t = tm.product(a=tm.count_min(2, 32), b=tm.hyperloglog(4))
    stats_j = jm.product(a=jm.count_min(2, 32), b=jm.hyperloglog(4))
    assert stats_t.name == stats_j.name
    vt = stats_t.lift({"a": torch.tensor(5), "b": torch.tensor(9)})
    vj = stats_j.lift({"a": jnp.int32(5), "b": jnp.int32(9)})
    for k in ("a", "b"):
        _eq(vt[k], vj[k])
    win = np.array([3, 1, 4, 1, 5], np.int32)
    _eq(tm.stripe_of_window(torch.from_numpy(win), 8, 2),
        jm.stripe_of_window(jnp.asarray(win), 8, 2))
