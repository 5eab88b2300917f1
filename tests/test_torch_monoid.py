"""The port's Monoid core and kernel-lowered zoo vs the JAX package's.

Law checks run over every monoid in the port's registry, on the same
samples as the JAX registry's (compared value for value); the folds are
held against the JAX folds on the same numpy inputs, including an
order-sensitive (non-commutative) monoid, which only an ADJACENT-pair tree
fold keeps right.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.core import monoid as jmonoid
from repro.core import monoids as jm
from repro_torch.core import monoid as tmonoid
from repro_torch.core import monoids as tm
from repro_torch.core.aggregation import local_fold, tree_bytes


@pytest.mark.parametrize("name", sorted(tm.REGISTRY))
def test_registry_laws_hold(name):
    m = tm.REGISTRY[name]
    samples = tm.law_samples_for(name)()
    assert len(samples) >= 3
    tmonoid.check_laws(m, samples)


@pytest.mark.parametrize("name", sorted(tm.REGISTRY))
def test_law_samples_and_combines_match_jax(name):
    """Same samples as the JAX registry; same combine and identity."""
    t_samples = tm.law_samples_for(name)()
    j_samples = jm.law_samples_for(name)()
    tmon, jmon = tm.REGISTRY[name], jm.REGISTRY[name]
    for ts, js in zip(t_samples, j_samples):
        for a, b in zip(pytree.tree_leaves(ts), jax.tree_util.tree_leaves(js)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = tmon.combine(t_samples[0], t_samples[1])
    want = jmon.combine(j_samples[0], j_samples[1])
    for a, b in zip(pytree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(pytree.tree_leaves(tmon.identity_like(t_samples[0])),
                    jax.tree_util.tree_leaves(jmon.identity_like(j_samples[0]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_registry_is_the_kernel_lowered_family():
    """The JAX registry minus the monoids of a later slice (lossy_*:
    training, which ``repro.optim`` registers when some other test has
    imported it); the decay monoids and ``cache_stats`` came with the
    prefix cache.  The kernel-lowered family is exactly the monoids with a
    registered lowering."""
    later = {n for n in jm.REGISTRY if n.startswith("lossy_")}
    assert {n for n in tm.REGISTRY if n.startswith(("decayed_",
                                                     "cache_stats"))} == {
        "decayed_sum(hl=16)", "decayed_count(hl=16)", "decayed_lru(hl=16)",
        "cache_stats(hl=32)"}
    assert set(tm.REGISTRY) == set(jm.REGISTRY) - later
    assert tm.missing_law_samples() == []
    lowered = {name for name, m in tm.REGISTRY.items()
               if m.kernel_lowering() is not None}
    assert lowered == {"sum", "count", "max", "min", "mean", "bitwise_or"}
    with pytest.raises(ValueError, match="already registered"):
        tm.register_monoid(tm.sum_, lambda: [])


def _matmul_monoids():
    """2x2 matrix product: associative, NOT commutative."""
    t = tmonoid.Monoid(name="matmul2", combine=torch.matmul,
                       identity_fn=lambda *, example: torch.eye(2),
                       commutative=False)
    j = jmonoid.Monoid(name="matmul2", combine=jnp.matmul,
                       identity_fn=lambda *, example: jnp.eye(2),
                       commutative=False)
    return t, j


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_tree_fold_pairs_adjacent_elements(n):
    t, j = _matmul_monoids()
    xs = np.random.default_rng(n).normal(size=(n, 2, 2)).astype(np.float32)
    got = tmonoid.tree_fold(t, torch.from_numpy(xs))
    want = jmonoid.tree_fold(j, jnp.asarray(xs))
    seq = np.eye(2, dtype=np.float32)
    for x in xs:
        seq = seq @ x
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), seq, rtol=1e-5, atol=1e-5)
    # the serial scan agrees, and the axis argument moves the batch dim
    scanned = tmonoid.scan_fold(t, torch.from_numpy(xs))
    np.testing.assert_allclose(scanned.numpy(), seq, rtol=1e-5, atol=1e-5)
    moved = tmonoid.tree_fold(t, torch.from_numpy(np.moveaxis(xs, 0, 2)),
                              axis=2)
    np.testing.assert_allclose(moved.numpy(), seq, rtol=1e-5, atol=1e-5)


def test_tree_fold_rejects_empty_batch():
    with pytest.raises(ValueError, match="empty"):
        tmonoid.tree_fold(tm.sum_, torch.zeros((0, 3)))


@pytest.mark.parametrize("strategy", ["scan", "tree"])
def test_fold_map_and_local_fold_match_jax(strategy):
    xs = np.random.default_rng(7).normal(size=(9, 4)).astype(np.float32)
    got = tmonoid.fold_map(tm.mean, lambda x: x * 2, torch.from_numpy(xs),
                           strategy=strategy)
    want = jmonoid.fold_map(jm.mean, lambda x: x * 2, jnp.asarray(xs),
                            strategy=strategy)
    np.testing.assert_allclose(tm.mean.extract(got).numpy(),
                               np.asarray(jm.mean.extract(want)), rtol=1e-6)
    assert int(got[1]) == int(want[1]) == 9
    lf = local_fold(tm.max_, torch.from_numpy(xs), strategy=strategy)
    np.testing.assert_array_equal(lf.numpy(), xs.max(0))
    with pytest.raises(ValueError, match="strategy"):
        local_fold(tm.max_, torch.from_numpy(xs), strategy="bogus")


def test_check_structure_rejects_shape_changing_combine():
    bad = tmonoid.Monoid(name="concat", combine=lambda a, b: torch.cat([a, b]),
                         identity_fn=lambda: torch.zeros(0))
    with pytest.raises(tmonoid.MonoidTypeError, match="leaf shape"):
        tmonoid.check_structure(bad, torch.ones(2), torch.ones(2))


def test_tree_bytes_counts_meta_and_real_leaves():
    tree = (torch.zeros((3, 4)), {"c": torch.empty((5,), dtype=torch.int8,
                                                   device="meta")})
    assert tree_bytes(tree) == 3 * 4 * 4 + 5
