"""The port's threefry2x32 stream (``repro_torch.runtime.prng``) against
``jax.random`` on the CPU.

Keys, 32-bit random bits and uniform floats must be equal bit for bit.
The Gumbel noise is ``-log(-log(u))``, and XLA's and PyTorch's float32
``log`` each differ by up to 1 ulp (measured on 10^5 draws): so each ``log``
is held within 1 ulp of XLA's, and the noise within 2 ulp of
``max(|g|, 1)`` -- where ``g`` is near 0, a 1-ulp change of the inner
``-log(u)`` moves ``g`` by ~1e-7 absolute, many ulps of ``g`` itself.  The
sampled categories must be equal.  The keys are the serve
engine's: ``fold_in(fold_in(PRNGKey(engine seed), request seed), token
index)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.runtime import prng

# (engine seed, request seed, token index)
TRIPLES = [(0, 0, 0), (0, 7, 3), (1, 100, 0), (3, 2**31 - 1, 31),
           (12345, 65536 + 5, 1000)]
V = 1000


def _jax_key(base, seed, index):
    k = jax.random.fold_in(jax.random.PRNGKey(base), seed)
    return jax.random.fold_in(k, index)


def _port_keys(triples):
    """The keys of all triples at once, vectorised as the engine does."""
    bases = {b for b, _, _ in triples}
    assert len(bases) == 1
    key = prng.prng_key(bases.pop())
    seeds = np.array([s for _, s, _ in triples], np.int64)
    index = np.array([i for _, _, i in triples], np.int64)
    return prng.fold_in(prng.fold_in(key, seeds), index)


def _words(key):
    return np.stack([key[0].numpy(), key[1].numpy()], axis=-1)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**32 + 5])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(_words(prng.prng_key(seed)), want)


@pytest.mark.parametrize("triple", TRIPLES)
def test_fold_in_keys_and_bits_match_jax_bit_for_bit(triple):
    base, seed, index = triple
    jkey = _jax_key(base, seed, index)
    key = _port_keys([(base, seed, index)])
    np.testing.assert_array_equal(_words(key)[0], np.asarray(jkey))
    want = np.asarray(jax.random.bits(jkey, (V,), jnp.uint32))
    got = prng.random_bits(key, V)[0].numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_vectorised_rows_equal_each_rows_own_draw():
    rows = [t for t in TRIPLES if t[0] == 0]
    bits = prng.random_bits(_port_keys(rows), V).numpy()
    for r, (base, seed, index) in enumerate(rows):
        want = np.asarray(jax.random.bits(_jax_key(base, seed, index), (V,),
                                          jnp.uint32))
        np.testing.assert_array_equal(bits[r], want.astype(np.int64))


def _ulp_diff(a, b):
    """Distance in float32 ulps (both arrays finite, of one sign each)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("triple", TRIPLES)
def test_uniform_and_gumbel_match_jax(triple):
    jkey = _jax_key(*triple)
    key = _port_keys([triple])
    tiny = float(jnp.finfo(jnp.float32).tiny)
    want_u = np.asarray(jax.random.uniform(jkey, (V,), jnp.float32,
                                           minval=tiny, maxval=1.0))
    got_u = prng.uniform(key, V, tiny, 1.0)
    np.testing.assert_array_equal(got_u[0].numpy(), want_u)
    inner = -torch.log(got_u)[0].numpy()
    assert _ulp_diff(inner, np.asarray(-jnp.log(want_u))).max() <= 1
    want = np.asarray(jax.random.gumbel(jkey, (V,), jnp.float32))
    got = prng.gumbel(key, V)[0].numpy()
    assert np.isfinite(got).all()
    scale = np.maximum(np.abs(want), np.float32(1.0))
    assert (np.abs(got - want) <= 2 * np.spacing(scale)).all()


@pytest.mark.parametrize("temperature", [0.8, 1.0])
def test_categorical_matches_jax(temperature):
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=3.0, size=(len(TRIPLES), V)).astype(np.float32)
    want = [int(jax.random.categorical(_jax_key(*t),
                                       jnp.asarray(logits[r]) / temperature))
            for r, t in enumerate(TRIPLES)]
    got = []
    for r, t in enumerate(TRIPLES):
        scaled = torch.from_numpy(logits[r:r + 1]) / temperature
        got.append(int(prng.categorical(_port_keys([t]), scaled)[0]))
    assert got == want
