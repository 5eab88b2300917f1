"""The port's count-min kernel contract vs the JAX package's Pallas kernel.

``cms_counts_plain`` — what the wrapper runs on CPU tensors, and what the
CUDA kernel ``csrc/cms_update.cu`` is held against on the card — through
``repro_torch.kernels.ops.cms_update`` against ``repro.kernels.ops.
cms_update`` (the Pallas kernel in interpret mode) and ``repro.kernels.ref``
on the same numpy tokens, exactly (compared as int64).  Sizes are those of
the JAX package's own kernel sweep.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis, or skip-stub when absent

from repro.core import monoids as jm
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.cms import cms_update_pallas
from repro_torch.core import monoids as tm
from repro_torch.kernels import cms_counts_plain, ops
from repro_torch.kernels.cms import LIBRARY, cms_counts


def _i64(x):
    return np.asarray(x, np.int64)


@settings(max_examples=6, deadline=None)
@given(n=st.integers(50, 2000), depth=st.integers(1, 5),
       width=st.sampled_from([128, 256, 512]))
def test_cms_sweep_matches_pallas_and_ref(n, depth, width):
    rng = np.random.default_rng(n)
    toks = rng.integers(0, 10000, n).astype(np.int32)
    got = ops.cms_update(torch.from_numpy(toks), depth, width)
    assert got.dtype == torch.float32 and got.shape == (depth, width)
    want = jops.cms_update(jnp.asarray(toks), depth, width, block_n=256)
    np.testing.assert_array_equal(_i64(got.numpy()), _i64(want))
    np.testing.assert_array_equal(
        _i64(got.numpy()), _i64(ref.cms_update_ref(jnp.asarray(toks), depth,
                                                   width)))


def test_default_shape_and_edge_ids():
    """ops.cms_update's defaults (4 x 2048, the stream-stats sketch) and
    ids at the int32 edges, negative ones included."""
    rng = np.random.default_rng(0)
    toks = np.concatenate([[0, 1, -1, -2 ** 31, 2 ** 31 - 1],
                           rng.integers(-2 ** 31, 2 ** 31, 3000, np.int64)]
                          ).astype(np.int32)
    got = ops.cms_update(torch.from_numpy(toks))
    want = jops.cms_update(jnp.asarray(toks))
    np.testing.assert_array_equal(_i64(got.numpy()), _i64(want))


def test_masked_equals_pallas_on_the_kept_tokens():
    """A 0/1 mask (the ragged batches' weights) counts exactly the kept
    tokens: the Pallas kernel on the kept subset."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 5000, 1500).astype(np.int32)
    mask = rng.random(1500) < 0.9
    for weights in (torch.from_numpy(mask),
                    torch.from_numpy(mask.astype(np.int32))):
        got = cms_counts_plain(torch.from_numpy(toks), 3, 256,
                               weights=weights)
        want = cms_update_pallas(jnp.asarray(toks[mask]), 3, 256,
                                 block_n=256)
        np.testing.assert_array_equal(_i64(got.numpy()), _i64(want))


def test_int_weights_equal_cms_update_batch():
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 5000, 1200).astype(np.int32)
    w = rng.integers(-3, 5, 1200).astype(np.int32)
    got = cms_counts(torch.from_numpy(toks), 4, 128,
                     weights=torch.from_numpy(w))
    want = jm.cms_update_batch(jnp.zeros((4, 128), jnp.int32),
                               jnp.asarray(toks), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(
        got, tm.cms_update_batch(torch.zeros((4, 128), dtype=torch.int32),
                                 torch.from_numpy(toks),
                                 torch.from_numpy(w)))


def test_cpu_runs_the_plain_version_without_a_launch():
    before = cms_counts.launches
    cms_counts(torch.arange(100), 2, 64)
    assert cms_counts.launches == before


def test_contract_errors():
    t = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or int64"):
        cms_counts(t.float(), 2, 8)
    with pytest.raises(ValueError, match=">= 1"):
        cms_counts(t, 0, 8)
    with pytest.raises(ValueError, match="one entry per token"):
        cms_counts(t, 2, 8, weights=torch.ones(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="weights must be int32"):
        cms_counts(t, 2, 8, weights=torch.ones(10))
    with pytest.raises(ValueError, match="cuda"):
        cms_counts(t.to("meta"), 2, 8)


def test_kernel_source_hashes_with_the_same_primes():
    """The CUDA source carries its own copy of the hash primes, in order."""
    src = LIBRARY.source.read_text()
    table = src[src.index("kPrimes[10]"):src.index("};", src.index("kPrimes"))]
    primes = [int(h, 16) for h in re.findall(r"0x([0-9A-Fa-f]{8})u", table)]
    assert primes == [int(p) for p in jm._HASH_PRIMES]
    assert LIBRARY.library_path().name.startswith("libcms_update-")
    assert Path(LIBRARY.source).suffix == ".cu"
