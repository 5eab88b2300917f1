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


@pytest.mark.parametrize("weights", ["none", "bool", "uint8"])
def test_int64_tokens_and_byte_weights_match_pallas(weights):
    """The wrapper's input types the kernel reads as they are: int64 ids
    with high bits set hash their low 32 bits, and a bool or uint8 weight
    counts each token that many times -- the Pallas kernel on the low 32
    bits, each repeated by its weight, exactly."""
    rng = np.random.default_rng(3)
    n = 1200
    low = rng.integers(-2 ** 31, 2 ** 31, n, np.int64)
    low[::3] = rng.integers(0, 5000, (n + 2) // 3)   # repeated small ids
    toks = low + (rng.integers(-2 ** 31, 2 ** 31, n, np.int64) << 32)
    w = None
    reps = np.ones(n, np.int64)
    if weights == "bool":
        w = rng.random(n) < 0.8
        reps = w.astype(np.int64)
    elif weights == "uint8":
        w = rng.integers(0, 256, n).astype(np.uint8)
        reps = w.astype(np.int64)
    got = cms_counts(torch.from_numpy(toks), 3, 256,
                     weights=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (3, 256)
    want = cms_update_pallas(jnp.asarray(np.repeat(low.astype(np.int32),
                                                   reps)), 3, 256,
                             block_n=256)
    np.testing.assert_array_equal(_i64(got.numpy()), _i64(want))


def test_kernel_variants_each_edit_the_kernel_source_once():
    """``kernel_variants.py`` (the chip A/B of cms_update design choices)
    builds each variant by editing ``csrc/cms_update.cu``: every edit must
    still find its text exactly once, so the variants time what they name."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    source = LIBRARY.source.read_text()
    assert "as built" in variants.CMS_VARIANTS
    for name, edits in variants.CMS_VARIANTS.items():
        for old, new in edits:
            assert source.count(old) == 1, name
            assert new not in source, name
