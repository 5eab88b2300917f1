"""The port's stripes kernel contract vs the JAX package's Pallas kernel.

``stripe_counts_plain`` — what the wrapper runs on CPU tensors, and what the
CUDA kernel ``csrc/stripes.cu`` is held against on the card — through
``repro_torch.kernels.ops.stripes`` against ``repro.kernels.ops.stripes``
(the Pallas kernel in interpret mode) and ``repro.kernels.ref`` on the same
numpy tokens, exactly (compared as int64).  Ids outside ``[0, V)``: the
port drops them as the Pallas one-hot does, so those cases are held
against the Pallas kernel only (the jnp reference wraps negative ids).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis, or skip-stub when absent

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.stripes import stripes_pallas
from repro_torch.core import monoids as tm
from repro_torch.kernels import ops, stripe_counts_plain
from repro_torch.kernels.stripes import LIBRARY, stripe_counts


def _i64(x):
    return np.asarray(x, np.int64)


@settings(max_examples=6, deadline=None)
@given(n=st.integers(20, 600), vocab=st.sampled_from([32, 64, 128]),
       window=st.integers(1, 5))
def test_stripes_sweep_matches_pallas_and_ref(n, vocab, window):
    rng = np.random.default_rng(n + vocab)
    toks = rng.integers(0, vocab, n).astype(np.int32)
    got = ops.stripes(torch.from_numpy(toks), vocab, window)
    assert got.dtype == torch.float32 and got.shape == (vocab, vocab)
    want = jops.stripes(jnp.asarray(toks), vocab, window, block_n=128)
    np.testing.assert_array_equal(_i64(got.numpy()), _i64(want))
    np.testing.assert_array_equal(
        _i64(got.numpy()), _i64(ref.stripes_ref(jnp.asarray(toks), vocab,
                                                window)))
    # Algorithm 5 through the monoid zoo: the same int32 table
    np.testing.assert_array_equal(
        tm.cooccurrence_stripes(torch.from_numpy(toks), vocab, window).numpy(),
        np.asarray(ref.stripes_ref(jnp.asarray(toks), vocab, window)))


@pytest.mark.parametrize("n,vocab,window", [(300, 32, 3), (97, 16, 5),
                                            (2, 8, 4), (1, 8, 1)])
def test_out_of_range_ids_match_the_pallas_kernel(n, vocab, window):
    rng = np.random.default_rng(n)
    toks = rng.integers(-3, vocab + 3, n).astype(np.int32)
    toks[:1] = -1
    got = stripe_counts(torch.from_numpy(toks), vocab, window)
    want = stripes_pallas(jnp.asarray(toks), vocab, window, block_n=64)
    np.testing.assert_array_equal(_i64(got.numpy()), _i64(want))
    assert torch.equal(got, got.T)
    assert torch.equal(
        stripe_counts(torch.from_numpy(toks).long(), vocab, window), got)


def test_diagonal_counts_two_per_pair():
    got = stripe_counts_plain(torch.tensor([5, 5, 5], dtype=torch.int32), 8, 2)
    assert int(got[5, 5]) == 2 * 3 and int(got.sum()) == 6


def test_cpu_runs_the_plain_version_without_a_launch():
    before = stripe_counts.launches
    stripe_counts(torch.arange(10), 10, 2)
    assert stripe_counts.launches == before


def test_contract_errors():
    t = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or int64"):
        stripe_counts(t.float(), 10, 2)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        stripe_counts(t.reshape(2, 5), 10, 2)
    with pytest.raises(ValueError, match=">= 1"):
        stripe_counts(t, 10, 0)
    with pytest.raises(ValueError, match="cuda"):
        stripe_counts(t.to("meta"), 10, 2)
    assert LIBRARY.library_path().name.startswith("libstripes-")


def test_kernel_variants_each_edit_the_kernel_source_once():
    """``kernel_variants.py`` (the chip A/B of stripes design choices) builds
    each variant by editing ``csrc/stripes.cu``: every edit must still find
    its text exactly once, so the variants time what they name."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    source = LIBRARY.source.read_text()
    assert "as built" in variants.VARIANTS
    for name, edits in variants.VARIANTS.items():
        for old, new in edits:
            assert source.count(old) == 1, name
            assert new not in source, name
