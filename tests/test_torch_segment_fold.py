"""The port's segment-fold kernel contract vs the JAX package's Pallas kernel.

``segment_fold_plain`` (what the wrapper runs on CPU tensors, and what the
CUDA kernel is held against on the card) against ``segment_fold_pallas`` in
interpret mode, on the same numpy inputs.  Integer, max and min results are
exact; float32 sums use rtol=1e-5, atol=1e-5 because the two sum the rows in
different orders (the Pallas kernel by one-hot matmul per block).  NaN rows
are checked on max/min only: the Pallas one-hot matmul multiplies every NaN
by zero for the other keys too, so a NaN poisons its whole column there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_fold import segment_fold_pallas
from repro_torch.kernels import mean_by_key, segment_fold, segment_fold_plain
from repro_torch.kernels.segment_fold import NVCC_FLAGS, library_path

N, D, S, BLOCK = 37, 5, 6, 16          # N is not a block multiple


_DTYPES = {
    "f32": (np.float32, jnp.float32, torch.float32),
    "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
    "int8": (np.int8, jnp.int8, torch.int8),
    "uint8": (np.uint8, jnp.uint8, torch.uint8),
    "int32": (np.int32, jnp.int32, torch.int32),
}


def _inputs(dtype_name, seed, nan_rows=False):
    rng = np.random.default_rng(seed)
    np_dt, jdt, tdt = _DTYPES[dtype_name]
    if np_dt == np.float32:
        v = rng.normal(size=(N, D)).astype(np.float32)
        if nan_rows:
            v[[3, 20]] = np.nan
    elif np_dt == np.uint8:
        v = rng.integers(0, 4, (N, D)).astype(np.uint8)
    else:
        v = rng.integers(-3, 4, (N, D)).astype(np_dt)
    ids = rng.integers(-1, S + 2, N).astype(np.int32)   # some out of range
    mask = rng.random(N) < 0.7
    jv = jnp.asarray(v).astype(jdt)
    # bf16: hand both sides the same bf16-rounded values
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(tdt) \
        if dtype_name == "bf16" else torch.from_numpy(v)
    return jv, tv, ids, mask


def _jax(jv, ids, mask, semiring, with_count):
    return segment_fold_pallas(
        jv, jnp.asarray(ids), S, block_n=BLOCK, semiring=semiring,
        with_count=with_count,
        valid_mask=None if mask is None else jnp.asarray(mask),
        interpret=True)


def _assert_same(got, want, exact):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype_name", list(_DTYPES))
@pytest.mark.parametrize("semiring", ["sum", "max", "min"])
def test_plain_matches_pallas(semiring, dtype_name, masked):
    nan_rows = semiring != "sum" and dtype_name in ("f32", "bf16")
    jv, tv, ids, mask = _inputs(dtype_name, seed=len(dtype_name) * 7 + masked,
                                nan_rows=nan_rows)
    mask = mask if masked else None
    want = _jax(jv, ids, mask, semiring, False)
    got = segment_fold_plain(tv, torch.from_numpy(ids), S, semiring=semiring,
                             valid_mask=None if mask is None
                             else torch.from_numpy(mask))
    exact = semiring != "sum" or dtype_name not in ("f32", "bf16")
    _assert_same(got, want, exact)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype_name", list(_DTYPES))
def test_with_count_matches_pallas(dtype_name, masked):
    jv, tv, ids, mask = _inputs(dtype_name, seed=11 + masked)
    mask = mask if masked else None
    want_s, want_c = _jax(jv, ids, mask, "sum", True)
    got_s, got_c = segment_fold_plain(
        tv, torch.from_numpy(ids), S, with_count=True,
        valid_mask=None if mask is None else torch.from_numpy(mask))
    _assert_same(got_s, want_s, exact=dtype_name not in ("f32", "bf16"))
    _assert_same(got_c, want_c, exact=True)


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    _, tv, ids, mask = _inputs("f32", seed=3)
    before = segment_fold.launches
    got = segment_fold(tv, torch.from_numpy(ids), S,
                       valid_mask=torch.from_numpy(mask))
    want = segment_fold_plain(tv, torch.from_numpy(ids), S,
                              valid_mask=torch.from_numpy(mask))
    assert torch.equal(got, want)
    assert segment_fold.launches == before


def test_mean_by_key_matches_jax():
    from repro.kernels import ops as jops

    rng = np.random.default_rng(1)
    v = rng.normal(size=(300, 2)).astype(np.float32)
    ids = rng.integers(0, 7, 300).astype(np.int32)
    want = jops.mean_by_key(jnp.asarray(v), jnp.asarray(ids), 7, block_n=64,
                            interpret=True)
    got = mean_by_key(torch.from_numpy(v), torch.from_numpy(ids), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_contract_errors():
    v = torch.zeros((4, 2))
    ids = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="with_count"):
        segment_fold(v, ids, 2, semiring="max", with_count=True)
    with pytest.raises(ValueError, match="semiring"):
        segment_fold(v, ids, 2, semiring="prod")
    with pytest.raises(TypeError, match="float64"):
        segment_fold(v.double(), ids, 2)
    with pytest.raises(ValueError, match="seg_ids"):
        segment_fold(v, ids[:3], 2)
    with pytest.raises(ValueError, match="cuda"):
        segment_fold(v.to("meta"), ids.to("meta"), 2)


def test_build_command_targets_hopper():
    """The nvcc line the wrapper builds with (the build itself needs the
    card's toolkit and runs on first launch there)."""
    flags = " ".join(NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    path = library_path()
    assert path.parent.parts[-2:] == ("build", "repro_torch")
    assert path.name.startswith("libsegment_fold-") and path.suffix == ".so"
