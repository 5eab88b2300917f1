"""The port's dense transformer vs the JAX package's, on the same weights.

The qwen3-0.6b smoke config (4 layers, d_model 64, GQA 4/2, qk-norm, tied
embeddings) initialised by the JAX package, carried over with
``params_from_jax``, then ``decode_step`` on both sides for 6 steps at
per-slot positions.  float32 logits agree to atol=1e-4 (the same
arithmetic in another summation order).  In bf16 the two frameworks
round at different points (XLA may keep excess precision inside fused
chains; bf16 keeps 8 significant bits), and each one's bf16 logits differ
from the float32 logits by up to ~0.09 here.  So the bf16 case asks: 99.5%
of logits within atol=5e-2, all within 0.1, and the port's bf16 logits no
further from the float32 logits than the JAX package's (x1.25).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, init_cache, init_params,
                                num_params, params_from_jax)
from repro_torch.models.attention import cache_span_update
from repro_torch.models.common import rms_norm, rotary_embed

B, MAX_SEQ, STEPS = 3, 16, 6
START_POS = (0, 3, 7)        # per-slot positions: rows decode independently


def _pair(jdtype, tdtype, seed=0):
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", smoke=True),
                               dtype=jdtype)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                               dtype=tdtype)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _decode_both(dtype):
    """(jax logits, port logits, jax cache, port cache) over STEPS steps."""
    jcfg, tcfg, jparams, tparams = _pair(getattr(jnp, dtype),
                                         getattr(torch, dtype))
    jcache = jax_init_cache(jparams, jcfg, B, MAX_SEQ, pos_per_slot=True)
    jcache["pos"] = jnp.asarray(START_POS, jnp.int32)
    tcache = init_cache(tparams, tcfg, B, MAX_SEQ, pos_per_slot=True)
    tcache["pos"] = torch.tensor(START_POS, dtype=torch.int32)
    step = jax.jit(lambda p, c, t: jax_decode_step(p, jcfg, c, t))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (STEPS, B, 1)).astype(np.int32)
    jl, tl = [], []
    for i in range(STEPS):
        j, jcache = step(jparams, jcache, jnp.asarray(toks[i]))
        t, tcache = decode_step(tparams, tcfg, tcache,
                                torch.from_numpy(toks[i]))
        assert t.dtype == torch.float32 and t.shape == (B, 1, jcfg.vocab_size)
        jl.append(np.asarray(j))
        tl.append(t.numpy())
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(START_POS) + STEPS)
    return np.stack(jl), np.stack(tl), jcache, tcache


@pytest.fixture(scope="module")
def float32_run():
    return _decode_both("float32")


def test_decode_step_matches_jax_float32(float32_run):
    jl, tl, jcache, tcache = float32_run
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    kv_j = np.asarray(jcache["layers"]["slot_0"]["k"][2])
    np.testing.assert_allclose(tcache["layers"][2]["k"].numpy(), kv_j,
                               rtol=0, atol=1e-4)


def test_decode_step_matches_jax_bfloat16(float32_run):
    jl, tl, _, _ = _decode_both("bfloat16")
    diff = np.abs(tl - jl)
    assert np.mean(diff <= 5e-2) >= 0.995 and diff.max() <= 0.1
    ref = float32_run[0]
    assert np.abs(tl - ref).mean() <= 1.25 * np.abs(jl - ref).mean()
    assert np.abs(tl - ref).max() <= 1.25 * np.abs(jl - ref).max()


def test_params_carry_over_leaf_for_leaf():
    jcfg, tcfg, jparams, tparams = _pair(jnp.float32, torch.float32)
    assert len(tparams["layers"]) == jcfg.num_layers
    np.testing.assert_array_equal(
        tparams["layers"][3]["mix"]["wq"].numpy(),
        np.asarray(jparams["layers"]["slot_0"]["mix"]["wq"][3]))
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert num_params(tparams) == n_jax


def test_init_params_shapes_and_scale_match_jax():
    """Random init from a torch.Generator: the JAX shapes, dtype and
    1/sqrt(fan_in) scale (not JAX's numbers)."""
    jcfg, tcfg, jparams, _ = _pair(jnp.bfloat16, torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    tparams = init_params(tcfg, gen, device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(tparams["layers"][0]["mix"][name].shape) == \
            jparams["layers"]["slot_0"]["mix"][name].shape[1:]
    std = float(tparams["layers"][0]["ffn"]["w_down"].float().std())
    assert abs(std - 1 / np.sqrt(tcfg.d_ff)) < 0.01
    assert torch.equal(tparams["final_norm"], torch.ones(tcfg.d_model,
                                                         dtype=torch.bfloat16))


def test_norm_and_rotary_match_jax_in_bf16():
    from repro.models.common import rms_norm as jrms
    from repro.models.common import rotary_embed as jrot

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    for jdt, tdt, atol in ((jnp.float32, torch.float32, 1e-5),
                           (jnp.bfloat16, torch.bfloat16, 3e-2)):
        jx = jnp.asarray(x).astype(jdt)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
        got = rms_norm(tx, torch.from_numpy(g), 1e-6).float().numpy()
        want = np.asarray(jrms(jx, jnp.asarray(g), 1e-6), np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        got = rotary_embed(tx, torch.from_numpy(pos), 1e6).float().numpy()
        want = np.asarray(jrot(jx, jnp.asarray(pos), 1e6), np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_cache_update_clamps_like_dynamic_update_slice():
    from repro.models.attention import cache_span_update as jupd

    cache = np.zeros((2, 6, 1), np.float32)
    new = np.ones((2, 2, 1), np.float32)
    pos = np.array([1, 9], np.int32)      # row 1 past the end: clamped
    want = np.asarray(jupd(jnp.asarray(cache), jnp.asarray(new),
                           jnp.asarray(pos), seq_axis=1))
    got = cache_span_update(torch.from_numpy(cache.copy()),
                            torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


def test_other_families_are_later_slices():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              layer_pattern=("mamba",))
    with pytest.raises(NotImplementedError, match="dense family"):
        init_params(cfg, torch.Generator(), device="cpu")
