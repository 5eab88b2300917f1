"""The port's MLA (DeepSeek-V2 multi-head latent attention) and the
deepseek-v2-236b model against the JAX package's, on the same weights.

The deepseek-v2-236b smoke config (4 layers: the dense prelude layer and 3
MoE layers of 8 experts top-2 with 2 shared; MLA with q_lora_rank 32,
kv_lora_rank 16, rope 8, nope 16, v 16) and its ``q_lora_rank = 0``
variant (the query projected straight by ``wq``), initialised by the JAX
package and carried over with ``params_from_jax``.

* ``init_mla`` / ``init_params`` shapes against the reference's, at the
  smoke width and (on the meta device) the full config;
* ``params_from_jax`` with the unrolled ``prelude_0`` ahead of the period
  stack, leaf for leaf, and the ``to_jax_layout`` / ``from_jax_layout``
  round trip;
* ``mla_attention``, ``forward`` and ten steps of ``mla_decode`` /
  ``decode_step`` in float32 at atol 1e-4; in bf16 each package against
  its own float32 (the dense family's criterion: the reference rounds its
  softmax weights to bf16 before the value product, the kernel's plain
  version keeps them in float32);
* the cache leaves ``lat_c`` / ``lat_r``: shapes, and the decode step's
  in-place write of one row per slot at its own position;
* the one-pass prefill, cold and warm (after cached prefix rows), against
  the JAX engine's decode scan over the bucket, and warm against cold;
* the port's engine against the JAX engine token for token with the
  prefix cache off and on, and ``expert_load`` against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.transformer import param_shapes as jax_param_shapes
from repro_torch.configs import get_config
from repro_torch.core.calibration import default_calibration, use_calibration
from repro_torch.models import (decode_step, forward, forward_with_stats,
                                init_cache, init_params, num_params,
                                params_from_jax, positional_cache, prefill)
from repro_torch.models import attention as attn
from repro_torch.models.convert import from_jax_layout, to_jax_layout

ARCH = "deepseek-v2-236b"
VARIANTS = {"q_lora": {}, "no_q_lora": {"q_lora_rank": 0}}
START_POS = (0, 3, 7)        # per-slot positions: rows decode independently


@pytest.fixture(autouse=True)
def _shipped_calibration():
    with use_calibration(default_calibration()):
        yield


def _pair(variant="q_lora", jdtype=jnp.float32, tdtype=torch.float32,
          seed=0):
    over = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=jdtype, **over)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdtype,
                               **over)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair32(request):
    return _pair(request.param)


def _jax_layers(jcfg, tree):
    """The JAX tree's per-layer subtrees in layer order: ``prelude_i``,
    then each period of the stack (no remainder in this config)."""
    pre = jcfg.prelude_dense_layers
    n = (jcfg.num_layers - pre) // jcfg.period
    assert n * jcfg.period + pre == jcfg.num_layers
    return [tree[f"prelude_{i}"] for i in range(pre)] + [
        jax.tree_util.tree_map(lambda a, p=p: a[p], tree["layers"]["slot_0"])
        for p in range(n)]


def _paths(tree):
    return {pytree.keystr(k): tuple(v.shape)
            for k, v in pytree.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_mla_shapes_match_jax(variant):
    """``init_params``' MLA ``mix`` and the dense prelude FFN: every leaf's
    shape is the reference's, and the scales are ``1/sqrt(fan_in)``."""
    jcfg, tcfg, jparams, _ = _pair(variant)
    tp = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = [jax.tree_util.tree_map(lambda a: np.zeros(a.shape), layer)
            for layer in _jax_layers(jcfg, jparams)]
    for layer, ref in zip(tp["layers"], want):
        assert _paths(layer) == _paths(pytree.tree_map(torch.from_numpy, ref))
    mix = tp["layers"][0]["mix"]
    names = ({"wq"} if variant == "no_q_lora" else
             {"wq_a", "q_a_norm", "wq_b"}) | {"wkv_a", "kv_a_norm", "wk_b",
                                              "wv_b", "wo"}
    assert set(mix) == names
    assert tp["layers"][0]["ffn"]["w_up"].shape == (tcfg.d_model, tcfg.d_ff)
    assert "router" in tp["layers"][1]["ffn"]
    assert abs(float(mix["wkv_a"].std()) - tcfg.d_model ** -0.5) < 0.02
    assert torch.equal(mix["kv_a_norm"], torch.ones(tcfg.kv_lora_rank))


def test_full_config_shapes_match_jax():
    """deepseek-v2-236b at full width and depth on the meta device: the
    reference's leaf shapes and parameter count (~236 B), 160 experts."""
    jcfg = jax_get_config(ARCH)
    tcfg = get_config(ARCH)
    tp = init_params(tcfg, torch.Generator(), device="meta")
    want = _jax_layers(jcfg, jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"),
        jax_param_shapes(jcfg)))
    assert len(tp["layers"]) == 60
    for layer, ref in zip(tp["layers"], want):
        assert _paths(layer) == _paths(ref)
    assert num_params(tp) == jcfg.num_params() == tcfg.num_params()
    assert 230e9 < num_params(tp) < 240e9
    assert tcfg.num_active_params() == jcfg.num_active_params()
    assert [tcfg.ffn_type(i) for i in range(3)] == ["dense", "moe", "moe"]
    assert positional_cache(tcfg)


def test_params_carry_over_with_the_prelude(pair32):
    """``params_from_jax``: ``prelude_0`` becomes layer 0 and period p of
    the stack layer 1 + p, leaf for leaf; ``to_jax_layout`` gives the JAX
    tree back and ``from_jax_layout`` inverts it."""
    jcfg, tcfg, jparams, tparams = pair32
    want = _jax_layers(jcfg, jparams)
    assert len(tparams["layers"]) == jcfg.num_layers
    for layer, ref in zip(tparams["layers"], want):
        flat_t = dict((pytree.keystr(k), v) for k, v in
                      pytree.tree_flatten_with_path(layer)[0])
        flat_j = dict((jax.tree_util.keystr(k), np.asarray(v)) for k, v in
                      jax.tree_util.tree_flatten_with_path(ref)[0])
        assert set(flat_t) == set(flat_j)
        for k in flat_t:
            np.testing.assert_array_equal(flat_t[k].numpy(), flat_j[k])
    jax_like = to_jax_layout(tparams, tcfg)
    assert sorted(jax_like) == sorted(jparams)
    for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = jax_like
        for key in k:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(v))
    back = from_jax_layout(jax_like, tcfg, tparams)
    assert pytree.tree_structure(back) == pytree.tree_structure(tparams)
    for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(tparams)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# MLA layer
# ---------------------------------------------------------------------------

def _layer_inputs(jcfg, jparams, tparams, layer, S=10, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    return (_jax_layers(jcfg, jparams)[layer]["mix"],
            tparams["layers"][layer]["mix"], x)


@pytest.mark.parametrize("layer", [0, 2])
def test_mla_attention_matches_jax_float32(pair32, layer):
    """The full-sequence MLA (one ``flash_attention`` call at d 24, dv 16
    here) against ``repro.models.attention.mla_attention`` at 1e-4; the
    latent rows it returns against ``_mla_latent``'s."""
    jcfg, tcfg, jparams, tparams = pair32
    jp, tp, x = _layer_inputs(jcfg, jparams, tparams, layer)
    B, S, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = jax_attn.mla_attention(jp, jcfg, jnp.asarray(x), pos)
    got, (c, r) = attn.mla_attention(tp, tcfg, torch.from_numpy(x))
    assert got.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    wc, wr = jax_attn._mla_latent(jp, jcfg, jnp.asarray(x), pos)
    assert c.shape == (B, S, jcfg.kv_lora_rank)
    assert r.shape == (B, S, jcfg.qk_rope_dim)
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(wr), rtol=0, atol=1e-5)


def test_mla_attention_bfloat16_against_each_own_float32():
    """bf16 MLA: each package's output against its own float32 (the port's
    no further off than the reference's, x1.25, mean and max), and the two
    bf16 outputs within 5e-2 of each other."""
    out = {}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jcfg, tcfg, jparams, tparams = _pair("q_lora", jdt, tdt)
        jp, tp, x = _layer_inputs(jcfg, jparams, tparams, 1, S=16)
        B, S, _ = x.shape
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        j = jax_attn.mla_attention(jp, jcfg, jnp.asarray(x, jdt), pos)
        t, _ = attn.mla_attention(tp, tcfg, torch.from_numpy(x).to(tdt))
        out[tdt] = (np.asarray(j.astype(jnp.float32)), t.float().numpy())
    (j32, t32), (j16, t16) = out[torch.float32], out[torch.bfloat16]
    ref_j, ref_t = np.abs(j16 - j32), np.abs(t16 - t32)
    assert ref_t.mean() <= 1.25 * ref_j.mean()
    assert ref_t.max() <= 1.25 * ref_j.max()
    assert np.abs(t16 - j16).max() <= 5e-2


def test_mla_attention_positions_are_derived():
    """``mla_attention`` places its queries at ``q_offset + arange(S)``:
    the same positions may be passed, others raise."""
    _, tcfg, _, tparams = _pair()
    p = tparams["layers"][1]["mix"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 5, tcfg.d_model)).astype(np.float32))
    want, _ = attn.mla_attention(p, tcfg, x)
    same, _ = attn.mla_attention(p, tcfg, x, torch.arange(5).expand(2, 5))
    assert torch.equal(want, same)
    with pytest.raises(ValueError, match="positions"):
        attn.mla_attention(p, tcfg, x, torch.arange(1, 6).expand(2, 5))


def test_mla_decode_matches_jax_and_writes_in_place(pair32):
    """Ten weight-absorbed decode steps at per-slot positions against
    ``repro.models.attention.mla_decode``: outputs and caches at 1e-4;
    each step writes one row per slot, at its position, into the very
    tensors it was given."""
    jcfg, tcfg, jparams, tparams = pair32
    jp = _jax_layers(jcfg, jparams)[2]["mix"]
    tp = tparams["layers"][2]["mix"]
    B, S = len(START_POS), 24
    rng = np.random.default_rng(5)
    jc = jnp.zeros((B, S, jcfg.kv_lora_rank), jnp.float32)
    jr = jnp.zeros((B, S, jcfg.qk_rope_dim), jnp.float32)
    tc = torch.zeros((B, S, tcfg.kv_lora_rank))
    tr = torch.zeros((B, S, tcfg.qk_rope_dim))
    ptrs = (tc.data_ptr(), tr.data_ptr())
    pos = np.asarray(START_POS, np.int32)
    for step in range(10):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        want, (jc, jr) = jax_attn.mla_decode(jp, jcfg, jnp.asarray(x),
                                             (jc, jr), jnp.asarray(pos))
        before = tc.clone()
        got, (c2, r2) = attn.mla_decode(tp, tcfg, torch.from_numpy(x),
                                        (tc, tr), torch.from_numpy(pos))
        assert (c2.data_ptr(), r2.data_ptr()) == ptrs
        changed = (tc != before).any(-1)
        for b in range(B):
            assert changed[b].nonzero().flatten().tolist() == [pos[b]]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4, err_msg=f"step {step}")
        pos = pos + 1
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_matches_jax_float32(pair32):
    """``forward_with_stats`` against ``repro.models.forward``: hidden
    states at 1e-4, ``expert_load`` exactly, summing to tokens x top-k x
    the 3 MoE layers (the prelude is dense)."""
    jcfg, tcfg, jparams, tparams = pair32
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jh, jst = jax_forward(jparams, jcfg, jnp.asarray(toks))
    th, tst = forward_with_stats(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tst["expert_load"].numpy(),
                                  np.asarray(jst["expert_load"]))
    assert int(tst["expert_load"].sum()) == 2 * 20 * jcfg.moe_top_k * 3
    assert torch.equal(forward(tparams, tcfg, torch.from_numpy(toks)), th)


def test_forward_bfloat16_against_each_own_float32():
    """bf16 ``forward``: each package against its own float32 as
    ``test_torch_models.py`` holds the dense family (x1.25, mean and
    max; the two bf16 results within 5e-2 of each other's scale)."""
    toks = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(
        np.int32)
    out = {}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jcfg, tcfg, jparams, tparams = _pair("q_lora", jdt, tdt)
        jh, _ = jax_forward(jparams, jcfg, jnp.asarray(toks))
        th = forward(tparams, tcfg, torch.from_numpy(toks))
        assert th.dtype == tdt
        out[tdt] = (np.asarray(jh.astype(jnp.float32)), th.float().numpy())
    (j32, t32), (j16, t16) = out[torch.float32], out[torch.bfloat16]
    ref_j, ref_t = np.abs(j16 - j32), np.abs(t16 - t32)
    assert ref_t.mean() <= 1.25 * ref_j.mean()
    assert ref_t.max() <= 1.25 * ref_j.max()
    assert np.abs(t16 - j16).mean() <= ref_j.mean() * 1.25


def test_init_cache_holds_the_latent_rows(pair32):
    """Every layer's cache is ``{lat_c, lat_r}`` with the reference's
    shapes: kv_lora_rank + qk_rope_dim values per token, for all heads."""
    jcfg, tcfg, jparams, tparams = pair32
    tc = init_cache(tparams, tcfg, 3, 16, pos_per_slot=True)
    jc = jax_init_cache(jparams, jcfg, 3, 16, pos_per_slot=True)
    want = _jax_layers(jcfg, jc)
    for layer, ref in zip(tc["layers"], want):
        assert set(layer) == {"lat_c", "lat_r"} == set(ref)
        for n in layer:
            assert tuple(layer[n].shape) == tuple(ref[n].shape)
            assert layer[n].dtype == torch.float32 and not layer[n].any()
    assert tc["layers"][0]["lat_c"].shape == (3, 16, tcfg.kv_lora_rank)
    assert tc["pos"].shape == (3,)


def test_decode_step_matches_jax(pair32):
    """Ten ``decode_step``s at per-slot positions: logits at 1e-4 every
    step, every layer's latent cache at 1e-5."""
    jcfg, tcfg, jparams, tparams = pair32
    B, steps, max_seq = len(START_POS), 10, 24
    jcache = jax_init_cache(jparams, jcfg, B, max_seq, pos_per_slot=True)
    jcache["pos"] = jnp.asarray(START_POS, jnp.int32)
    tcache = init_cache(tparams, tcfg, B, max_seq, pos_per_slot=True)
    tcache["pos"] = torch.tensor(START_POS, dtype=torch.int32)
    step = jax.jit(lambda p, c, t: jax_decode_step(p, jcfg, c, t))
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (steps, B, 1)).astype(np.int32)
    for i in range(steps):
        j, jcache = step(jparams, jcache, jnp.asarray(toks[i]))
        t, tcache = decode_step(tparams, tcfg, tcache,
                                torch.from_numpy(toks[i]))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4, err_msg=f"step {i}")
    for layer, ref in zip(tcache["layers"], _jax_layers(jcfg, jcache)):
        for n in ("lat_c", "lat_r"):
            np.testing.assert_allclose(layer[n].numpy(), np.asarray(ref[n]),
                                       rtol=0, atol=1e-5)


def _scan(jcfg, jparams, jcache, toks, lengths):
    """The JAX engine's prefill: the decode step scanned over the bucket,
    the logits kept at each row's ``lengths - 1``."""
    step = jax.jit(lambda p, c, t: jax_decode_step(p, jcfg, c, t))
    last = np.zeros((toks.shape[0], jcfg.vocab_size), np.float32)
    for i in range(toks.shape[1]):
        logits, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        last = np.where((np.asarray(lengths) - 1 == i)[:, None],
                        np.asarray(logits[:, -1]), last)
    return last, jcache


def _latent_rows(jcfg, jcache):
    """{leaf: (L, B, S, ...) numpy} of the JAX cache's latent rows."""
    layers = _jax_layers(jcfg, jcache)
    return {n: np.stack([np.asarray(c[n]) for c in layers])
            for n in ("lat_c", "lat_r")}


def test_prefill_matches_the_jax_engines_scan(pair32):
    """k=2 ragged prompts padded to a bucket of 8, one pass: logits at
    ``lengths - 1`` at 1e-4, every latent row of every layer at 1e-5."""
    jcfg, tcfg, jparams, tparams = pair32
    lengths = np.array([5, 8], np.int32)
    rng = np.random.default_rng(4)
    toks = np.zeros((2, 8), np.int32)
    for r, n in enumerate(lengths):
        toks[r, :n] = rng.integers(1, jcfg.vocab_size, n)
    jcache = jax_init_cache(jparams, jcfg, 2, 14, pos_per_slot=True)
    last, jcache = _scan(jcfg, jparams, jcache, toks, lengths)
    tcache = init_cache(tparams, tcfg, 2, 14, pos_per_slot=True)
    got, tcache = prefill(tparams, tcfg, tcache, torch.from_numpy(toks),
                          torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), last, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(), [8, 8])
    want = _latent_rows(jcfg, jcache)
    for n, stack in want.items():
        for layer in range(jcfg.num_layers):
            np.testing.assert_allclose(
                tcache["layers"][layer][n].numpy(), stack[layer], rtol=0,
                atol=1e-5, err_msg=f"layer {layer} {n}")


@pytest.mark.parametrize("max_seq,bucket,prompts,prefix", [
    (20, 8, (9, 7), (4, 2)),
    # a span that runs past max_seq: its pad rows are dropped, and the
    # up-projected keys stop at the cache's end
    (20, 16, (14, 10), (8, 0))])
def test_warm_prefill_matches_the_jax_engines_scan(pair32, max_seq, bucket,
                                                   prompts, prefix):
    """The warm one pass (suffix latent rows written after each row's
    cached prefix rows, the cache's rows up-projected, one launch per layer
    at the rows' offsets) against the JAX engine's ``load_prefix`` + decode
    scan: logits at 1e-4, every real latent row at 1e-5, and the warm rows
    equal the cold prompt's rows."""
    jcfg, tcfg, jparams, tparams = pair32
    k = len(prompts)
    rng = np.random.default_rng(6)
    full = [rng.integers(1, jcfg.vocab_size, n) for n in prompts]
    toks = np.zeros((k, max(prompts)), np.int32)
    for r, p in enumerate(full):
        toks[r, :len(p)] = p
    jcold = jax_init_cache(jparams, jcfg, k, max_seq, pos_per_slot=True)
    _, jcold = _scan(jcfg, jparams, jcold, toks, [1] * k)
    cold = _latent_rows(jcfg, jcold)

    keep = np.arange(max_seq)[None, :, None] < np.asarray(prefix)[:, None,
                                                                   None]
    slabs = {n: np.where(keep[None], cold[n], 0).astype(np.float32)
             for n in cold}
    jwarm = jax_init_cache(jparams, jcfg, k, max_seq, pos_per_slot=True)
    jwarm["prelude_0"] = {n: jnp.asarray(slabs[n][0]) for n in slabs}
    jwarm["layers"]["slot_0"] = {n: jnp.asarray(slabs[n][1:]) for n in slabs}
    jwarm["pos"] = jnp.asarray(prefix, jnp.int32)
    suffix = np.zeros((k, bucket), np.int32)
    lengths = np.array([n - p for n, p in zip(prompts, prefix)], np.int32)
    for r, (p, o) in enumerate(zip(full, prefix)):
        suffix[r, :len(p) - o] = p[o:]
    last, jwarm = _scan(jcfg, jparams, jwarm, suffix, lengths)

    tcache = init_cache(tparams, tcfg, k, max_seq, pos_per_slot=True)
    for layer, c in enumerate(tcache["layers"]):
        for n in slabs:
            c[n].copy_(torch.from_numpy(slabs[n][layer]))
    got, tcache = prefill(tparams, tcfg, tcache, torch.from_numpy(suffix),
                          torch.from_numpy(lengths),
                          torch.tensor(prefix, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), last, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(prefix) + bucket)
    want = _latent_rows(jcfg, jwarm)
    for n in want:
        for layer in range(jcfg.num_layers):
            for r, plen in enumerate(prompts):
                got_rows = tcache["layers"][layer][n][r, :plen].numpy()
                np.testing.assert_allclose(got_rows, want[n][layer, r, :plen],
                                           rtol=0, atol=1e-5)
                np.testing.assert_allclose(got_rows, cold[n][layer, r, :plen],
                                           rtol=0, atol=1e-5)


def test_one_pass_prefill_matches_the_ports_decode_loop(pair32):
    """The port's one-pass prefill against its own decode step run over
    the bucket: logits and every latent row at 1e-5."""
    jcfg, tcfg, _, tparams = pair32
    toks = np.random.default_rng(9).integers(1, 512, (3, 8)).astype(np.int32)
    lengths = torch.tensor([8, 3, 6], dtype=torch.int32)
    loop = init_cache(tparams, tcfg, 3, 12, pos_per_slot=True)
    last = torch.zeros((3, tcfg.vocab_size))
    for i in range(8):
        logits, loop = decode_step(tparams, tcfg, loop,
                                   torch.from_numpy(toks[:, i:i + 1]))
        last = torch.where((lengths - 1 == i)[:, None], logits[:, -1], last)
    one = init_cache(tparams, tcfg, 3, 12, pos_per_slot=True)
    got, one = prefill(tparams, tcfg, one, torch.from_numpy(toks), lengths)
    torch.testing.assert_close(got, last, rtol=0, atol=1e-5)
    for a, b in zip(one["layers"], loop["layers"]):
        for n in ("lat_c", "lat_r"):
            torch.testing.assert_close(a[n], b[n], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_matches_jax_engine(temperature):
    """The port's engine (one-pass MLA prefill) against the JAX engine
    (decode scan), cache off, on the f32 smoke model over the serving
    tests' trace: the same tokens, slots, stop steps and buckets, logprob
    sums within 1e-4, equal ``EngineStats``."""
    from test_torch_serving import TRACE, _jax_engine, _port_engine, _serve

    weights = _pair()
    over = dict(temperature=temperature, seed=2, eos_id=-1)
    jeng, teng = _jax_engine(weights, **over), _port_engine(weights, **over)
    want, got = _serve(jeng, TRACE), _serve(teng, TRACE)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert (g.stopped, g.slot, g.stop_step, g.bucket) == \
            (w.stopped, w.slot, w.stop_step, w.bucket)
        assert abs(g.logprob_sum - w.logprob_sum) <= 1e-4
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)


def test_prefix_engine_matches_the_jax_prefix_engine():
    """Both engines with the radix prefix cache on over the serving tests'
    shared-prefix trace: the engine copies the latent leaves between the
    trie and the slots by axis 1 as it copies K/V.  Same tokens, slots,
    stop steps and buckets, logprob sums within 1e-4, equal engine and
    prefix-cache stats and resident bytes, and warm == cold tokens."""
    from test_torch_serving import (PREFIX_TRACE, _jax_prefix_engine,
                                    _port_prefix_engine, _serve_clocked,
                                    _StepClock)

    weights = _pair()
    over = dict(temperature=0.0, eos_id=-1, seed=3)
    jclock, tclock, cclock = _StepClock(), _StepClock(), _StepClock()
    jeng = _jax_prefix_engine(weights, jclock, **over)
    teng = _port_prefix_engine(weights, tclock, **over)
    cold = _port_prefix_engine(weights, cclock, prefix_cache=False, **over)
    want = _serve_clocked(jeng, jclock, PREFIX_TRACE)
    got = _serve_clocked(teng, tclock, PREFIX_TRACE)
    base = _serve_clocked(cold, cclock, PREFIX_TRACE)
    for w, g, c in zip(want, got, base):
        assert g.tokens == w.tokens == c.tokens, (g.uid, g.tokens, w.tokens)
        assert (g.slot, g.stop_step, g.bucket) == (w.slot, w.stop_step,
                                                    w.bucket)
        assert abs(g.logprob_sum - w.logprob_sum) <= 1e-4
    assert teng.prefix.stats.hits >= 5
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert dataclasses.asdict(teng.prefix.stats) == \
        dataclasses.asdict(jeng.prefix.stats)
    assert teng.prefix.accounted_bytes() == teng.prefix.total_bytes == \
        jeng.prefix.total_bytes


def test_expert_load_matches_jax():
    """``expert_load`` over a forward of the f32 smoke model: the
    reference's counts exactly, in both variants and at another seed."""
    for variant, seed in (("q_lora", 1), ("no_q_lora", 2)):
        jcfg, tcfg, jparams, tparams = _pair(variant, seed=seed)
        toks = np.random.default_rng(seed).integers(
            0, jcfg.vocab_size, (3, 16)).astype(np.int32)
        _, jst = jax_forward(jparams, jcfg, jnp.asarray(toks))
        _, tst = forward_with_stats(tparams, tcfg, torch.from_numpy(toks))
        np.testing.assert_array_equal(tst["expert_load"].numpy(),
                                      np.asarray(jst["expert_load"]))
        assert int(tst["dropped"]) == int(jst["dropped"]) == 0
