"""The port's MoE family against the JAX package's, on the same inputs.

Layer level (``repro_torch.models.moe`` against ``repro.models.moe`` on the
qwen2-moe-a2.7b smoke config's first layer, JAX-initialised and carried over
by ``params_from_jax``): ``route`` ids exactly and gates at atol 1e-6 in
float32, with and without ``norm_topk_prob``; ``moe_ffn_local`` at atol 1e-5
in float32 with ``expert_load`` and ``dropped`` exactly equal; in bf16
within two bf16 ulps of the largest output, on the tokens whose k-th and
(k+1)-th router scores differ by more than 1e-3 (the others may pick another
expert under another summation order; they are counted).  The
grouped product (``grouped_mm``) equals its per-expert loop bit for bit on
the CPU, and the combine adds each token's contributions in ascending expert
id in the activation dtype.

Model level (4 layers, float32, as ``tests/test_torch_models.py`` holds the
dense family): ``forward_with_stats`` against ``repro.models.forward`` (the
hidden states at atol 1e-4, the stats exactly); ``prefill`` cold and warm
against the JAX engine's decode scan; ``decode_step`` for 6 steps at
per-slot positions; the port's engine against the JAX engine token for
token at the same slot and batch composition.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.models.transformer import param_shapes as jax_param_shapes
from repro_torch.configs import get_config
from repro_torch.core.calibration import default_calibration, use_calibration
from repro_torch.models import (decode_step, forward, forward_with_stats,
                                init_cache, init_params, moe, num_params,
                                params_from_jax)
from test_torch_models import (START_POS, _check_cold_prefill,
                               _check_warm_prefill, _jax_layer_kv,
                               _port_config)

ARCH = "qwen2-moe-a2.7b"
TIE_MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _shipped_calibration():
    with use_calibration(default_calibration()):
        yield


def _moe_pair(jdtype=jnp.float32, tdtype=torch.float32, seed=0, **over):
    """The smoke config (8 experts, 1 pad, top-2, 2 shared, QKV bias) on
    both sides with ``over`` applied, JAX weights carried over; the QKV
    biases (zero at init) drawn so that they count."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=jdtype, **over)
    tcfg = _port_config(jcfg, tdtype)
    assert tcfg == dataclasses.replace(get_config(ARCH, smoke=True),
                                       dtype=tdtype, **over)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    mix = jparams["layers"]["slot_0"]["mix"]
    for name in ("bq", "bk", "bv"):
        mix[name] = rng.normal(scale=0.1, size=mix[name].shape).astype(
            mix[name].dtype)
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    return jcfg, tcfg, jparams, tparams


def _layer0_ffn(jparams):
    return jax.tree_util.tree_map(lambda a: a[0],
                                  jparams["layers"]["slot_0"]["ffn"])


def _tokens(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def pair32():
    return _moe_pair()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_route_matches_jax(norm_topk_prob):
    jcfg, tcfg, jparams, tparams = _moe_pair(norm_topk_prob=norm_topk_prob)
    x = _tokens(300, jcfg.d_model, 1)
    je, jw = jax_moe.route(_layer0_ffn(jparams), jcfg, jnp.asarray(x))
    te, tw = moe.route(tparams["layers"][0]["ffn"], tcfg, torch.from_numpy(x))
    assert te.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    if norm_topk_prob:
        np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)


def test_moe_ffn_local_matches_jax_float32(pair32):
    jcfg, tcfg, jparams, tparams = pair32
    x = _tokens(3 * 40, jcfg.d_model, 2).reshape(3, 40, -1)
    jout, jst = jax_moe.moe_ffn_local(_layer0_ffn(jparams), jcfg,
                                      jnp.asarray(x))
    tout, tst = moe.moe_ffn_local(tparams["layers"][0]["ffn"], tcfg,
                                  torch.from_numpy(x))
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    assert tst["expert_load"].dtype == tst["dropped"].dtype == torch.int32
    np.testing.assert_array_equal(tst["expert_load"].numpy(),
                                  np.asarray(jst["expert_load"]))
    assert int(tst["dropped"]) == int(jst["dropped"]) == 0
    assert int(tst["expert_load"].sum()) == 3 * 40 * tcfg.moe_top_k


def test_moe_ffn_local_matches_jax_bfloat16():
    """bf16 weights and inputs on both sides: routing ids equal on the
    tokens whose k-th and (k+1)-th scores differ by more than TIE_MARGIN
    (the rest counted: at most 5%); there the outputs agree within two bf16
    ulps of the largest output and 4e-3 on average (XLA keeps excess
    precision inside fused chains, so over half the elements differ by an
    ulp), and the port's bf16 is no further from its own float32 run on the
    same bf16 values than the JAX package's (x1.25)."""
    jcfg, tcfg, jparams, tparams = _moe_pair(jnp.bfloat16, torch.bfloat16)
    x = _tokens(4 * 32, jcfg.d_model, 3)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    jp, tp = _layer0_ffn(jparams), tparams["layers"][0]["ffn"]
    logits = np.asarray(jx.astype(jnp.float32)) @ \
        np.asarray(jp["router"].astype(jnp.float32))
    logits[:, -jcfg.num_padded_experts:] = -1e30
    scores = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits))), -1)
    k = jcfg.moe_top_k
    clear = scores[:, -k] - scores[:, -k - 1] > TIE_MARGIN
    assert clear.mean() >= 0.95, clear.mean()
    je, _ = jax_moe.route(jp, jcfg, jx)
    te, _ = moe.route(tp, tcfg, tx)
    np.testing.assert_array_equal(te.numpy()[clear], np.asarray(je)[clear])

    def outputs(jdt, tdt):
        jc = dataclasses.replace(jcfg, dtype=jdt)
        tc = dataclasses.replace(tcfg, dtype=tdt)
        jo, _ = jax_moe.moe_ffn_local(
            jax.tree_util.tree_map(lambda a: a.astype(jdt), jp), jc,
            jx[None].astype(jdt))
        to, _ = moe.moe_ffn_local(
            {n: (v.to(tdt) if torch.is_tensor(v) else
                 {m: w.to(tdt) for m, w in v.items()})
             for n, v in tp.items()}, tc, tx[None].to(tdt))
        assert to.dtype == tdt
        return (np.asarray(jo[0].astype(jnp.float32))[clear],
                to[0].float().numpy()[clear])

    jout, tout = outputs(jnp.bfloat16, torch.bfloat16)
    j32, t32 = outputs(jnp.float32, torch.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jout).max())) - 7)
    diff = np.abs(tout - jout)
    assert diff.max() <= 2 * ulp and diff.mean() <= 4e-3, (diff.max(), ulp)
    ej, et = np.abs(jout - j32), np.abs(tout - t32)
    assert et.mean() <= 1.25 * ej.mean() and et.max() <= 1.25 * ej.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_product_equals_the_per_expert_loop(dtype):
    """``expert_compute`` (grouped_mm) against ``expert_compute_plain`` (one
    matmul per expert), empty groups included: bit for bit on the CPU."""
    _, tcfg, _, tparams = _moe_pair(tdtype=dtype)
    p = tparams["layers"][1]["ffn"]
    gs = torch.tensor([5, 0, 9, 1, 0, 12, 3, 0], dtype=torch.int32)
    gen = torch.Generator().manual_seed(4)
    xbuf = torch.randn((int(gs.sum()), tcfg.d_model), generator=gen).to(dtype)
    before = moe.expert_compute.calls
    got = moe.expert_compute(p, xbuf, gs)
    assert moe.expert_compute.calls == before + 1
    want = moe.expert_compute_plain(p, xbuf, gs)
    assert got.dtype == dtype and got.shape == (xbuf.shape[0], tcfg.d_model)
    assert torch.equal(got, want)


def test_combine_adds_in_ascending_expert_order():
    """bf16: each token's gate-scaled contributions summed in ascending
    expert id, one bf16 rounding per add (the order the reference's
    scatter meets them), bit for bit; the same as the JAX package's
    scatter-add on these inputs."""
    jcfg, tcfg, jparams, tparams = _moe_pair(jnp.bfloat16, torch.bfloat16,
                                             moe_top_k=4,
                                             num_padded_experts=0)
    p = tparams["layers"][0]["ffn"]
    T, k = 64, 4
    xf = torch.from_numpy(_tokens(T, tcfg.d_model, 5)).bfloat16()
    xbuf, gs, order, top_w = moe.dispatch(p, tcfg, xf)
    out_buf = moe.expert_compute(p, xbuf, gs)
    got = moe.combine(out_buf, order, top_w)

    top_e, _ = moe.route(p, tcfg, xf)
    w = top_w.reshape(-1)[order].bfloat16()
    contrib = out_buf * w[:, None]
    tok = (order // k).tolist()
    want = torch.zeros_like(xf)
    for pos in range(T * k):                 # the sorted buffer's order
        want[tok[pos]] = want[tok[pos]] + contrib[pos]
    assert torch.equal(got, want)
    # every token's experts appear in ascending id along the sorted buffer
    experts = torch.sort(top_e, -1).values.reshape(-1)[order]
    seen = {}
    for pos in range(T * k):
        assert experts[pos] > seen.get(tok[pos], -1)
        seen[tok[pos]] = int(experts[pos])
    jflat = jnp.asarray(np.asarray(contrib.float()), jnp.bfloat16)
    jout = jnp.zeros((T, tcfg.d_model), jnp.bfloat16).at[
        jnp.asarray(tok)].add(jflat)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))


def test_pad_experts_are_never_routed():
    """Pad columns of the router pushed far above every live expert: the
    mask still keeps them out (ids and ``expert_load``), as in the JAX
    package."""
    jcfg, tcfg, jparams, tparams = _moe_pair()
    pad = jcfg.num_padded_experts
    E = jcfg.num_experts
    jp = dict(_layer0_ffn(jparams))
    router = np.array(jp["router"])
    router[:, E - pad:] = 50.0
    jp["router"] = jnp.asarray(router)
    tp = dict(tparams["layers"][0]["ffn"], router=torch.from_numpy(router))
    x = np.abs(_tokens(2 * 50, jcfg.d_model, 6)).reshape(2, 50, -1)
    _, tst = moe.moe_ffn_local(tp, tcfg, torch.from_numpy(x))
    _, jst = jax_moe.moe_ffn_local(jp, jcfg, jnp.asarray(x))
    load = tst["expert_load"].numpy()
    assert (load[E - pad:] == 0).all() and load.sum() == 100 * jcfg.moe_top_k
    np.testing.assert_array_equal(load, np.asarray(jst["expert_load"]))
    te, _ = moe.route(tp, tcfg, torch.from_numpy(x.reshape(100, -1)))
    assert int(te.max()) < E - pad


def test_moe_ffn_refuses_a_mesh(pair32):
    """A mesh without a ``model`` axis runs ``moe_ffn_local``, as the JAX
    package's ``moe_ffn`` does (the expert-parallel strategies are held
    against the JAX package's in ``tests/test_torch_tp.py``)."""
    _, tcfg, _, tparams = pair32
    ffn = tparams["layers"][0]["ffn"]
    x = torch.from_numpy(_tokens(6, tcfg.d_model, 7)).reshape(2, 3, -1)
    want, wst = moe.moe_ffn_local(ffn, tcfg, x)
    for mesh in (object(), {"data": 2}, {"data": 2, "model": 1}):
        out, st = moe.moe_ffn(ffn, tcfg, x, mesh=mesh, impl="a2a")
        assert torch.equal(out, want)
        assert torch.equal(st["expert_load"], wst["expert_load"])
    with pytest.raises(ValueError):
        moe.moe_ffn(ffn, tcfg, x, mesh={"model": 2}, impl="bogus")


# ---------------------------------------------------------------------------
# weights and shapes
# ---------------------------------------------------------------------------

def test_params_carry_over_leaf_for_leaf(pair32):
    jcfg, _, jparams, tparams = pair32
    assert len(tparams["layers"]) == jcfg.num_layers == 4
    jl = jparams["layers"]["slot_0"]
    for layer in range(jcfg.num_layers):
        ffn = tparams["layers"][layer]["ffn"]
        assert sorted(ffn) == ["router", "shared", "we_down", "we_gate",
                               "we_up"]
        for name in ("router", "we_gate", "we_up", "we_down"):
            np.testing.assert_array_equal(ffn[name].numpy(),
                                          np.asarray(jl["ffn"][name][layer]))
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                ffn["shared"][name].numpy(),
                np.asarray(jl["ffn"]["shared"][name][layer]))
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert num_params(tparams) == n_jax


@pytest.mark.parametrize("smoke", [True, False])
def test_init_params_shapes_match_jax(smoke):
    """The port's random init (on the meta device at full width: 24 layers,
    64 experts of 2048 x 1408) has the JAX package's shapes, leaf for leaf
    per layer, and its parameter counts."""
    jcfg = jax_get_config(ARCH, smoke=smoke)
    tcfg = get_config(ARCH, smoke=smoke)
    shapes = jax_param_shapes(jcfg)
    tparams = init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu" if smoke else "meta")
    stacked = shapes["layers"]["slot_0"]
    assert len(tparams["layers"]) == jcfg.num_layers
    for layer in tparams["layers"]:
        got = jax.tree_util.tree_map(lambda t: tuple(t.shape), layer)
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape[1:]), stacked)
        assert got == want
    assert tuple(tparams["lm_head"].shape) == shapes["lm_head"].shape
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.num_active_params() == jcfg.num_active_params()
    if smoke:
        w = tparams["layers"][0]["ffn"]
        assert abs(float(w["we_down"].float().std()) -
                   1 / np.sqrt(tcfg.d_ff_expert)) < 0.01
        assert abs(float(w["we_gate"].float().std()) -
                   1 / np.sqrt(tcfg.d_model)) < 0.01


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_with_stats_matches_jax(pair32):
    jcfg, tcfg, jparams, tparams = pair32
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jh, jst = jax_forward(jparams, jcfg, jnp.asarray(toks))
    th, tst = forward_with_stats(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tst["expert_load"].numpy(),
                                  np.asarray(jst["expert_load"]))
    assert int(tst["dropped"]) == int(jst["dropped"])
    assert int(tst["expert_load"].sum()) == \
        2 * 20 * jcfg.moe_top_k * jcfg.num_layers
    assert torch.equal(forward(tparams, tcfg, torch.from_numpy(toks)), th)


def test_prefill_matches_the_jax_engines_scan(pair32):
    _check_cold_prefill(pair32, bucket=8, max_seq=14, lengths=(5, 8))


def test_warm_prefill_matches_the_jax_engines_scan(pair32):
    _check_warm_prefill(pair32, max_seq=20, bucket=8, prompts=(9, 7),
                        prefix=(4, 2))


def test_decode_step_matches_jax(pair32):
    """6 steps at per-slot positions (0, 3, 7): logits at 1e-4 every step,
    every layer's cache at 1e-4."""
    jcfg, tcfg, jparams, tparams = pair32
    B, steps, max_seq = len(START_POS), 6, 16
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
        assert t.dtype == torch.float32 and t.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4, err_msg=f"step {i}")
    for name in ("k", "v"):
        want = _jax_layer_kv(jcache, jcfg, name)
        for layer in range(jcfg.num_layers):
            np.testing.assert_allclose(
                tcache["layers"][layer][name].numpy(), want[layer], rtol=0,
                atol=1e-4, err_msg=f"layer {layer} {name}")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_matches_jax_engine(pair32, temperature):
    """The port's engine (one-pass prefill) against the JAX engine (decode
    scan), cache off, on the f32 smoke model over the serving tests' trace:
    the same tokens, stop flags, slots, stop steps and buckets, logprob sums
    within 1e-4, equal ``EngineStats``."""
    from test_torch_serving import TRACE, _jax_engine, _port_engine, _serve

    weights = pair32
    over = dict(temperature=temperature, seed=2, eos_id=-1)
    jeng, teng = _jax_engine(weights, **over), _port_engine(weights, **over)
    want, got = _serve(jeng, TRACE), _serve(teng, TRACE)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert (g.stopped, g.slot, g.stop_step, g.bucket) == \
            (w.stopped, w.slot, w.stop_step, w.bucket)
        assert abs(g.logprob_sum - w.logprob_sum) <= 1e-4
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.stats.slot_reuses >= 1


def test_cli_serves_the_moe_smoke_model_on_the_cpu(capsys):
    """``--arch qwen2-moe-a2.7b --device cpu`` (the smoke config): every
    request completes and the summary prints."""
    from repro_torch.launch.serve import run_cli

    before = moe.expert_compute.calls
    run = run_cli(["--arch", ARCH, "--device", "cpu", "--requests", "5",
                   "--slots", "2", "--buckets", "8,16", "--min-prompt", "4",
                   "--max-prompt", "16", "--gen", "4", "--rate", "0",
                   "--temperature", "0"])
    out = capsys.readouterr().out
    for line in (f"arch={ARCH} device=cpu", "served 5 requests",
                 "flash_attention.launches=0", "program shapes:",
                 "prefix cache: nodes="):
        assert line in out, out
    engine = run["engine"]
    cfg = get_config(ARCH, smoke=True)
    calls = moe.expert_compute.calls - before
    assert calls == cfg.num_layers * (engine.stats.steps +
                                      engine.stats.prefill_calls)
    assert all(1 <= len(r.tokens) <= 4 for r in run["results"])
