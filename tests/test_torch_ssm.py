"""The port's recurrent family vs the JAX package's, on the same weights:
xlstm-1.3b (a period of 7 mLSTM + 1 sLSTM layers, no FFN) and
jamba-v0.1-52b (a period of 7 Mamba + 1 attention layers, dense and MoE
FFNs).

The smoke configs initialised by the JAX package, carried over with
``params_from_jax``.  float32 agrees at atol 1e-4 (the same arithmetic in
another summation order: Mamba's in-chunk prefix compositions come from
the port's log-step ``affine_scan`` where the JAX package runs
``lax.associative_scan``, which brackets differently); the log-step scan
against its sequential loop at 1e-5.  In bf16 each package is held against
its own float32, as ``tests/test_torch_models.py`` holds the dense family.
Decode against the full-sequence forward is held to the reference's own
bound, 2e-2 (``tests/test_models.py``).  The engine is held against the
JAX engine token for token: both prefill a recurrent arch by running the
decode step over the padded bucket, so a prompt shorter than its bucket
folds its pad tokens into the state on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as jssm
from repro.models.transformer import positional_cache as jax_positional_cache
from repro_torch import configs
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, num_params, params_from_jax,
                                positional_cache, prefill, recurrent, ssm,
                                unembed)

ARCHS = ["xlstm-1.3b", "jamba-v0.1-52b"]
B, S, MAX_SEQ, STEPS = 2, 12, 16, 10
# (arch, layer) of each block in the smoke configs
BLOCKS = {"mamba": ("jamba-v0.1-52b", 0), "mlstm": ("xlstm-1.3b", 0),
          "slstm": ("xlstm-1.3b", 7)}


def _pair(arch, jdtype, tdtype, seed=0, num_layers=None):
    """(jax cfg, port cfg, jax params (jnp), port params, tokens (B, S))."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               dtype=jdtype)
    tcfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                               dtype=tdtype)
    if num_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    jp, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_jax(jp, tcfg, device="cpu")
    toks = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, jp), tp, toks


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _jax_layer(tree, cfg, i):
    """Layer ``i``'s subtree of a JAX params or cache tree (stacked periods
    of ``cfg.period`` slots, no prelude or remainder here)."""
    P = cfg.period
    return jax.tree_util.tree_map(lambda a: a[i // P],
                                  tree["layers"][f"slot_{i % P}"])


def _assert_same_tree(port, ref, path="", atol=None):
    """Same dict keys all the way down; leaves equal (``atol=None``) or
    within ``atol``."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for key in ref:
            _assert_same_tree(port[key], ref[key], f"{path}/{key}", atol)
        return
    got, want = _np(port), _np(ref)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if atol is None:
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    return _pair(request.param, jnp.float32, torch.float32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,periods", [("xlstm-1.3b", 6),
                                          ("jamba-v0.1-52b", 4)])
def test_params_carry_over_leaf_for_leaf(arch, periods):
    """The smoke width at the full config's depth (xlstm 6 periods of 8,
    jamba 4): every leaf of every layer in layer order (``A_log``,
    ``D_skip``, ``dt_bias``, ``b_if``, ``ln_g``, ``w_h``, jamba's MoE on
    the odd slots), no ``norm2`` / ``ffn`` where the FFN is ``none``."""
    full = configs.get_config(arch)
    assert full.num_layers == periods * full.period
    jcfg, tcfg, jp, tp, _ = _pair(arch, jnp.float32, torch.float32,
                                  num_layers=full.num_layers)
    assert len(tp["layers"]) == full.num_layers
    for i, layer in enumerate(tp["layers"]):
        _assert_same_tree(layer, _jax_layer(jp, jcfg, i), f"layer {i}")
        assert ("ffn" in layer) == (tcfg.ffn_type(i) != "none")
        if tcfg.ffn_type(i) == "moe":
            assert layer["ffn"]["we_up"].shape[0] == tcfg.num_experts
    rest = {k: v for k, v in jp.items() if k != "layers"}
    _assert_same_tree({k: tp[k] for k in rest}, rest)
    assert num_params(tp) == sum(x.size for x in
                                 jax.tree_util.tree_leaves(jp))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_scales_match_jax(arch):
    """Random init from a torch.Generator: the JAX tree's structure, shapes
    and dtype, ``std = 1/sqrt(fan_in)``, ``A_log`` / ``dt_bias`` / ``b_if``
    at zero, ``D_skip`` / ``ln_g`` at one; the full config's parameter
    count is the JAX package's (3.57 B and 51.6 B)."""
    jcfg, tcfg, jp, _, _ = _pair(arch, jnp.bfloat16, torch.bfloat16)
    tp = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    like = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")

    def leaves(tree):
        flat, _ = torch.utils._pytree.tree_flatten_with_path(tree)
        return {torch.utils._pytree.keystr(k): v for k, v in flat}

    got, want = leaves(tp), leaves(like)
    assert set(got) == set(want)
    for key, a in got.items():
        assert a.shape == want[key].shape, key
        assert a.dtype == want[key].dtype == torch.bfloat16
    D = tcfg.d_model
    for i, layer in enumerate(tp["layers"]):
        mix = layer["mix"]
        if tcfg.block_type(i) == "mamba":
            for name in ("A_log", "dt_bias", "conv_b"):
                assert not mix[name].any()
            assert bool((mix["D_skip"] == 1).all())
            assert abs(float(mix["w_in"].float().std()) - D ** -0.5) < 0.02
        elif tcfg.block_type(i) == "mlstm":
            assert not mix["b_if"].any()
            assert bool((mix["ln_g"] == 1).all())
            DI = mix["wq"].shape[0]
            assert abs(float(mix["wq"].float().std()) - DI ** -0.5) < 0.01
        elif tcfg.block_type(i) == "slstm":
            hd = mix["w_h"].shape[1]
            assert abs(float(mix["w_h"].float().std()) - hd ** -0.5) < 0.03
    assert tcfg.num_params() == num_params(tp)
    assert configs.get_config(arch).num_params() == \
        jconfigs.get_config(arch).num_params()


# ---------------------------------------------------------------------------
# the scan and the three blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 13, 16])
def test_affine_scan_matches_the_loop(n):
    """The log-step scan against the sequential fold at f32 1e-5, at ragged
    lengths, on Mamba's (B, n, DI, N) layout; and two chunks carried one
    into the next equal one scan over both."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, n, 3, 4))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, n, 3, 4)).astype(np.float32))
    got, want = ssm.affine_scan(a, b), ssm.affine_scan_loop(a, b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
    # across a chunk boundary: the carry at the end of chunk one composes
    # with chunk two's prefixes
    cut = n // 2
    if cut:
        A1, B1 = ssm.affine_scan(a[:, :cut], b[:, :cut])
        A2, B2 = ssm.affine_scan(a[:, cut:], b[:, cut:])
        h = A2 * B1[:, -1:] + B2
        np.testing.assert_allclose(h.numpy(), want[1][:, cut:].numpy(),
                                   rtol=0, atol=1e-5)


def _block(block, dtype=torch.float32):
    arch, i = BLOCKS[block]
    jcfg, tcfg, jp, tp, _ = _pair(arch, jnp.float32, dtype)
    return jcfg, tcfg, _jax_layer(jp, jcfg, i)["mix"], tp["layers"][i]["mix"]


@pytest.mark.parametrize("block,chunk", [("mamba", 256), ("mamba", 8),
                                         ("mlstm", 128), ("mlstm", 8),
                                         ("slstm", None)])
def test_mix_matches_jax(block, chunk):
    """``mamba_mix``, ``mlstm_mix`` and ``slstm_mix`` on the same (B, S, D)
    input at f32 1e-4; a chunk of 8 over S 12 halves to 4, three chunks
    with the carry crossing two boundaries."""
    jcfg, tcfg, jmix, tmix = _block(block)
    x = np.random.default_rng(3).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    kw = {} if chunk is None else {"chunk_size": chunk}
    want = getattr(jssm, f"{block}_mix")(jmix, jcfg, jnp.asarray(x), **kw)
    got = ssm.MIX[block](tmix, tcfg, torch.from_numpy(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_decode_matches_jax_and_updates_the_cache_in_place(block):
    """Ten ``*_decode`` steps: each output and the states after it at 1e-4;
    the states live in the cache's own tensors, written in place."""
    jcfg, tcfg, jmix, tmix = _block(block)
    jcache = getattr(jssm, f"init_{block}_cache")(jcfg, B)
    tcache = ssm.INIT_CACHE[block](tcfg, B, "cpu")
    tensors = dict(tcache)
    step = jax.jit(lambda p, x, c: getattr(jssm, f"{block}_decode")(
        p, jcfg, x, c))
    xs = np.random.default_rng(4).normal(
        size=(STEPS, B, 1, jcfg.d_model)).astype(np.float32)
    for t in range(STEPS):
        want, jcache = step(jmix, jnp.asarray(xs[t]), jcache)
        got, out = ssm.DECODE[block](tmix, tcfg, torch.from_numpy(xs[t]),
                                     tcache)
        assert out is tcache
        assert all(tcache[k] is v for k, v in tensors.items())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4, err_msg=f"step {t}")
        _assert_same_tree(tcache, jcache, f"step {t}", atol=1e-4)
    assert all(float(v.abs().max()) > 0 for v in tcache.values())


def test_mamba_decode_over_a_prompt_equals_mamba_mix():
    """The conv window and the scan state carry token to token: decode over
    S tokens gives ``mamba_mix``'s outputs (f32, 1e-4)."""
    _, tcfg, _, tmix = _block("mamba")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, S, tcfg.d_model)).astype(np.float32))
    full = ssm.mamba_mix(tmix, tcfg, x)
    cache = ssm.init_mamba_cache(tcfg, B, "cpu")
    steps = [ssm.mamba_decode(tmix, tcfg, x[:, t:t + 1], cache)[0]
             for t in range(S)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=0, atol=1e-4)


def test_mlstm_mix_gradient_stays_finite_where_the_decay_overflows():
    """With the forget gates far below zero (``b_if``'s forget half at
    -100) exp of the in-chunk decay above the diagonal overflows float32;
    ``mlstm_mix`` masks the exponent before the exp, so its gradient is
    finite (the JAX package's ``where`` after the exp gives 0 x inf = NaN
    there), its output is the JAX package's (f32, 1e-4), and its
    gradients are those of chunks of one token, which mask nothing (each
    leaf within 1e-4 of its max magnitude)."""
    jcfg, tcfg, jmix, tmix = _block("mlstm")
    H = tcfg.num_heads
    tmix = dict(tmix, b_if=torch.cat([torch.zeros(H),
                                      torch.full((H,), -100.0)]))
    jmix = dict(jmix, b_if=jnp.asarray(tmix["b_if"].numpy()))
    x = np.random.default_rng(6).normal(
        size=(B, S, tcfg.d_model)).astype(np.float32)
    want = jssm.mlstm_mix(jmix, jcfg, jnp.asarray(x))

    def grads(chunk):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in tmix.items()}
        xt = torch.from_numpy(x).requires_grad_()
        out = ssm.mlstm_mix(leaves, tcfg, xt, chunk_size=chunk)
        return out, torch.autograd.grad(out.square().sum(),
                                        [xt, *leaves.values()])
    out, got = grads(128)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    _, ref = grads(1)
    for g, w in zip(got, ref):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= \
            1e-4 * max(float(w.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# forward, cache, decode
# ---------------------------------------------------------------------------

def _forward_both(arch, jdtype, tdtype):
    jcfg, tcfg, jp, tp, toks = _pair(arch, jdtype, tdtype)
    jh, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    th = forward(tp, tcfg, torch.from_numpy(toks))
    assert th.dtype == tdtype and th.shape == (B, S, jcfg.d_model)
    return _np(jh), _np(th)


@pytest.fixture(scope="module", params=ARCHS)
def forward32(request):
    return request.param, _forward_both(request.param, jnp.float32,
                                        torch.float32)


def test_forward_matches_jax_float32(forward32):
    _, (want, got) = forward32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_matches_jax_bfloat16(forward32):
    """Each package's bf16 hidden states against its own float32: the
    port's no further off than the JAX package's (x1.25, mean and max).
    The recurrences carry bf16 rounding from token to token, so each
    package's bf16 is ~0.07 from its float32 on average here (up to ~1.5
    at the worst element), not the dense family's ~0.05; the two bf16
    results, rounded at different points, are on average no further apart
    than that (x1.25 of the JAX package's own mean error)."""
    arch, (want32, got32) = forward32
    want, got = _forward_both(arch, jnp.bfloat16, torch.bfloat16)
    own = np.abs(want - want32)
    assert np.abs(got - got32).mean() <= 1.25 * own.mean()
    assert np.abs(got - got32).max() <= 1.25 * own.max()
    assert np.abs(got - want).mean() <= 1.25 * own.mean()


def test_init_cache_is_the_references(f32):
    """Every layer's state (or K/V rows): the JAX package's keys, shapes,
    dtypes and zeros; ``pos`` per slot."""
    jcfg, tcfg, jp, tp, _ = f32
    jc = jax_init_cache(jp, jcfg, B, MAX_SEQ)
    tc = init_cache(tp, tcfg, B, MAX_SEQ, pos_per_slot=True)
    assert tc["pos"].shape == (B,)
    for i, layer in enumerate(tc["layers"]):
        want = _jax_layer(jc, jcfg, i)
        _assert_same_tree(layer, want, f"layer {i}")
        for key, t in layer.items():
            assert str(t.dtype).split(".")[-1] == str(want[key].dtype), key


@pytest.fixture(scope="module", params=ARCHS)
def decoded(request):
    """STEPS decode steps of both packages: (pair, jax logits, port logits,
    jax cache, port cache)."""
    pair = _pair(request.param, jnp.float32, torch.float32)
    jcfg, tcfg, jp, tp, toks = pair
    jc = jax_init_cache(jp, jcfg, B, MAX_SEQ)
    tc = init_cache(tp, tcfg, B, MAX_SEQ)
    step = jax.jit(lambda p, c, t: jax_decode_step(p, jcfg, c, t))
    jl, tl = [], []
    for i in range(STEPS):
        j, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        t, tc = decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, i:i + 1]))
        assert t.dtype == torch.float32 and t.shape == (B, 1,
                                                        jcfg.vocab_size)
        jl.append(np.asarray(j))
        tl.append(t.numpy())
    return pair, np.concatenate(jl, 1), np.concatenate(tl, 1), jc, tc


def test_decode_steps_match_jax(decoded):
    """Ten steps' logits and every layer's state after them at 1e-4."""
    pair, jl, tl, jc, tc = decoded
    jcfg = pair[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert int(tc["pos"]) == int(jc["pos"]) == STEPS
    for i, layer in enumerate(tc["layers"]):
        _assert_same_tree(layer, _jax_layer(jc, jcfg, i), f"layer {i}",
                          atol=1e-4)


def test_decode_matches_forward(decoded):
    """Token-by-token decode reproduces the full-sequence forward's logits:
    the reference's bound, 2e-2 (``tests/test_models.py``)."""
    pair, _, tl, _, _ = decoded
    _, tcfg, _, tp, toks = pair
    full = unembed(tp, tcfg, forward(tp, tcfg,
                                     torch.from_numpy(toks)[:, :STEPS]))
    assert float((full - torch.from_numpy(tl)).abs().max()) < 2e-2


# ---------------------------------------------------------------------------
# serving: the decode-loop prefill, the engine, what is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_archs_have_no_positional_cache_and_no_prefill(arch):
    """``positional_cache`` is False (the JAX package's too), so the prefix
    cache stays off; ``prefill`` raises, and ``make_backend`` passes
    ``prefill=None``: the engine's decode loop, as the JAX engine's scan."""
    from repro_torch.serving import ServeConfig, build_engine, make_backend

    for smoke in (True, False):
        cfg = configs.get_config(arch, smoke=smoke)
        assert recurrent(cfg)
        assert positional_cache(cfg) is False
        assert jax_positional_cache(jconfigs.get_config(arch, smoke=smoke)) \
            is False
    assert not recurrent(configs.get_config("qwen3-0.6b"))
    _, tcfg, _, tp, toks = _pair(arch, jnp.float32, torch.float32)
    cache = init_cache(tp, tcfg, B, MAX_SEQ)
    with pytest.raises(NotImplementedError, match="no one-pass prefill"):
        prefill(tp, tcfg, cache, torch.from_numpy(toks),
                torch.full((B,), S, dtype=torch.int32))
    backend = make_backend(tcfg, tp, ServeConfig(arch=arch), "cpu")
    assert backend.prefill is None and backend.prefix_sharing is False
    engine = build_engine(ServeConfig(arch=arch, num_slots=2,
                                      prefill_buckets=(8,),
                                      max_new_tokens=3), device="cpu")
    assert engine.prefix is None and engine.backend.prefill is None
    uid = engine.submit([1, 2, 3])
    for _ in engine.run(max_steps=20):
        pass
    assert 1 <= len(engine.result(uid).tokens) <= 3


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    jcfg, tcfg, jp, tp, _ = _pair(request.param, jnp.float32, torch.float32)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_matches_jax_engine(weights, temperature):
    """The port's engine (the decode loop over each bucket) against the JAX
    engine (the decode step scanned over the bucket), cache off, on the f32
    smoke model over the serving tests' trace, whose prompts are shorter
    than their buckets: the same tokens, stop flags, slots, stop steps and
    buckets, logprob sums within 1e-4, equal ``EngineStats``."""
    from test_torch_serving import TRACE, _jax_engine, _port_engine, _serve

    over = dict(temperature=temperature, seed=2, eos_id=-1)
    jeng, teng = _jax_engine(weights, **over), _port_engine(weights, **over)
    assert teng.backend.prefill is None
    want, got = _serve(jeng, TRACE), _serve(teng, TRACE)
    assert any(len(p) < max(teng.config.prefill_buckets)
               for _, p, _ in TRACE)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert (g.stopped, g.slot, g.stop_step, g.bucket) == \
            (w.stopped, w.slot, w.stop_step, w.bucket)
        assert abs(g.logprob_sum - w.logprob_sum) <= 1e-4
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.stats.slot_reuses >= 1


def test_engine_folds_the_pad_tokens_into_the_state(weights):
    """A 2-token prompt in a 4-token bucket: the engine's greedy tokens and
    logprob sum are those of the decode step fed the prompt, then the
    bucket's two pad tokens, then its own tokens from position 2 (the
    slot restarts at its prompt length, so jamba's attention layer writes
    over the pad rows while its Mamba layers keep the pads in their state:
    the reference's behaviour, kept); without the pads the logits after
    the first token differ."""
    from test_torch_serving import _port_engine

    _, tcfg, _, tp = weights
    eng = _port_engine(weights, eos_id=-1, temperature=0.0)
    prompt, bucket = [11, 3], min(eng.config.prefill_buckets)
    uid = eng.submit(prompt, max_new_tokens=5)
    for _ in eng.run(max_steps=20):
        pass
    res = eng.result(uid)

    def greedy(pads):
        """-> (5 greedy tokens, their logprob sum, logits after token 1)."""
        cache = init_cache(tp, tcfg, 1, MAX_SEQ)
        for tok in prompt:
            logits, cache = decode_step(tp, tcfg, cache, torch.tensor([[tok]]))
        for _ in range(pads):
            _, cache = decode_step(tp, tcfg, cache,
                                   torch.tensor([[eng.config.pad_id]]))
        cache["pos"] = torch.full_like(cache["pos"], len(prompt))
        out, logp, seen = [], 0.0, []
        for _ in range(5):
            out.append(int(logits[0, -1].argmax()))
            logp += float(torch.log_softmax(logits[0, -1], -1)[out[-1]])
            logits, cache = decode_step(tp, tcfg, cache,
                                        torch.tensor([[out[-1]]]))
            seen.append(logits)
        return out, logp, seen[0]

    tokens, logp, after_pads = greedy(bucket - len(prompt))
    assert res.tokens == tokens and abs(res.logprob_sum - logp) <= 1e-4
    _, _, no_pads = greedy(0)
    assert float((after_pads - no_pads).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_build_serve_step_is_the_fixed_shape_decode_step(arch):
    from repro_torch.serving import ServeConfig, build_serve_step

    config = ServeConfig(arch=arch, num_slots=2, seed=3)
    cfg, built, params, make_cache = build_serve_step(config, device="cpu")
    cache, again = make_cache(), make_cache()
    tok = torch.ones((2, 1), dtype=torch.int32)
    logits, cache = built.fn(params, cache, tok)
    want, _ = decode_step(params, cfg, again, tok)
    assert logits.shape == (2, 1, cfg.vocab_size) and int(cache["pos"]) == 1
    assert torch.equal(logits, want)


def test_cli_serves_the_xlstm_smoke_model_on_the_cpu(capsys):
    """``--arch xlstm-1.3b --device cpu`` (the smoke config): every request
    completes, no attention launch, no prefix-cache line."""
    from repro_torch.launch.serve import run_cli

    run = run_cli(["--arch", "xlstm-1.3b", "--device", "cpu", "--requests",
                   "4", "--slots", "2", "--buckets", "4,8", "--min-prompt",
                   "2", "--max-prompt", "8", "--gen", "3", "--rate", "0",
                   "--temperature", "0"])
    out = capsys.readouterr().out
    for line in ("arch=xlstm-1.3b device=cpu", "served 4 requests",
                 "flash_attention.launches=0", "program shapes:"):
        assert line in out, out
    assert "prefix cache: nodes=" not in out
    assert all(1 <= len(r.tokens) <= 3 for r in run["results"])
