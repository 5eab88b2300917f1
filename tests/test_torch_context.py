"""The port's context-conditioned family vs the JAX package's, on the same
weights: whisper-small (an encoder over stub frame embeddings, and a decoder
whose every layer cross-attends) and llama-3.2-vision-90b (a period of 4
self-attention + 1 gated cross-attention layer over stub patch embeddings).

The smoke configs initialised by the JAX package, every cross-attention
``gate`` set to 0.5 (the reference initialises it at 0, and ``tanh(0) = 0``
would hide the ``xattn`` path), carried over with ``params_from_jax``.
float32 agrees at atol 1e-4 (the same arithmetic in another summation
order: the port's attention runs through ``flash_attention``'s plain
version on the CPU), the decode caches' projected context K/V at 1e-5; in
bf16 each package is held against its own float32, as
``tests/test_torch_models.py`` holds the dense family.  Decode against the
full-sequence forward is held to the reference's own bound, 2e-2
(``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.transformer import encode as jax_encode
from repro.models.transformer import positional_cache as jax_positional_cache
from repro_torch import configs
from repro_torch.kernels import flash_attention_plain
from repro_torch.models import (context_conditioned, decode_step, encode,
                                forward, init_cache, init_params, num_params,
                                params_from_jax, positional_cache, prefill,
                                unembed)
from repro_torch.models import attention as tattn

ARCHS = ["whisper-small", "llama-3.2-vision-90b"]
B, S, MAX_SEQ, STEPS = 2, 10, 16, 10
GATE = 0.5


def _set_gates(tree, value):
    """Every ``gate`` leaf of a JAX numpy tree set to ``value`` in place."""
    for key, sub in tree.items():
        if key == "gate":
            tree[key] = np.full(sub.shape, value, sub.dtype)
        elif isinstance(sub, dict):
            _set_gates(sub, value)


def _ctx_len(cfg):
    return cfg.encoder_seq if cfg.encoder_layers else cfg.num_image_tokens


def _pair(arch, jdtype, tdtype, seed=0):
    """(jax cfg, port cfg, jax params (jnp), port params, context (numpy
    float32 (B, Sc, D)), tokens (B, S))."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               dtype=jdtype)
    tcfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                               dtype=tdtype)
    jp, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    _set_gates(jp, GATE)
    tp = params_from_jax(jp, tcfg, device="cpu")
    rng = np.random.default_rng(seed + 1)
    ctx = rng.normal(size=(B, _ctx_len(jcfg), jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, jp), tp, ctx, toks


def _jctx(ctx, jcfg):
    return jnp.asarray(ctx).astype(jcfg.dtype)


def _tctx(ctx, tcfg):
    # the JAX package's bf16 rounding of the same numbers
    return torch.from_numpy(ctx).to(tcfg.dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _jax_layer(tree, cfg, i):
    """Layer ``i``'s subtree of a JAX params or cache tree (one stacked
    period of ``cfg.period`` slots plus remainder layers, no prelude)."""
    P = cfg.period
    n = cfg.num_layers // P
    if i < n * P:
        return jax.tree_util.tree_map(lambda a: a[i // P],
                                      tree["layers"][f"slot_{i % P}"])
    return tree[f"rem_{i - n * P}"]


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

def test_params_carry_over_leaf_for_leaf(f32):
    """Every decoder layer (its ``xattn`` / ``norm_x`` children, the ``xattn``
    layer's ``mix`` with its 0-d ``gate``, llama-vision's period-5 stack in
    layer order) and every encoder layer, leaf for leaf."""
    jcfg, tcfg, jp, tp, _, _ = f32
    assert len(tp["layers"]) == jcfg.num_layers
    for i, layer in enumerate(tp["layers"]):
        _assert_same_tree(layer, _jax_layer(jp, jcfg, i), f"layer {i}")
        if jcfg.block_type(i) == "xattn":
            assert layer["mix"]["gate"].shape == ()
            assert float(layer["mix"]["gate"]) == GATE
        if jcfg.decoder_cross_attn:
            assert float(layer["xattn"]["gate"]) == GATE
    rest = {k: v for k, v in jp.items() if k not in ("layers", "encoder")}
    _assert_same_tree({k: tp[k] for k in rest}, rest)
    if jcfg.encoder_layers:
        enc = jp["encoder"]
        assert len(tp["encoder"]["layers"]) == jcfg.encoder_layers
        for i, layer in enumerate(tp["encoder"]["layers"]):
            _assert_same_tree(layer, enc[f"layer_{i}"], f"encoder {i}")
        _assert_same_tree(tp["encoder"]["final_norm"], enc["final_norm"])
    else:
        assert "encoder" not in tp
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jp))
    assert num_params(tp) == n_jax


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_scales_match_jax(arch):
    """Random init from a torch.Generator: the JAX tree's structure, shapes
    and dtype, ``std = 1/sqrt(fan_in)``, norms at one, gates at zero."""
    jcfg, tcfg, jp, _, _, _ = _pair(arch, jnp.bfloat16, torch.bfloat16)
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
        cross = layer["mix"] if tcfg.block_type(i) == "xattn" else \
            layer.get("xattn")
        if cross is not None:
            assert float(cross["gate"]) == 0.0
            assert abs(float(cross["wk"].float().std()) - D ** -0.5) < 0.02
    if tcfg.decoder_cross_attn:
        assert torch.equal(tp["layers"][0]["norm_x"],
                           torch.ones(D, dtype=torch.bfloat16))
    assert tcfg.num_params() == num_params(tp)


# ---------------------------------------------------------------------------
# the attention functions and the encoder
# ---------------------------------------------------------------------------

def _mix(jp, jcfg, tp, i, key):
    return _jax_layer(jp, jcfg, i)[key], tp["layers"][i][key]


def test_attention_bidir_matches_jax():
    jcfg, tcfg, jp, tp, ctx, _ = _pair("whisper-small", jnp.float32,
                                       torch.float32)
    jmix = jp["encoder"]["layer_1"]["mix"]
    tmix = tp["encoder"]["layers"][1]["mix"]
    pos = jnp.broadcast_to(jnp.arange(ctx.shape[1], dtype=jnp.int32),
                           ctx.shape[:2])
    want = jattn.attention_bidir(jmix, jcfg, jnp.asarray(ctx), pos)
    got = tattn.attention_bidir(tmix, tcfg, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("gated", [False, True])
def test_cross_kv_and_cross_attention_match_jax(f32, gated):
    """``cross_kv`` of the context, then ``cross_attention`` of 10 queries
    over it, the full-sequence form (the kernel's plain version at Sq !=
    Sk) and the decode form (one query per row), gated and not."""
    jcfg, tcfg, jp, tp, ctx, _ = f32
    i = jcfg.period - 1 if jcfg.block_type(jcfg.period - 1) == "xattn" else 0
    jmix, tmix = _mix(jp, jcfg, tp, i,
                      "mix" if jcfg.block_type(i) == "xattn" else "xattn")
    jk, jv = jattn.cross_kv(jmix, jcfg, jnp.asarray(ctx))
    tk, tv = tattn.cross_kv(tmix, tcfg, torch.from_numpy(ctx))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    x = np.random.default_rng(5).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jattn.cross_attention(jmix, jcfg, jnp.asarray(x),
                                            (jk, jv), gated=gated))
    for decode in (False, True):
        rows = slice(None) if not decode else slice(3, 4)
        got = tattn.cross_attention(tmix, tcfg, torch.from_numpy(x[:, rows]),
                                    (tk, tv), gated=gated, decode=decode)
        np.testing.assert_allclose(got.numpy(), want[:, rows], rtol=0,
                                   atol=1e-4)
    if gated:      # tanh(0.5) scales the output
        ungated = jattn.cross_attention(jmix, jcfg, jnp.asarray(x), (jk, jv))
        np.testing.assert_allclose(want, np.tanh(GATE) * np.asarray(ungated),
                                   rtol=1e-5, atol=1e-6)


def test_encode_matches_jax():
    """Sinusoidal positions, the bidirectional layers and the final norm."""
    jcfg, tcfg, jp, tp, ctx, _ = _pair("whisper-small", jnp.float32,
                                       torch.float32)
    want = jax_encode(jp, jcfg, jnp.asarray(ctx))
    got = encode(tp, tcfg, torch.from_numpy(ctx))
    assert got.shape == ctx.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_flash_plain_matches_pallas_non_causal_at_sq_ne_sk():
    """Cross-attention's shape for the kernel: non-causal, Sq != Sk (more
    keys than queries and fewer), GQA, against the Pallas kernel in
    interpret mode with blocks of 16."""
    rng = np.random.default_rng(11)
    for Sq, Sk in ((16, 48), (48, 16)):
        q = rng.normal(size=(2, 4, Sq, 32)).astype(np.float32)
        k, v = (rng.normal(size=(2, 2, Sk, 32)).astype(np.float32)
                for _ in range(2))
        want = jops.flash_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=False, block_q=16, block_k=16)
        got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# forward, cache, decode
# ---------------------------------------------------------------------------

def _forward_both(arch, jdtype, tdtype):
    jcfg, tcfg, jp, tp, ctx, toks = _pair(arch, jdtype, tdtype)
    jh, _ = jax_forward(jp, jcfg, jnp.asarray(toks),
                        context=_jctx(ctx, jcfg))
    th = forward(tp, tcfg, torch.from_numpy(toks), context=_tctx(ctx, tcfg))
    assert th.dtype == tdtype and th.shape == (B, S, jcfg.d_model)
    return _np(jh), _np(th)


@pytest.fixture(scope="module", params=ARCHS)
def forward32(request):
    return request.param, _forward_both(request.param, jnp.float32,
                                        torch.float32)


def test_forward_with_context_matches_jax_float32(forward32):
    _, (want, got) = forward32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_with_context_matches_jax_bfloat16(forward32):
    """Each package's bf16 hidden states against its own float32: the
    port's no further off than the JAX package's (x1.25); the two bf16
    results as ``tests/test_torch_models.py`` holds bf16 logits: 99.5%
    within 5e-2 of each other, all within 0.1 (the two frameworks round at
    different points, each up to ~0.05 from its float32 here)."""
    arch, (want32, got32) = forward32
    want, got = _forward_both(arch, jnp.bfloat16, torch.bfloat16)
    assert np.abs(got - got32).mean() <= 1.25 * np.abs(want - want32).mean()
    assert np.abs(got - got32).max() <= 1.25 * np.abs(want - want32).max()
    diff = np.abs(got - want)
    assert np.mean(diff <= 5e-2) >= 0.995 and diff.max() <= 0.1


def test_forward_without_context_skips_cross_attention_like_jax():
    """whisper's decoder without a context: the JAX package skips the
    cross-attention and the encoder, so does the port."""
    jcfg, tcfg, jp, tp, _, toks = _pair("whisper-small", jnp.float32,
                                        torch.float32)
    want, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    got = forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _cache_both(pair):
    jcfg, tcfg, jp, tp, ctx, _ = pair
    jc = jax_init_cache(jp, jcfg, B, MAX_SEQ, context=jnp.asarray(ctx))
    tc = init_cache(tp, tcfg, B, MAX_SEQ, context=torch.from_numpy(ctx))
    return jc, tc


def test_init_cache_projects_the_context_once_per_layer(f32):
    """``xk`` / ``xv`` of every cross-attending layer at 1e-5 (whisper's
    after the encoder), zeroed self-attention rows, ``pos`` 0."""
    jcfg = f32[0]
    jc, tc = _cache_both(f32)
    assert int(tc["pos"]) == 0 and tc["pos"].shape == ()
    for i, layer in enumerate(tc["layers"]):
        want = _jax_layer(jc, jcfg, i)
        _assert_same_tree(layer, want, f"cache layer {i}", atol=1e-5)
        xattn = jcfg.block_type(i) == "xattn" or jcfg.decoder_cross_attn
        assert ("xk" in layer) == xattn
        assert ("k" in layer) == (jcfg.block_type(i) != "xattn")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_without_context_is_the_references(arch):
    """No context: an ``xattn`` layer holds zeros of ``num_image_tokens``
    rows, a cross-attending ``attn`` layer no context K/V at all."""
    jcfg, tcfg, jp, tp, _, _ = _pair(arch, jnp.float32, torch.float32)
    jc = jax_init_cache(jp, jcfg, B, MAX_SEQ)
    tc = init_cache(tp, tcfg, B, MAX_SEQ, pos_per_slot=True)
    assert tc["pos"].shape == (B,)
    for i, layer in enumerate(tc["layers"]):
        _assert_same_tree(layer, _jax_layer(jc, jcfg, i), f"layer {i}")


@pytest.fixture(scope="module", params=ARCHS)
def decoded(request):
    """STEPS decode steps of both packages from ``init_cache(context=)``:
    (pair, jax logits, port logits, jax cache, port cache)."""
    pair = _pair(request.param, jnp.float32, torch.float32)
    jcfg, tcfg, jp, tp, _, toks = pair
    jc, tc = _cache_both(pair)
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
    """Ten steps' logits and the caches after them at 1e-4."""
    pair, jl, tl, jc, tc = decoded
    jcfg = pair[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert int(tc["pos"]) == int(jc["pos"]) == STEPS
    for i, layer in enumerate(tc["layers"]):
        _assert_same_tree(layer, _jax_layer(jc, jcfg, i), f"layer {i}",
                          atol=1e-4)


def test_decode_matches_forward(decoded):
    """Token-by-token decode over the context cache reproduces the
    full-sequence forward's logits: the reference's bound, 2e-2
    (``tests/test_models.py``), held by the port alone."""
    pair, _, tl, _, _ = decoded
    _, tcfg, _, tp, ctx, toks = pair
    full = unembed(tp, tcfg, forward(tp, tcfg, torch.from_numpy(toks)[:,
                                                                      :STEPS],
                                     context=torch.from_numpy(ctx)))
    assert float((full - torch.from_numpy(tl)).abs().max()) < 2e-2


# ---------------------------------------------------------------------------
# registry, shape cells, what is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_context_spec_and_input_specs_match_the_reference(arch):
    """Every ported arch, every ``SHAPES`` cell: the same keys, shapes and
    dtypes (meta tensors here, ``ShapeDtypeStruct`` there), the same
    ``valid_cells``."""
    jcfg = jconfigs.get_config(arch)
    cfg = configs.get_config(arch)
    assert set(configs.SHAPES) == set(jconfigs.SHAPES)
    assert configs.valid_cells(cfg) == jconfigs.valid_cells(jcfg)
    for name, cell in configs.SHAPES.items():
        jcell = jconfigs.SHAPES[name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
        got, want = configs.input_specs(cfg, cell), \
            jconfigs.input_specs(jcfg, jcell)
        assert set(got) == set(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == spec.shape
            assert str(got[key].dtype).split(".")[-1] == str(spec.dtype)
    for batch in (1, 8):
        got, want = configs.context_spec(cfg, batch), \
            jconfigs.context_spec(jcfg, batch)
        assert (got is None) == (want is None)
        if want is not None:
            assert tuple(got.shape) == want.shape


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_positional_cache_matches_the_reference(arch):
    for smoke in (False, True):
        cfg = configs.get_config(arch, smoke=smoke)
        want = jax_positional_cache(jconfigs.get_config(arch, smoke=smoke))
        assert positional_cache(cfg) == want
        assert context_conditioned(cfg) == (arch in ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_cli_and_prefill_refuse_context_archs(arch):
    from repro_torch.launch.serve import run_cli
    from repro_torch.serving import ServeConfig, build_engine, make_backend

    with pytest.raises(NotImplementedError, match="context-conditioned"):
        build_engine(ServeConfig(arch=arch), device="cpu")
    with pytest.raises(NotImplementedError, match="context-conditioned"):
        run_cli(["--arch", arch, "--device", "cpu", "--requests", "2"])
    _, tcfg, _, tp, _, toks = _pair(arch, jnp.float32, torch.float32)
    with pytest.raises(NotImplementedError, match="context-conditioned"):
        make_backend(tcfg, tp, ServeConfig(arch=arch), "cpu")
    cache = init_cache(tp, tcfg, B, MAX_SEQ)
    with pytest.raises(NotImplementedError, match="no one-pass prefill"):
        prefill(tp, tcfg, cache, torch.from_numpy(toks),
                torch.full((B,), S, dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_build_serve_step_encodes_a_seeded_context(arch):
    """``make_cache`` holds the context K/V of a context drawn from the
    config's seed (the same in every cache); the step is ``decode_step``."""
    from repro_torch.serving import ServeConfig, build_serve_step

    config = ServeConfig(arch=arch, num_slots=2, seed=3)
    cfg, built, params, make_cache = build_serve_step(config, device="cpu")
    cache = make_cache()
    again = make_cache()
    n = cfg.encoder_seq if cfg.encoder_layers else cfg.num_image_tokens
    crossing = [(a, b) for a, b in zip(cache["layers"], again["layers"])
                if "xk" in a]
    assert len(crossing) == (cfg.num_layers if cfg.decoder_cross_attn else
                             cfg.num_layers // cfg.period)
    for a, b in crossing:
        assert a["xk"].shape == (2, n, cfg.num_kv_heads, cfg.head_dim)
        assert torch.equal(a["xk"], b["xk"]) and torch.equal(a["xv"],
                                                              b["xv"])
        assert float(a["xk"].abs().max()) > 0
    tok = torch.ones((2, 1), dtype=torch.int32)
    logits, cache = built.fn(params, cache, tok)
    want, _ = decode_step(params, cfg, again, tok)
    assert logits.shape == (2, 1, cfg.vocab_size) and int(cache["pos"]) == 1
    assert torch.equal(logits, want)
