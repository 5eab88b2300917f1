"""The port's training loss and its gradients against the JAX package's.

``loss_fn``'s value, metrics and gradients against ``jax.value_and_grad``
of ``repro.models.loss_fn`` on the same weights (``params_from_jax``) and
the same numpy batch, float32 smoke configs: the dense family (qwen3,
gemma3's window layers on the kernel's plain version), MoE (``grouped_mm``
and the ordered combine), recurrent (the ``*_mix`` forms) and context
(the encoder and cross-attention; gates set to 0.5, since the reference's
0 hides ``xattn``).  Loss at rtol 1e-5; each gradient leaf within 1e-4 of
that leaf's max magnitude (the same arithmetic in another order).

Also: the ``ce_chunk`` and ``remat`` variants equal the plain form at
1e-6; ``flash_attention_backward_plain`` against ``jax.vjp`` of the
reference's attention (``repro.kernels.ref.flash_attention_ref`` at Sq ==
Sk, causal, non-causal, GQA; the reference's ``_causal_mask`` for the
window); and grad mode: a no-grad ``forward`` builds no graph, ``prefill``
and ``decode_step`` stay no-grad, the serve path is unchanged.
"""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import context_spec as jax_context_spec
from repro.configs import get_config as jax_get_config
from repro.kernels.ref import flash_attention_ref
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models.attention import _causal_mask
from repro.models.transformer import RunCtx as JaxRunCtx
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward_plain)
from repro_torch.models import (RunCtx, decode_step, forward, init_cache,
                                loss_fn, params_from_jax, prefill)

ARCHS = ["qwen3-0.6b", "gemma3-1b", "qwen2-moe-a2.7b", "xlstm-1.3b",
         "jamba-v0.1-52b", "whisper-small", "llama-3.2-vision-90b",
         "deepseek-v2-236b"]
B, S = 2, 16


def _pair(arch, seed=0):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32)
    jp, _ = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    # the reference initialises cross-attention gates at 0 (tanh(0) = 0
    # hides xattn and zeroes its gradients): set them to 0.5
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.full_like(x, 0.5)
        if jax.tree_util.keystr(p).endswith("['gate']") else x, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    labels[1, :3] = -1                     # a masked stretch
    batch = {"tokens": toks, "labels": labels}
    cs = jax_context_spec(jcfg, B)
    if cs is not None:
        batch["context"] = rng.standard_normal(cs.shape).astype(np.float32)
    return batch


def _port_loss_and_grads(tcfg, tp, batch, ctx):
    leaves, spec = pytree.tree_flatten(tp)
    req = [t.detach().clone().requires_grad_() for t in leaves]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = loss_fn(pytree.tree_unflatten(req, spec), tcfg, tb, ctx)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, req)]
    return loss, metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    batch = _batch(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, jcfg, b, JaxRunCtx(remat="none")),
        has_aux=True))
    (jl, jm), jg = fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = _port_loss_and_grads(tcfg, tp, batch, RunCtx(remat="none"))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-6)
    assert float(tm["tokens"]) == B * (S - 1) - 3
    want = pytree.tree_leaves(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), tcfg, device="cpu"))
    assert len(want) == len(tg)
    for g, w in zip(tg, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 1e-4 * scale


@contextlib.contextmanager
def _one_rank_mesh(tmp_path):
    """Mesh (1, 1) over ('data', 'model') in a 1-rank gloo world (its
    ``FileStore`` under ``tmp_path``), destroyed on the way out."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("gloo", 0, 1, tdist.FileStore(str(tmp_path / "store"),
                                                   1))
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-1b"])
def test_ce_chunk_and_remat_variants_equal_the_plain_form(arch, tmp_path):
    _, tcfg, _, tp = _pair(arch)
    batch = _batch(dataclasses.replace(jax_get_config(arch, smoke=True)))
    base = _port_loss_and_grads(tcfg, tp, batch, RunCtx(remat="none"))
    for ctx in (RunCtx(remat="full"), RunCtx(remat="none", ce_chunk=8),
                RunCtx(remat="full", ce_chunk=4)):
        loss, metrics, grads = _port_loss_and_grads(tcfg, tp, batch, ctx)
        np.testing.assert_allclose(loss.item(), base[0].item(), rtol=1e-6)
        for k in metrics:
            np.testing.assert_allclose(metrics[k].item(),
                                       base[1][k].item(), rtol=1e-6)
        for g, w in zip(grads, base[2]):
            assert float((g - w).abs().max()) <= \
                1e-6 * max(float(w.abs().max()), 1e-30), ctx
    # under a mesh every family trains (tests/test_torch_tp_train.py,
    # tests/test_torch_tp_train_families.py): on mesh (1, 1) MLA, the
    # recurrent and the context families run their mesh forms (every leaf
    # cut over axes of size 1: the collectives and dist.enter on one rank)
    # and give the plain form's loss (rtol 1e-6) and gradients, each leaf
    # within 1e-5 of its max magnitude: the mesh forms add in another order
    # (mLSTM's packed product, the float32 partial sums; readings <= 1.5e-6)
    from repro_torch.dist import sharding as shd
    with _one_rank_mesh(tmp_path) as mesh:
        for other in ("deepseek-v2-236b", "xlstm-1.3b", "whisper-small"):
            ocfg, op = _pair(other)[1:4:2]
            obatch = _batch(jax_get_config(other, smoke=True))
            want = _port_loss_and_grads(ocfg, op, obatch, RunCtx())
            with shd.use_rules(mesh, shd.TRAIN_RULES):
                got = _port_loss_and_grads(ocfg, op, obatch,
                                           RunCtx(mesh=mesh, ce_chunk=8))
            np.testing.assert_allclose(got[0].item(), want[0].item(),
                                       rtol=1e-6)
            assert len(got[2]) == len(want[2])
            for g, w in zip(got[2], want[2]):
                assert float((g - w).abs().max()) <= \
                    1e-5 * max(float(w.abs().max()), 1e-30), other


def _qkv(B_, H, KV, S_, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B_, H, S_, d), (B_, KV, S_, d), (B_, KV, S_, d),
             (B_, H, S_, d))]


@pytest.mark.parametrize("B_,H,KV,S_,d,causal", [
    (2, 4, 4, 37, 16, True), (1, 4, 2, 40, 8, True), (2, 6, 2, 33, 24, False),
    (1, 2, 1, 5, 4, True)])
def test_backward_plain_matches_jax_grad(B_, H, KV, S_, d, causal):
    q, k, v, do = _qkv(B_, H, KV, S_, d, seed=S_ + d)
    o, vjp = jax.vjp(lambda q, k, v: flash_attention_ref(q, k, v,
                                                         causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = flash_attention_backward_plain(
        *map(torch.from_numpy, (q, k, v, np.array(o), do)), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("window", [1, 5, 16, 64])
def test_backward_plain_window_matches_jax_masked_attention(window):
    B_, H, KV, S_, d = 2, 4, 2, 30, 16
    q, k, v, do = _qkv(B_, H, KV, S_, d, seed=window)
    pos = jnp.arange(S_)
    keep = _causal_mask(pos, pos, window)

    def attn(q, k, v):
        qg = q.reshape(B_, KV, H // KV, S_, d)
        s = jnp.einsum("bkgqd,bksd->bkgqs", qg, k) / math.sqrt(d)
        w = jax.nn.softmax(jnp.where(keep, s, -jnp.inf), axis=-1)
        return jnp.einsum("bkgqs,bksd->bkgqd", w, v).reshape(B_, H, S_, d)

    o, vjp = jax.vjp(attn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = flash_attention_backward_plain(
        *map(torch.from_numpy, (q, k, v, np.array(o), do)), causal=True,
        window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_differentiates_through_its_function():
    """With an input that requires grad the wrapper runs the autograd
    Function (the plain pair on the CPU): the same output as the no-grad
    call bit for bit, gradients equal to autograd through plain softmax
    attention; ``q_offset`` has no backward and raises."""
    q, k, v, do = map(torch.from_numpy, _qkv(2, 4, 2, 21, 8, seed=3))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(qr, kr, vr, causal=True, window=6)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(),
                       flash_attention(q, k, v, causal=True, window=6))
    got = torch.autograd.grad(out, (qr, kr, vr), do)
    q2, k2, v2 = (t.clone().double().requires_grad_() for t in (q, k, v))
    kk, vv = k2.repeat_interleave(2, 1), v2.repeat_interleave(2, 1)
    s = q2 @ kk.transpose(-1, -2) / math.sqrt(8)
    pos = torch.arange(21)
    keep = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 6)
    ref = torch.softmax(s.masked_fill(~keep, -math.inf), -1) @ vv
    want = torch.autograd.grad(ref, (q2, k2, v2), do.double())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(qr, kr, vr, q_offset=torch.zeros(2, dtype=torch.int32))


def test_grad_mode_leaves_the_serve_path_alone():
    """``forward`` runs under the caller's grad mode: without a parameter
    that requires grad it builds no graph (and its output equals the
    training path's bit for bit); ``prefill`` and ``decode_step`` stay
    no-grad even when the parameters require grad."""
    _, tcfg, _, tp = _pair("qwen3-0.6b")
    toks = torch.from_numpy(_batch(jax_get_config("qwen3-0.6b",
                                                  smoke=True))["tokens"])
    h = forward(tp, tcfg, toks)
    assert h.grad_fn is None and not h.requires_grad
    with torch.no_grad():
        h0 = forward(tp, tcfg, toks)
    assert torch.equal(h, h0)
    tg = pytree.tree_map(lambda t: t.clone().requires_grad_(), tp)
    hg = forward(tg, tcfg, toks)
    assert hg.grad_fn is not None
    assert torch.equal(hg.detach(), h0)
    cache = init_cache(tg, tcfg, B, 32, pos_per_slot=True)
    lengths = torch.tensor([S, S - 3])
    logits, cache = prefill(tg, tcfg, cache, toks, lengths)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(not t.requires_grad for t in pytree.tree_leaves(cache))
    step_logits, _ = decode_step(tg, tcfg, cache, toks[:, :1])
    assert step_logits.grad_fn is None
    cache0 = init_cache(tp, tcfg, B, 32, pos_per_slot=True)
    logits0, cache0 = prefill(tp, tcfg, cache0, toks, lengths)
    assert torch.equal(logits, logits0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_backward_is_the_plain_backward(dtype, masked):
    """``embed_lookup``'s backward (sorted ids, the rows of each id added
    in token order without atomics: ``add_rows``) equals the plain
    ``embedding[tokens]`` backward on the CPU bit for bit, a hot id (a
    third of the tokens) and the vocab-cut form's mask included."""
    from repro_torch.models.common import embed_lookup
    g = torch.Generator().manual_seed(5)
    table = torch.randn((97, 16), generator=g).to(dtype).requires_grad_()
    toks = torch.randint(0, 97, (4, 48), generator=g)
    toks[:, :16] = 11
    keep = toks < 60 if masked else None
    up = torch.randn((4, 48, 16), generator=g).to(dtype)
    got, = torch.autograd.grad((embed_lookup(table, toks, keep) * up).sum(),
                               table)
    plain = table[toks]
    if masked:
        plain = plain.masked_fill(~keep[..., None], 0)
    want, = torch.autograd.grad((plain * up).sum(), table)
    assert got.dtype == dtype and torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(embed_lookup(table, toks, keep), plain)
