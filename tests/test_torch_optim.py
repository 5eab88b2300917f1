"""The port's optimizer substrate (``repro_torch.optim``) against the JAX
package's (``repro.optim``) on the same inputs, made with numpy.

AdamW, its schedule and clipping over 5 steps at 1e-6 (float32 state; the
bf16 params each package returns are the same rounding of that state);
each compressor on the same gradients and error state: top-k and block
top-k indices and int8 codes bit for bit, values and error-feedback
residuals at 1e-6; byte accounting equal; the lossy monoids against the
JAX registry's; and twins of ``tests/test_optim.py``, merged where they
repeat into cases of one parametrised test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro.optim as jo
import repro.optim.compress as jc
from repro.core import monoids as jm
from repro.core.aggregation import grad_accum_fold as jax_grad_accum_fold
from repro_torch.core import monoid as tmonoid
from repro_torch.core import monoids as tm
from repro_torch.core.aggregation import grad_accum_fold
from repro_torch.optim import (LossySpec, OptConfig, adamw_update,
                               blocktopk_compress, clip_by_global_norm,
                               compressed_bytes, global_norm,
                               init_error_state, init_opt_state,
                               int8_compress, int8_decompress, schedule,
                               topk_compress, topk_decompress)

SHAPES = {"a": (16, 8), "b": (33,), "c": (4, 5, 6)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return pytree.tree_map(torch.from_numpy, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if jnp.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


# -- AdamW -------------------------------------------------------------------

@pytest.mark.parametrize("clip_norm", [1.0, 100.0], ids=["clipped", "free"])
def test_adamw_matches_jax_over_five_steps(clip_norm):
    cfg = OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=6,
                    clip_norm=clip_norm)
    jcfg = jo.OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=6,
                        clip_norm=clip_norm)
    p0 = _tree(0)
    jstate, tstate = jo.init_opt_state(_jt(p0)), init_opt_state(_tt(p0))
    for step in range(5):
        g = _tree(10 + step, scale=3.0)
        jp, jstate, jm_ = jo.adamw_update(_jt(g), jstate, jcfg,
                                          grad_scale=0.5)
        tp, tstate, tm_ = adamw_update(_tt(g), tstate, cfg, grad_scale=0.5)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm_[k]), _np(jm_[k]), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for part in ("m", "v", "master"):
            for k in SHAPES:
                np.testing.assert_allclose(_np(tstate[part][k]),
                                           _np(jstate[part][k]),
                                           rtol=1e-6, atol=1e-7)
        for k in SHAPES:
            assert tp[k].dtype == torch.bfloat16
            # one rounding of masters equal to 1e-6: at most one bf16 ulp
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                       rtol=2 ** -7)
    if clip_norm == 1.0:
        assert float(tm_["grad_norm"]) > clip_norm   # clipping was active


def test_schedule_matches_jax_and_warms_then_decays():
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                    min_lr_ratio=0.1)
    jcfg = jo.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                        min_lr_ratio=0.1)
    steps = np.arange(0, 130, 7, dtype=np.int32)
    np.testing.assert_allclose(
        _np(schedule(cfg, torch.from_numpy(steps))),
        _np(jo.schedule(jcfg, jnp.asarray(steps))), rtol=1e-6)
    assert float(schedule(cfg, torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(schedule(cfg, torch.tensor(10))), 1e-3,
                               rtol=1e-5)
    assert float(schedule(cfg, torch.tensor(5))) < 1e-3
    np.testing.assert_allclose(float(schedule(cfg, torch.tensor(100))), 1e-4,
                               rtol=1e-3)


def test_opt_state_shapes_match_jax():
    """``opt_state_shapes`` of the smoke qwen3's parameter shapes (meta
    tensors) against the reference's ``ShapeDtypeStruct`` tree, leaf for
    leaf (the port's per-layer list against the reference's stacked
    leaves through ``to_jax_layout``), with and without ``ef``; and the
    real state's shapes and dtypes."""
    import dataclasses as dc
    from repro.configs import get_config as jax_get_config
    from repro.models import param_shapes as jax_param_shapes
    from repro_torch.configs import get_config
    from repro_torch.models.convert import to_jax_layout
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import init_opt_state, opt_state_shapes

    cfg = get_config("qwen3-0.6b", smoke=True)
    jcfg = jax_get_config("qwen3-0.6b", smoke=True)
    for with_ef in (False, True):
        got = opt_state_shapes(param_shapes(cfg), with_ef=with_ef)
        want = jo.opt_state_shapes(jax_param_shapes(jcfg), with_ef=with_ef)
        assert set(got) == set(want)
        assert got["step"].dtype == torch.int32 and got["step"].shape == ()
        assert want["step"].dtype == jnp.int32 and want["step"].shape == ()
        for part in set(got) - {"step"}:
            stacked = to_jax_layout(got[part], cfg)
            gl = jax.tree_util.tree_flatten_with_path(stacked)[0]
            wl = jax.tree_util.tree_flatten_with_path(want[part])[0]
            assert [p for p, _ in gl] == [p for p, _ in wl]
            for (_, g), (_, w) in zip(gl, wl):
                assert g.device.type == "meta" and g.dtype == torch.float32
                assert tuple(g.shape) == tuple(w.shape) and \
                    w.dtype == jnp.float32
    from repro_torch.models import init_params
    real = init_opt_state(init_params(dc.replace(cfg, dtype=torch.bfloat16),
                                      torch.Generator(), device="cpu"),
                          with_ef=True)
    abstract = opt_state_shapes(param_shapes(cfg), with_ef=True)
    for a, b in zip(pytree.tree_leaves(real), pytree.tree_leaves(abstract)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 10.0, rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = init_opt_state(params)
    cfg = OptConfig(peak_lr=0.2, warmup_steps=1, decay_steps=400,
                    weight_decay=0.0, clip_norm=100.0)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        _, opt, _ = adamw_update(g, opt, cfg)
        params = {"w": opt["master"]["w"]}   # the fp32 master for the probe
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_opt_state_with_ef_persists_through_update():
    """The steps.py pattern: pop 'ef' around adamw_update (which rebuilds
    the state dict) and put the new residual back."""
    params = {"w": torch.tensor([1.0, -1.0])}
    opt = init_opt_state(params, with_ef=True)
    assert "ef" in opt and opt["ef"]["w"].dtype == torch.float32
    ef = opt.pop("ef")
    _, new_opt, _ = adamw_update({"w": torch.tensor([0.5, 0.25])}, opt,
                                 OptConfig())
    assert "ef" not in new_opt
    new_opt["ef"] = ef
    assert set(new_opt) == {"step", "m", "v", "master", "ef"}


# -- the gradient fold -------------------------------------------------------

def test_grad_accum_fold_equals_full_batch_and_jax():
    """In-mapper combining over microbatches == one big batch (Sum
    monoid), and == the JAX package's fold."""
    xs_np = np.random.default_rng(0).normal(size=(8, 4, 2)).astype(
        np.float32)
    calls = []

    def loss_and_grad(p, mb):
        calls.append(mb.device.type)
        p = p.detach().requires_grad_()
        loss = torch.sum(torch.square(mb @ p))
        (g,) = torch.autograd.grad(loss, [p])
        return {"loss": loss.detach()}, g

    w = torch.tensor([1.0, 2.0])
    metrics, grads = grad_accum_fold(loss_and_grad, w, torch.from_numpy(xs_np))
    assert calls == ["cpu"] * 8          # one real call per microbatch
    flat = torch.from_numpy(xs_np.reshape(-1, 2))
    want = 2 * flat.T @ (flat @ w)
    np.testing.assert_allclose(grads.numpy(), want.numpy(), rtol=1e-5)

    def jlg(p, mb):
        f = lambda p: jnp.sum(jnp.square(mb @ p))   # noqa: E731
        loss, g = jax.value_and_grad(f)(p)
        return {"loss": loss}, g

    jmetrics, jgrads = jax_grad_accum_fold(jlg, jnp.asarray([1.0, 2.0]),
                                           jnp.asarray(xs_np))
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-6)


# -- compressors against the JAX package --------------------------------------

def _compress_both(method, ratio, dtype, seed=5):
    g_np, e_np = _tree(seed), _tree(seed + 1, scale=0.1)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jdt), g_np)
    tg = pytree.tree_map(lambda x: torch.from_numpy(x).to(dtype), g_np)
    jspec = jc.LossySpec(method, ratio)
    tspec = LossySpec(method, ratio)
    jcomp, jerr = jspec.compress(jg, _jt(e_np))
    tcomp, terr = tspec.compress(tg, _tt(e_np))
    return jspec, tspec, jg, tg, jcomp, jerr, tcomp, terr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("method,ratio", [("topk", 0.1), ("blocktopk", 0.1),
                                          ("blocktopk", 0.03), ("int8", 1.0)])
def test_compressors_match_jax(method, ratio, dtype):
    jspec, tspec, jg, tg, jcomp, jerr, tcomp, terr = _compress_both(
        method, ratio, dtype)
    for k in SHAPES:
        jcc, tcc = jcomp[k], tcomp[k]
        if method == "int8":
            assert tcc["q"].dtype == torch.int8
            np.testing.assert_array_equal(tcc["q"].numpy(),
                                          np.asarray(jcc["q"]))
            np.testing.assert_allclose(float(tcc["scale"]),
                                       float(jcc["scale"]), rtol=1e-6)
        else:
            assert tcc["idx"].dtype == torch.int32
            assert tcc["size"] == jcc["size"]
            np.testing.assert_array_equal(tcc["idx"].numpy(),
                                          np.asarray(jcc["idx"]))
            np.testing.assert_allclose(tcc["values"].numpy(),
                                       np.asarray(jcc["values"]), rtol=1e-6)
        np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]),
                                   rtol=1e-6, atol=1e-6)
    tdec = tspec.decompress(tcomp, tg)
    jdec = jspec.decompress(jcomp, jg)
    for k in SHAPES:
        assert tdec[k].dtype == dtype
        np.testing.assert_allclose(_np(tdec[k]), _np(jdec[k]), rtol=1e-6)
    assert compressed_bytes(tcomp) == jc.compressed_bytes(jcomp)
    assert tspec.wire_bytes(tg) == jspec.wire_bytes(jg)


@pytest.mark.parametrize("spec", ["topk:0.01", "blocktopk:0.001", "int8",
                                  "topk:1.0", "blocktopk:0.3"])
def test_wire_bytes_match_jax(spec):
    like_t = {"w": torch.empty((1000,), device="meta"),
              "v": torch.empty((7, 3), device="meta")}
    like_j = {"w": jax.ShapeDtypeStruct((1000,), jnp.float32),
              "v": jax.ShapeDtypeStruct((7, 3), jnp.float32)}
    assert LossySpec.parse(spec).wire_bytes(like_t) == \
        jc.LossySpec.parse(spec).wire_bytes(like_j)
    assert LossySpec.parse(spec).describe() == \
        jc.LossySpec.parse(spec).describe()


@pytest.mark.parametrize("name", ["lossy_topk8", "lossy_int8"])
def test_lossy_monoids_laws_and_combine_match_jax(name):
    import repro.optim  # noqa: F401  (registers the JAX lossy monoids)
    tmon, jmon = tm.REGISTRY[name], jm.REGISTRY[name]
    ts, js = tm.law_samples_for(name)(), jm.law_samples_for(name)()
    tmonoid.check_laws(tmon, ts)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        got, want = tmon.combine(ts[a], ts[b]), jmon.combine(js[a], js[b])
        for x, y in zip(pytree.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # beyond capacity the sparse monoid is lossy: it keeps the k largest
    if name == "lossy_topk8":
        full = tmon.combine(tmon.combine(ts[0], ts[1]), ts[2])
        big = {"idx": torch.arange(8, dtype=torch.int32) + 20,
               "values": torch.full((8,), 10.0)}
        out = tmon.combine(full, big)
        assert sorted(out["idx"].tolist()) == list(range(20, 28))


# -- twins of tests/test_optim.py ----------------------------------------------

def test_topk_error_feedback_sums_to_truth():
    """EF invariant: applied + residual == accumulated true gradient."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64,))
                               .astype(np.float32))}
    err = init_error_state(g)
    applied, total = torch.zeros(64), torch.zeros(64)
    for _ in range(5):
        comp, err = topk_compress(g, err, ratio=0.1)
        applied += topk_decompress(comp, g)["w"]
        total += g["w"]
    np.testing.assert_allclose((applied + err["w"]).numpy(), total.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert compressed_bytes(comp) < 64 * 4


def test_int8_compress_roundtrip_accuracy():
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(256,))
                               .astype(np.float32))}
    comp, err = int8_compress(g, init_error_state(g))
    deq = int8_decompress(comp, g)["w"]
    scale = float(torch.max(torch.abs(g["w"])))
    assert float(torch.max(torch.abs(deq - g["w"]))) <= scale / 127 + 1e-6
    np.testing.assert_allclose((deq + err["w"]).numpy(), g["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_topk_kclamp_edge_cases():
    """A ratio on a tiny leaf never asks for k = 0 or k > size."""
    err = {"w": torch.zeros(3)}
    g = {"w": torch.tensor([1.0, -2.0, 0.5])}
    for ratio in (0.01, 0.5, 1.0):
        comp, _ = topk_compress(g, err, ratio=ratio)
        assert 1 <= comp["w"]["values"].shape[0] <= 3, ratio
    comp, new_e = topk_compress(g, err, ratio=1.0)
    assert torch.equal(topk_decompress(comp, g)["w"], g["w"])
    assert torch.equal(new_e["w"], torch.zeros(3))


@pytest.mark.parametrize("size", [5, 17, 100])
def test_blocktopk_non_divisible_sizes(size):
    g = {"w": torch.from_numpy(np.random.default_rng(3).normal(size=(size,))
                               .astype(np.float32))}
    comp, new_e = blocktopk_compress(g, init_error_state(g), ratio=0.3)
    idx = comp["w"]["idx"]
    assert int(idx.min()) >= 0 and int(idx.max()) < size
    applied = topk_decompress(comp, g)["w"]
    np.testing.assert_allclose((applied + new_e["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["topk", "blocktopk", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ef_exact_for_param_dtype(method, dtype):
    """The residual is taken against what the receiver applies after the
    cast to the parameter dtype: applied + residual == truth bit for bit."""
    spec = LossySpec.parse(method if method == "int8" else f"{method}:0.25")
    g = {"w": torch.from_numpy(np.random.default_rng(4).normal(size=(32,))
                               .astype(np.float32)).to(dtype)}
    comp, new_e = spec.compress(g, init_error_state(g))
    applied = spec.decompress(comp, g)["w"].float()
    assert float((applied + new_e["w"] - g["w"].float()).abs().max()) == 0.0


def test_lossy_spec_parse_and_wire_bytes():
    assert LossySpec.parse("topk:0.1") == LossySpec("topk", 0.1)
    assert LossySpec.parse("int8").method == "int8"
    assert LossySpec.parse(LossySpec("blocktopk", 0.5)).ratio == 0.5
    with pytest.raises(ValueError):
        LossySpec.parse("gzip:0.1")
    with pytest.raises(ValueError):
        LossySpec("topk", 0.0)
    with pytest.raises(TypeError):
        LossySpec.parse(3)
    like = {"w": torch.empty((1000,), device="meta")}
    assert LossySpec.parse("topk:0.01").wire_bytes(like) == 10 * 8
    assert LossySpec.parse("int8").wire_bytes(like) == 1000 + 4
    assert LossySpec.parse("topk:0.01").wire_bytes(like) < 1000 * 4


def test_ef_sgd_converges_on_quadratic():
    """Top-k EF-SGD reaches the optimum despite 90% sparsification."""
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.normal(size=(16, 16)).astype(np.float32))
    Q = A @ A.T / 16 + torch.eye(16)
    w = {"w": torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))}
    err = init_error_state(w)
    for _ in range(300):
        comp, err = topk_compress({"w": Q @ w["w"]}, err, ratio=0.1)
        w = {"w": w["w"] - 0.05 * topk_decompress(comp, w)["w"]}
    assert float(0.5 * w["w"] @ Q @ w["w"]) < 1e-3
