"""The port's train step (``repro_torch.launch.steps.make_train_step``, one
device) against the JAX package's (``repro.launch.steps.make_train_step``
on a 1-device host mesh, as ``tests/test_system.py`` builds it), from the
same weights over the same 3 numpy batches, qwen3-0.6b's smoke config in
float32: every metric at 1e-5, and the optimizer moments, the float32
master weights and the error-feedback residual (``opt_state["ef"]``,
carried by each ``lossy=`` method) within 1e-5 of each leaf's max
magnitude, with 1 and 2 microbatches; 2 microbatches equal 1 alike.

Each case names how many of the state's 180,928 elements per part may
fall outside 1e-5, and by how much at most, set just above what the
packages give (readings in the comments).  Those elements are rounding
decisions taken on a difference of one float32 rounding: Adam's update
``g / (|g| + eps)`` for a gradient within 10x of ``eps`` (1e-8), and an
int8 code at a .5 boundary, which moves the residual by a whole quantum.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import ShapeCell
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import init_params as jax_init_params
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, params_from_jax
from repro_torch.optim import OptConfig, init_opt_state

B, S, STEPS = 4, 32, 3
OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=50)


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                               dtype=torch.float32)
    return jcfg, tcfg


def _batches(vocab):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                                1)
        out.append({"tokens": toks, "labels": labels})
    return out


def _to_port(tree, tcfg):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), tcfg,
                           device="cpu")


def _state_to_port(jo, tcfg):
    """The JAX package's optimizer state as the port's (float32 leaves)."""
    f32 = dataclasses.replace(tcfg, dtype=torch.float32)
    opt = {k: _to_port(v, f32) for k, v in jo.items() if k != "step"}
    opt["step"] = torch.tensor(int(jo["step"]), dtype=torch.int32)
    return opt


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k in got:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= 1e-5 * max(abs(w), 1.0), (k, g, w)


def _hold(got, want, most=0, within=0.0):
    """Each leaf within 1e-5 of its max magnitude (or 1e-6: the residual
    ``ef`` is a small difference of O(1e-1) float32 sums), but for at most
    ``most`` elements in all, each within ``within``."""
    bad = 0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        d = (g.double() - w.double()).abs()
        off = d > max(1e-5 * float(w.abs().max()), 1e-6)
        bad += int(off.sum())
        assert not off.any() or float(d[off].max()) <= within
    assert bad <= most, (bad, most)


@functools.lru_cache(maxsize=None)
def _build(mb, lossy):
    """Both packages' steps and the JAX package's first state, built
    once per case (the JAX step compiles; its state is immutable)."""
    jcfg, tcfg = _cfgs()
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(0))
    built = jax_make_train_step(jcfg, make_host_mesh(),
                                ShapeCell("t", "train", S, B),
                                opt=JaxOptConfig(**OPT), num_microbatches=mb,
                                lossy=lossy, donate=False)
    step = make_train_step(tcfg, opt=OptConfig(**OPT), num_microbatches=mb,
                           lossy=lossy)
    jo = jax_init_opt_state(jparams, with_ef=lossy is not None)
    parts = ["m", "v", "master"] + (["ef"] if lossy else [])
    return jcfg, tcfg, built, step, jo, parts


def _check_step(tcfg, parts, tp, to, tm, jp, jo, jm, most, within):
    _metrics_close(tm, jm)
    want = _state_to_port(jo, tcfg)
    assert set(to) == set(want) == {"step"} | set(parts)
    assert int(to["step"]) == int(want["step"])
    for part in parts:
        _hold(to[part], want[part], most, within)
    for g, w in zip(pytree.tree_leaves(tp), pytree.tree_leaves(_to_port(
            jp, dataclasses.replace(tcfg, dtype=torch.bfloat16)))):
        assert g.dtype == torch.bfloat16     # one rounding of the master
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=2 ** -7, atol=1e-6)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# (microbatches, lossy, most elements off, each within); readings per part
# over the 3 steps: (1, None) 12 at 3.6e-5, (2, None) 13 at 4.0e-5, topk and
# blocktopk none, int8 3 at 6.8e-4 (the residual; a whole int8 quantum)
STEP_CASES = [(1, None, 16, 5e-5), (2, None, 16, 5e-5),
              (1, "topk:0.1", 0, 0.0), (2, "blocktopk:0.05", 0, 0.0),
              (1, "int8", 4, 1e-3)]


@pytest.mark.parametrize("mb,lossy,most,within", STEP_CASES)
def test_train_step_matches_jax(mb, lossy, most, within):
    """3 steps, each from the JAX package's state after the one before,
    with its float32 master weights as the parameters: one step's
    difference, not carried into the next."""
    jcfg, tcfg, built, step, jo, parts = _build(mb, lossy)
    for b in _batches(jcfg.vocab_size):
        to = _state_to_port(jo, tcfg)
        tp, to, tm = step(to["master"], to, _torch_batch(b))
        jp, jo, jm = built.fn(jo["master"], jo, _jax_batch(b))
        _check_step(tcfg, parts, tp, to, tm, jp, jo, jm, most, within)
    assert int(jo["step"]) == STEPS


# readings per part after 3 chained steps: (1, None) 39 at 3.6e-5 and
# (2, None) 37 at 4.0e-5 (the step-1 elements stay off and move their
# neighbours' gradients); topk and blocktopk none: a sparsified gradient
# carries no element near eps.  int8 is held per step only: a flipped code
# moves the residual a quantum, the next steps' codes follow it, and by
# step 3 the loss is off by 2.3e-5 and 11,837 residual elements differ.
CHAINED_CASES = [(1, None, 48, 5e-5), (2, None, 48, 5e-5),
                 (1, "topk:0.1", 0, 0.0), (2, "blocktopk:0.05", 0, 0.0)]


@pytest.mark.parametrize("mb,lossy,most,within", CHAINED_CASES)
def test_chained_train_steps_match_jax(mb, lossy, most, within):
    """3 steps, each package carrying its own state, with its float32
    master weights as the parameters, held after every step."""
    jcfg, tcfg, built, step, jo, parts = _build(mb, lossy)
    to = _state_to_port(jo, tcfg)
    for b in _batches(jcfg.vocab_size):
        tp, to, tm = step(to["master"], to, _torch_batch(b))
        jp, jo, jm = built.fn(jo["master"], jo, _jax_batch(b))
        _check_step(tcfg, parts, tp, to, tm, jp, jo, jm, most, within)
    assert int(to["step"]) == int(jo["step"]) == STEPS


def test_two_microbatches_equal_one():
    """The microbatch fold against one batch, 3 steps, each run carrying
    its own state with its float32 masters as the parameters (reading:
    2 master elements at 9.8e-6, Adam's update near eps)."""
    _, tcfg = _cfgs()
    params = init_params(tcfg, torch.Generator().manual_seed(1),
                         device="cpu")
    one = make_train_step(tcfg, opt=OptConfig(**OPT))
    two = make_train_step(tcfg, opt=OptConfig(**OPT), num_microbatches=2)
    opt = o2 = init_opt_state(params)
    for b in _batches(tcfg.vocab_size):
        tb = _torch_batch(b)
        _, o2, m2 = two(o2["master"], o2, tb)
        _, opt, m1 = one(opt["master"], opt, tb)
        _metrics_close(m2, m1)
        for part in ("m", "v", "master"):
            _hold(o2[part], opt[part], most=4, within=2e-5)
    assert float(m2["tokens"]) == B * (S - 1)


def test_train_step_refuses_the_mesh_tier():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="mesh tier"):
        make_train_step(tcfg, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh tier"):
        make_train_step(tcfg, model_parallel=2)
    step = make_train_step(tcfg, num_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step({}, {}, {"tokens": torch.zeros((4, 8), dtype=torch.int32),
                      "labels": torch.zeros((4, 8), dtype=torch.int32)})
