"""The port's serving engine vs the JAX package's, end to end.

Both engines serve the qwen3-0.6b smoke model in float32 with the SAME
weights (the JAX init carried over by ``params_from_jax``), prefix cache
off, over the same arrival trace (requests submitted at fixed engine
steps).  The slot and batch composition is therefore identical, and every
request must come back with identical tokens, stop flag, slot and stop
step, and a logprob sum within 1e-4: greedy, and at temperature 0.8, where
both engines draw from the same threefry key streams.
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
from repro.runtime.engine import ContinuousEngine as JaxEngine
from repro.runtime.engine import EngineBackend as JaxBackend
from repro.runtime.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.core.calibration import default_calibration, use_calibration
from repro_torch.models import params_from_jax
from repro_torch.serving import (ContinuousEngine, ServeConfig, build_engine,
                                 decode_metrics_plan, extract_metrics,
                                 make_backend)

CONFIG = dict(arch="qwen3-0.6b", num_slots=3, prefill_buckets=(4, 8),
              max_new_tokens=5, prefill_batch=2)
# (engine step at which the request arrives, prompt, max_new_tokens)
TRACE = [(0, [5, 9, 2, 7], 5), (0, [11, 3], 5), (0, [6, 6, 6, 1, 9], 4),
         (0, [8, 1, 4, 4, 2, 3, 1], 5), (1, [7], 2), (2, [3, 3, 3, 3], 5),
         (2, [9, 8, 7, 6, 5, 4], 1), (6, [2, 4], 5), (6, [1, 2, 3, 4, 5], 3)]


@pytest.fixture(autouse=True)
def _shipped_calibration():
    with use_calibration(default_calibration()):
        yield


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                               dtype=torch.float32)
    jparams, _ = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _jax_engine(weights, **overrides):
    jcfg, _, jparams, _ = weights
    config = JaxServeConfig(**{**CONFIG, "prefix_cache": False, **overrides})

    def decode(p, cache, cur):
        logits, cache = jax_decode_step(p, jcfg, cache, cur)
        return logits[:, -1].astype(jnp.float32), cache

    def make_cache(batch, pos_per_slot):
        return jax_init_cache(jparams, jcfg, batch, config.max_seq,
                              pos_per_slot=pos_per_slot)

    backend = JaxBackend(decode=decode, init_cache=make_cache,
                         params=jparams, vocab_size=jcfg.vocab_size,
                         prefix_sharing=False)
    return JaxEngine(backend, config)


def _port_engine(weights, **overrides):
    _, tcfg, _, tparams = weights
    config = ServeConfig(**{**CONFIG, **overrides})
    return ContinuousEngine(make_backend(tcfg, tparams, config, "cpu"), config)


def _serve(engine, trace):
    """Submit each request at its arrival step; drain.  -> results."""
    uids, step = [], 0
    pending = list(trace)
    while pending or engine.pending or engine.num_active:
        while pending and pending[0][0] <= step:
            _, prompt, max_new = pending.pop(0)
            uids.append(engine.submit(prompt, max_new_tokens=max_new))
        engine.step()
        step += 1
        assert step < 200
    return [engine.result(u) for u in uids]


def test_engine_matches_jax_engine(weights):
    # pick an eos the model actually emits, so stop flags are exercised
    probe = _serve(_port_engine(weights, eos_id=-1), TRACE)
    toks = np.concatenate([np.asarray(r.tokens, np.int64) for r in probe])
    eos = int(np.bincount(toks).argmax())

    jeng = _jax_engine(weights, eos_id=eos)
    teng = _port_engine(weights, eos_id=eos)
    want, got = _serve(jeng, TRACE), _serve(teng, TRACE)
    assert any(r.stopped for r in got) and not all(r.stopped for r in got)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert g.stopped == w.stopped and g.slot == w.slot
        assert g.stop_step == w.stop_step and g.bucket == w.bucket
        assert abs(g.logprob_sum - w.logprob_sum) <= 1e-4
    assert teng.stats.slot_reuses >= 1 and teng.stats.batched_admissions >= 2
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    counts = teng.compile_counts()
    assert counts["step"] == 1
    assert all(v == 1 for v in counts.values())
    assert sum(counts.values()) <= teng.compile_bound() == jeng.compile_bound()


@pytest.mark.parametrize("seed", [0, 5])
def test_engine_samples_the_jax_engines_stream(weights, seed):
    """temperature 0.8: the port's threefry keys (engine seed, request
    seed, token index) and Gumbel-max give the JAX engine's tokens token for
    token, at the same slot and batch composition."""
    over = dict(temperature=0.8, seed=seed, eos_id=-1)
    want = _serve(_jax_engine(weights, **over), TRACE)
    got = _serve(_port_engine(weights, **over), TRACE)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert g.slot == w.slot and g.stop_step == w.stop_step
        assert abs(g.logprob_sum - w.logprob_sum) <= 1e-4
    greedy = _serve(_port_engine(weights, eos_id=-1), TRACE)
    assert [r.tokens for r in greedy] != [r.tokens for r in got]


def test_metrics_table_is_one_masked_keyed_fold(weights):
    """The per-step aggregation plan, and the table read back at the end."""
    plan = decode_metrics_plan(3, 3, device="cpu")
    assert len(plan.tiers) == 1
    assert plan.local_tier.kind == "segment_ops"      # CPU: no kernel tier
    assert "+mask" in plan.local_tier.detail
    eng = _port_engine(weights)
    uid = eng.submit([5, 9, 2, 7])
    for _ in eng.run(max_steps=50):
        pass
    res = eng.result(uid)
    m = extract_metrics(eng._table)
    assert m["tokens"][res.slot] == len(res.tokens)
    assert np.float32(m["logprob_sum"][res.slot]) == np.float32(res.logprob_sum)


def test_sampling_streams_are_request_keyed(weights):
    """temperature > 0: a request samples the same tokens alone or in a
    rolling batch (its generator is keyed by (seed, request, token))."""
    prompts = [[5, 9, 2, 7], [11, 3], [6, 6, 6]]
    eng = _port_engine(weights, temperature=1.0, eos_id=-1)
    uids = [eng.submit(p, seed=100 + i) for i, p in enumerate(prompts)]
    for _ in eng.run(max_steps=100):
        pass
    for i, p in enumerate(prompts):
        solo = _port_engine(weights, temperature=1.0, eos_id=-1)
        u = solo.submit(p, seed=100 + i)
        for _ in solo.run(max_steps=100):
            pass
        assert solo.result(u).tokens == eng.result(uids[i]).tokens


def test_entry_points_refuse_what_is_not_ported(weights):
    with pytest.raises(NotImplementedError, match="prefix"):
        _port_engine(weights, prefix_cache=True)
    with pytest.raises(NotImplementedError, match="mesh"):
        build_engine(ServeConfig(model_parallel=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine(ServeConfig())


def test_build_engine_serves_random_weights_on_cpu():
    eng = build_engine(ServeConfig(num_slots=2, prefill_buckets=(8,),
                                   max_new_tokens=3), device="cpu")
    uid = eng.submit([1, 2, 3])
    for _ in eng.run(max_steps=20):
        pass
    res = eng.result(uid)
    assert 1 <= len(res.tokens) <= 3 and np.isfinite(res.logprob_sum)
    assert sum(eng.compile_counts().values()) <= eng.compile_bound()


def test_one_pass_prefill_equals_the_decode_loop(weights):
    """The dense backend's one-pass prefill against the engine's decode loop
    (what a backend without ``prefill`` gets): the same tokens, slots, stop
    steps, stats and program shapes, logprob sums within 1e-4."""
    _, tcfg, _, tparams = weights
    config = ServeConfig(**{**CONFIG, "eos_id": -1})
    backend = make_backend(tcfg, tparams, config, "cpu")
    assert backend.prefill is not None
    one_pass = ContinuousEngine(backend, config)
    looped = ContinuousEngine(dataclasses.replace(backend, prefill=None),
                              config)
    want, got = _serve(looped, TRACE), _serve(one_pass, TRACE)
    for w, g in zip(want, got):
        assert (g.tokens, g.slot, g.stop_step) == (w.tokens, w.slot,
                                                    w.stop_step)
        assert abs(g.logprob_sum - w.logprob_sum) <= 1e-4
    assert dataclasses.asdict(one_pass.stats) == \
        dataclasses.asdict(looped.stats)
    assert one_pass.compile_counts() == looped.compile_counts()
