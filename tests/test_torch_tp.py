"""The mesh tier's serve half against the JAX package's, on 4 ranks.

Tensor and expert parallel serving with explicit per-rank shards: the
expert-parallel MoE strategies (``moe_ffn_replicated``, ``moe_ffn_a2a``),
flash decoding over a sequence-cut cache (``flash_decode_shardmap``),
ring attention (``ring_attention_shardmap`` on ``dist.ppermute``), the
model's ``forward`` / ``prefill`` / ``decode_step`` under ``RunCtx(mesh=)``
(the dense family with KV heads the axis divides, with one KV head, and
with 3 KV heads for 6 query heads, which no slice lines up; the MoE family),
the prefill and decode steps of ``launch/steps.py`` with the batch cut over
``data`` (the decode step also in its flash form), ``gather_params`` and
``build_engine(model_parallel=2)``, greedy, at temperature 0.8 and with
the prefix cache on.

The JAX side runs every case in ONE subprocess on 4 fake XLA devices, mesh
(2, 2) ('data', 'model'); it writes the f32 smoke weights first, and the
port's ONE 4-rank gloo world (one process per rank, ``FileStore`` under
the test's temporary directory, one torch thread each, the same mesh)
loads them and runs every case while the JAX side goes on.  Each rank's
results are checked here, one test per check, at the reference tests'
tolerances.  Both worlds have a join timeout: a hung process fails the
tests and is killed, never the pytest worker.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 300

# the smoke configs in f32, by case name: (arch, overrides)
ARCHS = {"qwen3": ("qwen3-0.6b", {}),
         "qwen3_kv1": ("qwen3-0.6b", {"num_kv_heads": 1}),
         "qwen3_h6kv3": ("qwen3-0.6b", {"num_heads": 6, "num_kv_heads": 3}),
         "moe": ("qwen2-moe-a2.7b", {})}
CONFIG = dict(arch="qwen3-0.6b", num_slots=3, prefill_buckets=(4, 8),
              max_new_tokens=5, prefill_batch=2, prefix_cache=False,
              eos_id=-1)
TRACE = [(0, [5, 9, 2, 7], 5), (0, [11, 3], 5), (0, [6, 6, 6, 1, 9], 4),
         (0, [8, 1, 4, 4, 2, 3, 1], 5), (1, [7], 2), (2, [3, 3, 3, 3], 5),
         (2, [9, 8, 7, 6, 5, 4], 1), (6, [2, 4], 5), (6, [1, 2, 3, 4, 5], 3)]
SHARED = [4, 8, 15, 16, 23, 42]
PREFIX_CONFIG = dict(CONFIG, prefill_buckets=(4, 8, 16), prefix_cache=True,
                     prefix_block=2)
PREFIX_TRACE = [(0, SHARED + [5, 9], 5), (0, [11, 3, 7], 5),
                (0, SHARED + [6], 4), (2, SHARED + [1, 2, 3], 5),
                (3, SHARED + [7, 7, 1, 2], 5), (5, SHARED + [5, 9], 2),
                (8, SHARED + [5, 9, 4, 4, 4, 4, 4, 4], 5)]
# (case, arch case, config overrides, trace)
ENGINES = [("greedy", "qwen3", {}, TRACE),
           ("t08", "qwen3", {"temperature": 0.8, "seed": 5}, TRACE),
           ("moe", "moe", {"arch": "qwen2-moe-a2.7b"}, TRACE),
           ("prefix", "qwen3", {"seed": 3}, PREFIX_TRACE)]

SHARED_CODE = r'''
import sys
import numpy as np
ARCHS, CONFIG, PREFIX_CONFIG, ENGINES = (
    eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4]), eval(sys.argv[5]))


class StepClock:
    """One tick per served step: both engines see the same event times."""
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def serve(engine, trace, clock):
    uids, step, pending = [], 0, list(trace)
    while pending or engine.pending or engine.num_active:
        while pending and pending[0][0] <= step:
            _, prompt, max_new = pending.pop(0)
            uids.append(engine.submit(prompt, max_new_tokens=max_new))
        engine.step()
        step += 1
        clock.t += 0.25
        assert step < 200
    res = [engine.result(u) for u in uids]
    prefix = getattr(engine, "prefix", None)
    return {"hits": prefix.stats.hits if prefix is not None else 0,
            "tokens": [list(r.tokens) for r in res],
            "slot": [r.slot for r in res],
            "stop_step": [r.stop_step for r in res],
            "logprob": [float(r.logprob_sum) for r in res]}
'''

# ---------------------------------------------------------------------------
# the JAX package, 4 fake devices, one subprocess
# ---------------------------------------------------------------------------

JAX_CODE = SHARED_CODE + r'''
import dataclasses, json, os
import repro  # noqa: F401  (installs the jax API compat shims first)
import jax, jax.numpy as jnp
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import get_config
from repro.kernels import ref
from repro.models import decode_step, forward, init_cache, init_params, unembed
from repro.models import attention as A
from repro.models import moe as M
from repro.configs import ShapeCell
from repro.launch.steps import make_prefill_step
from repro.runtime.engine import ContinuousEngine, EngineBackend, ServeConfig
out_path, params_path = sys.argv[1], sys.argv[6]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
tree = jax.tree_util.tree_map

cfgs, params = {}, {}
for name, (arch, over) in ARCHS.items():
    cfgs[name] = dataclasses.replace(get_config(arch, smoke=True),
                                     dtype=jnp.float32, **over)
    params[name] = init_params(cfgs[name], jax.random.PRNGKey(0))[0]
flat = {}
for name, p in params.items():
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        flat[name + "|" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(params_path + ".tmp.npz", **flat)
os.replace(params_path + ".tmp.npz", params_path)   # the ranks wait for it
out = {}

# forward, logits, the decode step over the prompt and two more tokens
for name, cfg in cfgs.items():
    p = params[name]
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (4, 12)).astype(np.int32)
    extra = rng.integers(1, cfg.vocab_size, (4, 2)).astype(np.int32)
    h, st = jax.jit(lambda p, t: forward(p, cfg, t))(p, jnp.asarray(toks))
    out[f"h_{name}"] = np.asarray(h)
    if st is not None:
        out[f"load_{name}"] = np.asarray(st["expert_load"])
    out[f"logits_{name}"] = np.asarray(
        jax.jit(lambda p, h: unembed(p, cfg, h))(p, h))
    step = jax.jit(lambda p, c, t: decode_step(p, cfg, c, t))
    cache = init_cache(p, cfg, 4, 16)
    for t in range(12):
        _, cache = step(p, cache, jnp.asarray(toks[:, t:t + 1]))
    for t in range(2):
        lg, cache = step(p, cache, jnp.asarray(extra[:, t:t + 1]))
        out[f"dec{t}_{name}"] = np.asarray(lg)
    # the reference's own prefill step on the mesh (its MoE capacity drops
    # are the ones the port's step must make)
    built = make_prefill_step(cfg, mesh, ShapeCell("p", "prefill", 12, 4))
    out[f"pstep_{name}"] = np.asarray(built.fn(
        jax.device_put(p, built.in_shardings[0]),
        jax.device_put({"tokens": jnp.asarray(toks)}, built.in_shardings[1])))

# the expert-parallel strategies (tests/test_distributed.py's cases)
cfg = cfgs["moe"]
ffn = tree(lambda a: a[0], params["moe"]["layers"])["slot_0"]["ffn"]
x = jnp.asarray(np.random.default_rng(1).normal(
    size=(4, 16, cfg.d_model)).astype(np.float32))
o, s = M.moe_ffn_local(ffn, cfg, x)
out["moe_local"], out["moe_local_load"] = np.asarray(o), np.asarray(s["expert_load"])
o, s = jax.jit(lambda f, x: M.moe_ffn_replicated(
    f, cfg, x, mesh, axis_name="model", batch_axes=("data",)))(ffn, x)
out["moe_rep"], out["moe_rep_load"] = np.asarray(o), np.asarray(s["expert_load"])
out["moe_rep_dropped"] = np.asarray(s["dropped"])
cfg8 = dataclasses.replace(cfg, moe_capacity_factor=8.0)
o, s = jax.jit(lambda f, x: M.moe_ffn_a2a(
    f, cfg8, x, mesh, axis_name="model", batch_axes=("data",)))(ffn, x)
out["moe_a2a"], out["moe_a2a_load"] = np.asarray(o), np.asarray(s["expert_load"])
out["moe_a2a_dropped"] = np.asarray(s["dropped"])

# flash decoding over the cache's rows cut over 'model'
cfg = cfgs["qwen3"]
pa = tree(lambda a: a[0], params["qwen3"]["layers"])["slot_0"]["mix"]
rng = np.random.default_rng(2)
B, S = 2, 64
x = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32))
k = jnp.asarray(rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
v = jnp.asarray(rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
for pos in (40, 10):
    want, (k1, _) = A.attention_decode(pa, cfg, x, (k, v), jnp.int32(pos))
    got, (k2, _) = A.flash_decode_shardmap(pa, cfg, x, (k, v), jnp.int32(pos),
                                           mesh, axis_name="model")
    out[f"fd_want_{pos}"], out[f"fd_got_{pos}"] = np.asarray(want), np.asarray(got)
    out[f"fd_k_{pos}"], out[f"fd_kwant_{pos}"] = np.asarray(k2), np.asarray(k1)

# ring attention over 'model'
rng = np.random.default_rng(3)
q, k, v = (jnp.asarray(rng.normal(size=(2, 64, 4, 16)).astype(np.float32))
           for _ in range(3))
for causal in (True, False):
    out[f"ring_{causal}"] = np.asarray(A.ring_attention_shardmap(
        q, k, v, mesh, axis_name="model", causal=causal))
out["ring_ref"] = np.asarray(ref.flash_attention_ref(
    q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
    v.transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3))

# the engine on one device, the same weights, trace and clock
engines = {}
for case, name, over, trace in ENGINES:
    cfg, p = cfgs[name], params[name]
    base = PREFIX_CONFIG if case == "prefix" else CONFIG
    config = ServeConfig(**{**base, **over})

    def decode(p, cache, cur, cfg=cfg):
        logits, cache = decode_step(p, cfg, cache, cur)
        return logits[:, -1].astype(jnp.float32), cache

    def make_cache(batch, pos_per_slot, cfg=cfg, p=p, config=config):
        return init_cache(p, cfg, batch, config.max_seq,
                          pos_per_slot=pos_per_slot)

    backend = EngineBackend(decode=decode, init_cache=make_cache, params=p,
                            vocab_size=cfg.vocab_size,
                            prefix_sharing=config.prefix_cache)
    clock = StepClock()
    engines[case] = serve(ContinuousEngine(backend, config, clock=clock),
                          trace, clock)
out["engines"] = np.array(json.dumps(engines))
np.savez(out_path, **out)
'''

# ---------------------------------------------------------------------------
# the port, one process per rank of a 4-rank gloo world
# ---------------------------------------------------------------------------

RANK_CODE = SHARED_CODE + r'''
import dataclasses, os, time
import torch
import torch.distributed as tdist
torch.set_num_threads(1)
rank, store, path, params_path = (int(sys.argv[1]), sys.argv[6], sys.argv[7],
                                  sys.argv[8])
from repro_torch import dist
from repro_torch.configs import ShapeCell, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.serve import ServeConfig, build_engine
from repro_torch.launch.steps import make_cache, make_decode_step, make_prefill_step
from repro_torch.models import (RunCtx, decode_step, forward_with_stats,
                                init_cache, params_from_jax, prefill, unembed)
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.transformer import param_axes, param_shapes

init_distributed("gloo", rank, 4, tdist.FileStore(store, 4), timeout_s=120)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
deadline = time.monotonic() + 240
while not os.path.exists(params_path):      # the JAX side writes it first
    assert time.monotonic() < deadline, "no weights from the JAX side"
    time.sleep(0.2)
flat = np.load(params_path)
cfgs, params = {}, {}
for name, (arch, over) in ARCHS.items():
    cfgs[name] = dataclasses.replace(get_config(arch, smoke=True),
                                     dtype=torch.float32, **over)
    tree = {}
    for key in flat.files:
        case, leaf = key.split("|", 1)
        if case != name:
            continue
        node = tree
        *parents, last = leaf.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = flat[key]
    params[name] = params_from_jax(tree, cfgs[name], device="cpu")
out = {}
ctx = RunCtx(mesh=mesh)
SERVE = shd.SERVE_RULES

# forward, logits, prefill and decode under RunCtx(mesh=)
for name, cfg in cfgs.items():
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 12)).astype(np.int32))
    extra = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 2)).astype(np.int32))
    local = shd.shard_params(params[name], param_axes(cfg), mesh, SERVE)
    h, st = forward_with_stats(local, cfg, toks, ctx=ctx)
    out[f"h_{name}"] = h
    if st is not None:
        out[f"load_{name}"] = st["expert_load"]
    with shd.use_rules(mesh, SERVE):
        out[f"logits_{name}"] = unembed(local, cfg, h)
    cache = init_cache(local, cfg, 4, 16, ctx=ctx)
    out[f"cache_heads_{name}"] = cache["layers"][0]["k"].shape[2]
    lg, cache = prefill(local, cfg, cache, toks, torch.full((4,), 12), ctx=ctx)
    out[f"prefill_{name}"] = lg
    for t in range(2):
        lg, cache = decode_step(local, cfg, cache, extra[:, t:t + 1], ctx=ctx)
        out[f"dec{t}_{name}"] = lg
    # the steps, the batch cut over 'data'
    built = make_prefill_step(cfg, mesh, ShapeCell("p", "prefill", 12, 4))
    p_l, b_l = built.local(params[name], {"tokens": toks})
    out[f"pstep_{name}"] = built.fn(p_l, b_l)
    if name in ("qwen3", "moe"):
        for impl in ("dense", "flash"):
            built = make_decode_step(cfg, mesh, ShapeCell("d", "decode", 16, 4),
                                     ctx=RunCtx(decode_impl=impl))
            (p_l,) = built.local(params[name])
            c = make_cache(built, cfg, p_l, 2, 16)
            out[f"dstep_rows_{impl}_{name}"] = c["layers"][0]["k"].shape[1]
            for t in list(toks.T) + list(extra.T):
                lg, c = built.fn(p_l, c, t[2 * di:2 * di + 2, None])
            out[f"dstep_{impl}_{name}"] = lg

# the expert-parallel strategies, the batch cut over 'data'
cfg = cfgs["moe"]
ffn = params["moe"]["layers"][0]["ffn"]
local_ffn = shd.shard_params(params["moe"], param_axes(cfg), mesh,
                             SERVE)["layers"][0]["ffn"]
x = torch.from_numpy(np.random.default_rng(1).normal(
    size=(4, 16, cfg.d_model)).astype(np.float32))[2 * di:2 * di + 2]
out["moe_local"], s = M.moe_ffn_local(ffn, cfg, x)
out["moe_local_load"] = s["expert_load"]
with shd.use_rules(mesh, SERVE):
    o, s = M.moe_ffn_replicated(local_ffn, cfg, x, batch_axes=("data",))
    out["moe_rep"], out["moe_rep_load"], out["moe_rep_dropped"] = (
        o, s["expert_load"], s["dropped"])
    dist.reset_counts()
    o, s = M.moe_ffn_a2a(local_ffn, dataclasses.replace(cfg, moe_capacity_factor=8.0),
                         x, batch_axes=("data",))
    out["moe_a2a_counts"] = dist.counts()
    out["moe_a2a"], out["moe_a2a_load"], out["moe_a2a_dropped"] = (
        o, s["expert_load"], s["dropped"])
    o, _ = M.moe_ffn(local_ffn, dataclasses.replace(cfg, moe_capacity_factor=8.0),
                     x, mesh=mesh, impl="a2a", batch_axes=("data",))
    out["moe_dispatch_a2a"] = o

# flash decoding: this rank's 32 of the 64 cache rows
cfg = cfgs["qwen3"]
pa = params["qwen3"]["layers"][0]["mix"]
rng = np.random.default_rng(2)
B, S = 2, 64
x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32))
k = torch.from_numpy(rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
v = torch.from_numpy(rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
for pos in (40, 10):
    kc, vc = (t[:, 32 * mi:32 * mi + 32].clone() for t in (k, v))
    got, (k2, _) = A.flash_decode_shardmap(pa, cfg, x, (kc, vc),
                                           torch.tensor(pos, dtype=torch.int32),
                                           mesh, axis_name="model")
    out[f"fd_got_{pos}"], out[f"fd_k_{pos}"] = got, k2
    out[f"fd_inplace_{pos}"] = k2 is kc
try:
    A.flash_decode_shardmap(pa, cfg, x, (kc, vc), torch.zeros(2, dtype=torch.int32),
                            mesh, axis_name="model")
except NotImplementedError as e:
    out["fd_per_slot"] = str(e)

# ring attention: this rank's 32 of the 64 positions
rng = np.random.default_rng(3)
q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 4, 16)).astype(np.float32))
           for _ in range(3))
blk = lambda t: t[:, 32 * mi:32 * mi + 32]
for causal in (True, False):
    dist.reset_counts()
    out[f"ring_{causal}"] = A.ring_attention_shardmap(
        blk(q), blk(k), blk(v), mesh, axis_name="model", causal=causal)
    out[f"ring_counts_{causal}"] = dist.counts()

# ppermute, counted
x = torch.full((3,), float(rank))
dist.reset_counts()
with dist.use_mesh(mesh):
    out["pp_swap"] = dist.ppermute(x, "model", [(0, 1), (1, 0)])
    out["pp_one"] = dist.ppermute(x, "model", [(0, 1)])
out["pp_counts"] = dist.counts()

# shard, then gather in the world
cfg = cfgs["moe"]
local = shd.shard_params(params["moe"], param_axes(cfg), mesh, shd.TRAIN_RULES)
back = shd.gather_params(local, param_axes(cfg), mesh, shd.TRAIN_RULES,
                         param_shapes(cfg))
out["gather_equal"] = all(torch.equal(a, b) for a, b in zip(
    torch.utils._pytree.tree_leaves(back),
    torch.utils._pytree.tree_leaves(params["moe"])))
out["gather_cut"] = local["layers"][0]["ffn"]["we_gate"].shape[0]

# build_engine(model_parallel=2): every rank the same engine and schedule
engines = {}
for case, name, over, trace in ENGINES:
    base = PREFIX_CONFIG if case == "prefix" else CONFIG
    config = ServeConfig(**{**base, **over, "model_parallel": 2})
    clock = StepClock()
    eng = build_engine(config, device="cpu", params=params[name],
                       model_config=cfgs[name], clock=clock)
    engines[case] = serve(eng, trace, clock)
out["engines"] = engines
# this process's own peak since its exec (VmHWM): ru_maxrss would also
# count the resident pages of the pytest worker it was forked from
with open("/proc/self/status") as f:
    out["maxrss_kb"] = next(int(line.split()[1]) for line in f
                            if line.startswith("VmHWM:"))
torch.save(out, path)
tdist.destroy_process_group()
'''


def _wait(procs, what, deadline):
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            pytest.fail(f"{what}: a process was still running after "
                        f"{TIMEOUT_S}s (killed)")
    bad = [(i, p.returncode, p.stderr.read()[-3000:]) for i, p in
           enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"{what} failed: " + "\n".join(
            f"[{i}] rc={rc}\n{err}" for i, rc, err in bad))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the JAX package's results, each rank's results): the JAX side on 4
    fake devices and the 4-rank world, run side by side."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    shared = [repr(ARCHS), repr(CONFIG), repr(PREFIX_CONFIG), repr(ENGINES)]
    params_path = str(tmp / "params.npz")
    jax_out = str(tmp / "jax.npz")
    procs = []
    try:
        jax_proc = subprocess.Popen(
            [sys.executable, "-c", JAX_CODE, jax_out] + shared +
            [params_path], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        procs.append(jax_proc)
        env = {k: v for k, v in env.items() if k != "XLA_FLAGS"}
        store = str(tmp / "store")
        outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
        ranks = [subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, str(r)] + shared +
            [store, outs[r], params_path], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        procs += ranks
        deadline = time.monotonic() + TIMEOUT_S
        _wait(ranks, f"the port's {WORLD}-rank gloo world", deadline)
        _wait([jax_proc], "the JAX package on 4 fake devices", deadline)
    finally:
        for p in procs:          # only this fixture's own children
            if p.poll() is None:
                p.kill()
                p.wait()
    import json
    jax_res = dict(np.load(jax_out))
    jax_res["engines"] = json.loads(str(jax_res["engines"]))
    return jax_res, [torch.load(o, weights_only=False) for o in outs]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _coords(rank):
    return rank // 2, rank % 2          # (data, model), row-major


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol,
                               err_msg=what)


# -- the model under RunCtx(mesh=) -------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_tp_forward_matches_jax(results, name):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        _close(res[f"h_{name}"], jax_res[f"h_{name}"], 1e-4, f"rank {r}")
        _close(res[f"logits_{name}"], jax_res[f"logits_{name}"], 1e-4,
               f"rank {r}")
        if name == "moe":
            np.testing.assert_array_equal(_np(res["load_moe"]),
                                          jax_res["load_moe"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_tp_prefill_and_decode_match_jax(results, name):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        _close(res[f"prefill_{name}"], jax_res[f"logits_{name}"][:, -1],
               1e-4, f"rank {r}")
        for t in range(2):
            _close(res[f"dec{t}_{name}"], jax_res[f"dec{t}_{name}"], 1e-4,
                   f"rank {r} step {t}")


def test_kv_heads_the_axis_does_not_divide_stay_whole(results):
    """qwen3 smoke (KV 2) cuts its KV heads over model = 2; with 1 or 3 KV
    heads ``spec_for`` replicates them and the cache holds them all."""
    _, ranks = results
    for res in ranks:
        assert res["cache_heads_qwen3"] == 1
        assert res["cache_heads_qwen3_kv1"] == 1
        assert res["cache_heads_qwen3_h6kv3"] == 3
        assert res["cache_heads_moe"] == 2


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_step_matches_the_references_on_the_mesh(results, name):
    """``make_prefill_step`` with the batch cut over 'data' against the
    reference's step on the same mesh (for the MoE config its expert
    capacity drops pairs of some rows, in both packages alike)."""
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        d, _ = _coords(r)
        want = jax_res[f"pstep_{name}"][2 * d:2 * d + 2]
        _close(res[f"pstep_{name}"], want, 1e-4, f"rank {r}")


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name", ["qwen3", "moe"])
def test_decode_step_matches_jax(results, name, impl):
    """``make_decode_step`` over the prompt and two more tokens; the flash
    form holds half the cache's rows a rank."""
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        d, _ = _coords(r)
        assert res[f"dstep_rows_{impl}_{name}"] == \
            (8 if impl == "flash" else 16)
        _close(res[f"dstep_{impl}_{name}"],
               jax_res[f"dec1_{name}"][2 * d:2 * d + 2], 1e-4, f"rank {r}")


# -- the expert-parallel strategies -------------------------------------------

@pytest.mark.parametrize("impl", ["rep", "a2a"])
def test_moe_strategy_matches_jax_and_local(results, impl):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        d, _ = _coords(r)
        rows = slice(2 * d, 2 * d + 2)
        _close(res[f"moe_{impl}"], jax_res[f"moe_{impl}"][rows], 2e-3,
               f"rank {r}")
        _close(res[f"moe_{impl}"], _np(res["moe_local"]), 2e-3, f"rank {r}")
        _close(res["moe_local"], jax_res["moe_local"][rows], 2e-3,
               f"rank {r}")
        np.testing.assert_array_equal(_np(res[f"moe_{impl}_load"]),
                                      jax_res[f"moe_{impl}_load"])
        np.testing.assert_array_equal(_np(res[f"moe_{impl}_load"]),
                                      jax_res["moe_local_load"])
        assert int(res[f"moe_{impl}_dropped"]) == 0 == \
            int(jax_res[f"moe_{impl}_dropped"])


def test_moe_a2a_collectives(results):
    """On 'model': the tokens' and expert ids' all_to_alls, the way back,
    the gather of the sequence, the shared experts' psum and the stats'
    (also on 'data'); ``moe_ffn(impl="a2a")`` dispatches to it."""
    _, ranks = results
    for res in ranks:
        c = res["moe_a2a_counts"]
        assert c["model"]["calls"] == 6 and c["data"]["calls"] == 1
        assert torch.equal(res["moe_dispatch_a2a"], res["moe_a2a"])


# -- flash decoding and ring attention -----------------------------------------

@pytest.mark.parametrize("pos", [40, 10])
def test_flash_decode_shardmap_matches_dense(results, pos):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        _, m = _coords(r)
        _close(res[f"fd_got_{pos}"], jax_res[f"fd_want_{pos}"], 2e-3,
               f"rank {r}")
        _close(res[f"fd_got_{pos}"], jax_res[f"fd_got_{pos}"], 2e-3,
               f"rank {r}")
        np.testing.assert_allclose(
            _np(res[f"fd_k_{pos}"]),
            jax_res[f"fd_kwant_{pos}"][:, 32 * m:32 * m + 32], rtol=1e-5)
        assert res[f"fd_inplace_{pos}"]
        assert "scalar cache position" in res["fd_per_slot"]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(results, causal):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        _, m = _coords(r)
        rows = slice(32 * m, 32 * m + 32)
        _close(res[f"ring_{causal}"], jax_res[f"ring_{causal}"][:, rows],
               2e-4, f"rank {r}")
        if causal:
            _close(res["ring_True"], jax_res["ring_ref"][:, rows], 2e-4,
                   f"rank {r}")
        # one hop of K and V over 'model': 2 x 2 x 32 x 4 x 16 f32 sent
        c = res[f"ring_counts_{causal}"]["model"]
        assert c["calls"] == 2 and c["bytes"] == 2 * 2 * 32 * 4 * 16 * 4


def test_ppermute_is_counted(results):
    _, ranks = results
    for r, res in enumerate(ranks):
        _, m = _coords(r)
        partner = r ^ 1
        np.testing.assert_array_equal(_np(res["pp_swap"]),
                                      np.full(3, partner, np.float32))
        want = np.full(3, r - 1, np.float32) if m == 1 else np.zeros(3)
        np.testing.assert_array_equal(_np(res["pp_one"]), want)
        c = res["pp_counts"]["model"]
        assert c["calls"] == 2
        assert c["bytes"] == c["wire_bytes"] == 12 * (2 if m == 0 else 1)


def test_gather_params_inverts_shard_params(results):
    _, ranks = results
    for res in ranks:
        assert res["gather_equal"] and res["gather_cut"] == 4


# -- the engine at model_parallel=2 --------------------------------------------

@pytest.mark.parametrize("case", [c for c, *_ in ENGINES])
def test_engine_model_parallel_matches_jax_engine(results, case):
    jax_res, ranks = results
    want = jax_res["engines"][case]
    for r, res in enumerate(ranks):
        got = res["engines"][case]
        assert got["tokens"] == want["tokens"], (r, got["tokens"])
        assert got["slot"] == want["slot"]
        assert got["stop_step"] == want["stop_step"]
        np.testing.assert_allclose(got["logprob"], want["logprob"],
                                   atol=1e-4)
        assert got["hits"] == want["hits"]
    if case == "prefix":
        assert want["hits"] >= 3


def test_world_memory(results):
    """The ranks' summed peak RSS (recorded in CHANGES.md) stays small."""
    _, ranks = results
    total_gib = sum(res["maxrss_kb"] for res in ranks) / 2 ** 20
    print(f"the 4 ranks' summed peak RSS: {total_gib:.2f} GiB")
    assert total_gib < 6.0, total_gib


def test_cli_model_parallel_serves_the_one_rank_tokens(tmp_path):
    """The serve CLI's ``--model-parallel 2`` world (its rank function,
    started as ``run_cli`` starts it, with a join timeout) against the
    CLI on one rank: the same requests, tokens and logprob sums."""
    from repro_torch.launch.mesh import run_world
    from repro_torch.launch.serve import _cli_rank, run_cli

    argv = ["--device", "cpu", "--requests", "6", "--slots", "3",
            "--buckets", "4,12", "--gen", "6", "--rate", "0",
            "--prefill-batch", "2", "--temperature", "0"]
    one = run_cli(argv)["results"]
    ranks = run_world(_cli_rank, 2, args=(argv + ["--model-parallel", "2"],
                                          "cpu"),
                      timeout_s=240, store_dir=str(tmp_path))
    for res in ranks:
        got = res["results"]
        assert [r.tokens for r in got] == [r.tokens for r in one]
        np.testing.assert_allclose([r.logprob_sum for r in got],
                                   [r.logprob_sum for r in one], atol=1e-4)
