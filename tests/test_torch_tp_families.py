"""The mesh tier's serve half for MLA, the recurrent and the context
families against the JAX package's, on 4 ranks.

deepseek-v2-236b (MLA), xlstm-1.3b and jamba-v0.1-52b (recurrent),
whisper-small and llama-3.2-vision-90b (context), each at its f32 smoke
config, served on explicit per-rank shards: ``forward`` under
``RunCtx(mesh=)``, the prefill and decode steps of ``launch/steps.py``
(the batch and the context cut over 'data', every cache leaf this rank's
block; jamba's decode step also in its flash form), ``build_engine(
model_parallel=2)`` for deepseek (the prefix cache on) and xlstm, greedy
and at temperature 0.8, ``build_serve_step(model_parallel=2)`` for whisper
and the vision model, xlstm at mesh (1, 4) (one head a rank), and the
packed leaves (Mamba's ``w_in``, mLSTM's ``w_up``) cut by their halves.

The JAX side runs the reference's functions and its steps on the mesh in
ONE subprocess on 4 fake XLA devices, mesh (2, 2) ('data', 'model'); it
writes the f32 smoke weights first (the cross-attention gates at 0.5: the
reference starts them at 0, which hides ``xattn``; an expert capacity of
every routed pair, so the mesh drops none and a rank computes one
device's function), and the port's ONE 4-rank gloo world (one process per
rank, ``FileStore`` under the test's temporary directory, one torch thread
each) loads them and runs every case while the JAX side goes on.  Each
rank's results are checked here, one test per check, at the reference
tests' tolerances; integer tokens exactly.  Both worlds have a join
timeout that kills only the fixture's own children.
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

# the smoke configs in f32, by case name: (arch, overrides); capacity 4 =
# the largest model axis here: no routed pair is dropped on the mesh
ARCHS = {"deepseek": ("deepseek-v2-236b", {"moe_capacity_factor": 4.0}),
         "xlstm": ("xlstm-1.3b", {}),
         "jamba": ("jamba-v0.1-52b", {"moe_capacity_factor": 4.0}),
         "whisper": ("whisper-small", {}),
         "vision": ("llama-3.2-vision-90b", {})}
GATE = 0.5
B, S, EXTRA, MAX_SEQ = 4, 12, 2, 16
SERVE_STEPS = 6
CONFIG = dict(num_slots=3, prefill_buckets=(4, 8), max_new_tokens=5,
              prefill_batch=2, prefix_cache=False, eos_id=-1)
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
ENGINES = [("deepseek_greedy", "deepseek", {"prefix": True}, PREFIX_TRACE),
           ("deepseek_t08", "deepseek",
            {"prefix": True, "temperature": 0.8, "seed": 5}, PREFIX_TRACE),
           ("xlstm_greedy", "xlstm", {}, TRACE[:6]),
           ("xlstm_t08", "xlstm", {"temperature": 0.8, "seed": 5},
            TRACE[:6])]

SHARED_CODE = r'''
import sys
import numpy as np
ARCHS, CONFIG, PREFIX_CONFIG, ENGINES = (
    eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4]), eval(sys.argv[5]))
B, S, EXTRA, MAX_SEQ, SERVE_STEPS, GATE = eval(sys.argv[6])


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


def engine_config(case_over):
    over = dict(case_over)
    base = PREFIX_CONFIG if over.pop("prefix", False) else CONFIG
    return {**base, **over}


def inputs(cfg, rng_seed=7):
    rng = np.random.default_rng(rng_seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = rng.integers(1, cfg.vocab_size, (B, EXTRA)).astype(np.int32)
    ctx = None
    if cfg.family == "audio":
        ctx = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    elif cfg.family == "vlm":
        ctx = rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model))
    return toks, extra, None if ctx is None else ctx.astype(np.float32)
'''

# ---------------------------------------------------------------------------
# the JAX package, 4 fake devices, one subprocess
# ---------------------------------------------------------------------------

JAX_CODE = SHARED_CODE + r'''
import dataclasses, json, os
import repro  # noqa: F401  (installs the jax API compat shims first)
import jax, jax.numpy as jnp
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import ShapeCell, get_config
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models import RunCtx, decode_step, forward, init_cache, init_params, unembed
from repro.runtime.engine import ContinuousEngine, EngineBackend, ServeConfig
out_path, params_path = sys.argv[1], sys.argv[7]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
tree = jax.tree_util


def gated(path, leaf):
    return jnp.full_like(leaf, GATE) if path[-1].key == "gate" else leaf


cfgs, params = {}, {}
for name, (arch, over) in ARCHS.items():
    cfgs[name] = dataclasses.replace(get_config(arch, smoke=True),
                                     dtype=jnp.float32, **over)
    params[name] = tree.tree_map_with_path(
        gated, init_params(cfgs[name], jax.random.PRNGKey(0))[0])
flat = {}
for name, p in params.items():
    for path, leaf in tree.tree_flatten_with_path(p)[0]:
        flat[name + "|" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(params_path + ".tmp.npz", **flat)
os.replace(params_path + ".tmp.npz", params_path)   # the ranks wait for it
out = {}


def layer_cache(cache, cfg, i):
    """Layer i's cache leaves (the stacked periods unstacked)."""
    pre, P = cfg.prelude_dense_layers, cfg.period
    n = (cfg.num_layers - pre) // P
    if i < pre:
        return cache[f"prelude_{i}"]
    j = i - pre
    if j < n * P:
        return {k: v[j // P] for k, v in cache["layers"][f"slot_{j % P}"].items()}
    return cache[f"rem_{j - n * P}"]


for name, cfg in cfgs.items():
    p = params[name]
    toks, extra, ctx = inputs(cfg)
    ctx = None if ctx is None else jnp.asarray(ctx)
    h, _ = jax.jit(lambda p, t, c: forward(p, cfg, t, context=c))(
        p, jnp.asarray(toks), ctx)
    out[f"logits_{name}"] = np.asarray(
        jax.jit(lambda p, h: unembed(p, cfg, h))(p, h))
    # the reference's steps on the mesh
    batch = {"tokens": jnp.asarray(toks)}
    if ctx is not None:
        batch["context"] = ctx
    built = make_prefill_step(cfg, mesh, ShapeCell("p", "prefill", S, B))
    out[f"pstep_{name}"] = np.asarray(built.fn(
        jax.device_put(p, built.in_shardings[0]),
        jax.device_put(batch, built.in_shardings[1])))
    impls = ("dense", "flash") if name == "jamba" else ("dense",)
    for impl in impls:
        built = make_decode_step(cfg, mesh, ShapeCell("d", "decode", MAX_SEQ, B),
                                 ctx=RunCtx(mesh=mesh, decode_impl=impl),
                                 donate=False)
        pm = jax.device_put(p, built.in_shardings[0])
        cache = jax.device_put(init_cache(p, cfg, B, MAX_SEQ, context=ctx),
                               built.in_shardings[1])
        for t in range(S):
            _, cache = built.fn(pm, cache, jnp.asarray(toks[:, t:t + 1]))
        for t in range(EXTRA):
            lg, cache = built.fn(pm, cache, jnp.asarray(extra[:, t:t + 1]))
            out[f"dec{t}_{impl}_{name}"] = np.asarray(lg)
        for i in range(cfg.num_layers):
            for leaf, v in layer_cache(cache, cfg, i).items():
                out[f"cache_{impl}_{name}|{i}|{leaf}"] = np.asarray(v)
        if ctx is not None:
            # the fixed-shape serve step: greedy from the last prompt token
            cache = jax.device_put(init_cache(p, cfg, B, MAX_SEQ, context=ctx),
                                   built.in_shardings[1])
            tok = jnp.asarray(toks[:, -1:])
            for t in range(SERVE_STEPS):
                lg, cache = built.fn(pm, cache, tok)
                out[f"serve{t}_{name}"] = np.asarray(lg)
                tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
                out[f"serve_tok{t}_{name}"] = np.asarray(tok)

# the engine on one device, the same weights, trace and clock
engines = {}
for case, name, over, trace in ENGINES:
    cfg, p = cfgs[name], params[name]
    config = ServeConfig(arch=ARCHS[name][0], **engine_config(over))

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
rank, store, path, params_path = (int(sys.argv[1]), sys.argv[7], sys.argv[8],
                                  sys.argv[9])
from repro_torch.configs import ShapeCell, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.serve import ServeConfig, build_engine, build_serve_step
from repro_torch.launch.steps import make_cache, make_decode_step, make_prefill_step
from repro_torch.models import (RunCtx, decode_step, forward, init_cache,
                                params_from_jax, unembed)
from repro_torch.models.transformer import param_axes, param_shapes

init_distributed("gloo", rank, 4, tdist.FileStore(store, 4), timeout_s=120)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
di = mesh.get_local_rank("data")
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
rows = slice(2 * di, 2 * di + 2)


def tensor(a):
    return None if a is None else torch.from_numpy(a)


for name, cfg in cfgs.items():
    toks, extra, context = (tensor(a) for a in inputs(cfg))
    local = shd.shard_params(params[name], param_axes(cfg), mesh, SERVE)
    h = forward(local, cfg, toks, context=context, ctx=ctx)
    with shd.use_rules(mesh, SERVE):
        out[f"logits_{name}"] = unembed(local, cfg, h)
    # the steps, the batch (and the context) cut over 'data'
    batch = {"tokens": toks}
    if context is not None:
        batch["context"] = context
    built = make_prefill_step(cfg, mesh, ShapeCell("p", "prefill", S, B))
    p_l, b_l = built.local(params[name], batch)
    out[f"pstep_{name}"] = built.fn(p_l, b_l)
    impls = ("dense", "flash") if name in ("jamba", "xlstm") else ("dense",)
    for impl in impls:
        built = make_decode_step(cfg, mesh, ShapeCell("d", "decode", MAX_SEQ, B),
                                 ctx=RunCtx(decode_impl=impl))
        (p_l,) = built.local(params[name])
        c = make_cache(built, cfg, p_l, 2, MAX_SEQ,
                       context=None if context is None else context[rows])
        for t in list(toks.T) + list(extra.T):
            lg, c = built.fn(p_l, c, t[rows, None])
        out[f"dstep_{impl}_{name}"] = lg
        cshard = built.in_shardings[1]
        out[f"cache_{impl}_{name}"] = [
            {k: (v, cshard["layers"][i][k]) for k, v in layer.items()}
            for i, layer in enumerate(c["layers"])]
    if context is not None:
        # build_serve_step at model_parallel=2: every rank the whole batch
        config = ServeConfig(arch=ARCHS[name][0], num_slots=B,
                             prefill_buckets=(8,), max_new_tokens=8,
                             model_parallel=2)
        _, step, p_serve, mk = build_serve_step(
            config, device="cpu", params=params[name], model_config=cfg,
            context=context)
        cache, tok = mk(), toks[:, -1:]
        out[f"serve_xk_{name}"] = next(
            l["xk"].shape[2] for l in cache["layers"] if "xk" in l)
        for t in range(SERVE_STEPS):
            lg, cache = step.fn(p_serve, cache, tok)
            out[f"serve{t}_{name}"] = lg
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            out[f"serve_tok{t}_{name}"] = tok

# xlstm at mesh (1, 4): one head a rank
cfg = cfgs["xlstm"]
mesh14 = make_mesh((1, 4), ("data", "model"), device="cpu")
ctx14 = RunCtx(mesh=mesh14)
toks, extra, _ = (tensor(a) for a in inputs(cfg))
local = shd.shard_params(params["xlstm"], param_axes(cfg), mesh14, SERVE)
out["heads14"] = local["layers"][0]["mix"]["wq"].shape, \
    local["layers"][7]["mix"]["w_h"].shape[0]
h = forward(local, cfg, toks, ctx=ctx14)
with shd.use_rules(mesh14, SERVE):
    out["logits14"] = unembed(local, cfg, h)
c = init_cache(local, cfg, B, MAX_SEQ, ctx=ctx14)
out["cache14"] = {k: tuple(v.shape) for k, v in c["layers"][0].items()}
for t in list(toks.T) + list(extra.T):
    lg, c = decode_step(local, cfg, c, t[:, None], ctx=ctx14)
out["dec14"] = lg

# the packed leaves: shard, then gather in the world, bit for bit
for name in ("xlstm", "jamba"):
    cfg = cfgs[name]
    for m, msh in (("22", mesh), ("14", mesh14)):
        local = shd.shard_params(params[name], param_axes(cfg), msh, SERVE)
        back = shd.gather_params(local, param_axes(cfg), msh, SERVE,
                                 param_shapes(cfg))
        out[f"gather_{name}_{m}"] = all(torch.equal(a, b) for a, b in zip(
            torch.utils._pytree.tree_leaves(back),
            torch.utils._pytree.tree_leaves(params[name])))

# build_engine(model_parallel=2): every rank the same engine and schedule
engines = {}
for case, name, over, trace in ENGINES:
    config = ServeConfig(arch=ARCHS[name][0],
                         **{**engine_config(over), "model_parallel": 2})
    clock = StepClock()
    eng = build_engine(config, device="cpu", params=params[name],
                       model_config=cfgs[name], clock=clock)
    engines[case] = serve(eng, trace, clock)
out["engines"] = engines

# the serve CLI's --model-parallel 2 (this world bound: no world of its own)
# against the CLI on this rank alone, the smoke configs' bf16 weights
from repro_torch.launch.serve import run_cli
argv = ["--device", "cpu", "--requests", "4", "--slots", "2", "--buckets",
        "8,16", "--min-prompt", "4", "--max-prompt", "12", "--gen", "4",
        "--rate", "0", "--temperature", "0"]
for arch in ("deepseek-v2-236b", "xlstm-1.3b"):
    out[f"cli_{arch}"] = [[r.tokens for r in run_cli(
        ["--arch", arch] + argv + extra)["results"]]
        for extra in ([], ["--model-parallel", "2"])]
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
    tmp = tmp_path_factory.mktemp("tp_families")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    shared = [repr(ARCHS), repr(CONFIG), repr(PREFIX_CONFIG), repr(ENGINES),
              repr((B, S, EXTRA, MAX_SEQ, SERVE_STEPS, GATE))]
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
    return {"data": rank // 2, "model": rank % 2}       # row-major


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol,
                               err_msg=what)


# -- the model under RunCtx(mesh=) -------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_matches_jax(results, name):
    """Every rank's logits of the whole batch (the context encoded and
    cross-attended on the rank's heads) against the reference's."""
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        _close(res[f"logits_{name}"], jax_res[f"logits_{name}"], 1e-4,
               f"rank {r}")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_step_matches_the_references_on_the_mesh(results, name):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        d = _coords(r)["data"]
        _close(res[f"pstep_{name}"], jax_res[f"pstep_{name}"][2 * d:2 * d + 2],
               1e-4, f"rank {r}")


DECODES = [(n, "dense") for n in sorted(ARCHS)] + [("jamba", "flash"),
                                                    ("xlstm", "flash")]


@pytest.mark.parametrize("name,impl", DECODES)
def test_decode_step_matches_the_references_on_the_mesh(results, name,
                                                         impl):
    """``make_decode_step`` over the prompt and two more tokens: the last
    logits, and every cache leaf's block against the same block of the
    reference's cache (the flash form holds half the attention rows a
    rank, the recurrent state its channels or heads).  xlstm has no
    attention: its flash form is the dense one's function under the flash
    rules (heads whole, ``d_inner`` cut), held against the reference's
    dense step."""
    from repro_torch.dist import sharding as shd

    jax_res, ranks = results
    mesh = {"data": 2, "model": 2}
    want_impl = impl if f"dec1_{impl}_{name}" in jax_res else "dense"
    for r, res in enumerate(ranks):
        c = _coords(r)
        _close(res[f"dstep_{impl}_{name}"],
               jax_res[f"dec1_{want_impl}_{name}"][
                   2 * c["data"]:2 * c["data"] + 2], 1e-4, f"rank {r}")
        for i, layer in enumerate(res[f"cache_{impl}_{name}"]):
            for leaf, (got, spec) in layer.items():
                want = shd.block_of(torch.from_numpy(
                    jax_res[f"cache_{want_impl}_{name}|{i}|{leaf}"]), spec,
                    mesh, coords=c)
                assert tuple(got.shape) == tuple(want.shape), (i, leaf)
                _close(got, want.numpy(), 1e-4, f"rank {r} layer {i} {leaf}")


def test_the_caches_hold_this_ranks_blocks(results):
    """What the decode caches above hold a rank (model 2, batch 2 a rank):
    MLA's latent rows whole, Mamba's channels, mLSTM's and sLSTM's heads,
    the context's KV heads, the flash form's half of the rows."""
    _, ranks = results
    for res in ranks:
        ds = res["cache_dense_deepseek"][0]
        assert tuple(ds["lat_c"][0].shape) == (2, 16, 16)
        xl = res["cache_dense_xlstm"]
        assert tuple(xl[0]["ml_C"][0].shape) == (2, 2, 32, 32)
        assert tuple(xl[7]["sl_h"][0].shape) == (2, 2, 16)
        jm = res["cache_dense_jamba"]
        assert tuple(jm[0]["ssm_h"][0].shape) == (2, 64, 8)
        assert tuple(jm[0]["ssm_conv"][0].shape) == (2, 3, 64)
        assert tuple(jm[4]["k"][0].shape) == (2, 16, 1, 16)
        assert tuple(res["cache_flash_jamba"][4]["k"][0].shape) == \
            (2, 8, 2, 16)
        assert tuple(res["cache_dense_whisper"][0]["xk"][0].shape) == \
            (2, 24, 2, 16)
        assert tuple(res["cache_dense_vision"][4]["xk"][0].shape) == \
            (2, 12, 1, 16)


# -- build_serve_step and build_engine at model_parallel=2 ---------------------

@pytest.mark.parametrize("name", ["whisper", "vision"])
def test_serve_step_model_parallel_matches_jax(results, name):
    """``build_serve_step(model_parallel=2)``'s greedy steps over the same
    context: tokens equal, logits at 1e-4, the cache's xk holding the
    rank's KV heads."""
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        assert res[f"serve_xk_{name}"] == {"whisper": 2, "vision": 1}[name]
        for t in range(SERVE_STEPS):
            np.testing.assert_array_equal(_np(res[f"serve_tok{t}_{name}"]),
                                          jax_res[f"serve_tok{t}_{name}"])
            _close(res[f"serve{t}_{name}"], jax_res[f"serve{t}_{name}"],
                   1e-4, f"rank {r} step {t}")


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
    if case.startswith("deepseek"):
        assert want["hits"] >= 3


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "xlstm-1.3b"])
def test_cli_model_parallel_serves_the_one_rank_tokens(results, arch):
    """The serve CLI's ``--model-parallel 2`` on the MLA and the recurrent
    smoke models (bf16, the CLI's seeded weights) against the CLI on one
    rank: the same tokens for every request."""
    _, ranks = results
    for res in ranks:
        one, two = res[f"cli_{arch}"]
        assert len(one) == 4 and two == one


# -- mesh (1, 4) and the packed leaves -----------------------------------------

def test_xlstm_at_one_head_a_rank_matches_jax(results):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        wq, heads = res["heads14"]
        assert tuple(wq) == (32, 4, 32) and heads == 1
        assert res["cache14"] == {"ml_C": (B, 1, 32, 32), "ml_n": (B, 1, 32)}
        _close(res["logits14"], jax_res["logits_xlstm"], 1e-4, f"rank {r}")
        _close(res["dec14"], jax_res["dec1_dense_xlstm"], 1e-4, f"rank {r}")


@pytest.mark.parametrize("name", ["xlstm", "jamba"])
@pytest.mark.parametrize("mesh", ["22", "14"])
def test_gather_inverts_shard_with_packed_leaves(results, name, mesh):
    _, ranks = results
    for res in ranks:
        assert res[f"gather_{name}_{mesh}"]


def test_world_memory(results):
    _, ranks = results
    total_gib = sum(res["maxrss_kb"] for res in ranks) / 2 ** 20
    print(f"the 4 ranks' summed peak RSS: {total_gib:.2f} GiB")
    assert total_gib < 6.0, total_gib


# -- in one process: the packed layout, the cache blocks, the refusals ---------

def _ranks(mesh):
    import itertools
    names = list(mesh)
    for idx in itertools.product(*(range(mesh[n]) for n in names)):
        yield dict(zip(names, idx))


@pytest.mark.parametrize("arch,block,packed,per_channel", [
    ("jamba-v0.1-52b", "mamba", "w_in", ("conv_w", "A_log", "D_skip")),
    ("xlstm-1.3b", "mlstm", "w_up", ("ln_g",))])
@pytest.mark.parametrize("mesh", [{"data": 2, "model": 2}, {"model": 4}])
def test_packed_leaves_are_cut_by_their_halves(arch, block, packed,
                                               per_channel, mesh):
    """A rank's x and z columns of ``w_in`` / ``w_up`` are those of the
    channels its per-channel leaves hold; shard then gather (simulated
    rank by rank) gives the leaves back bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_axes, param_shapes

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    axes = param_axes(cfg)
    i = next(j for j in range(cfg.num_layers) if cfg.block_type(j) == block)
    whole = params["layers"][i]["mix"]
    DI = whole[packed].shape[1] // 2
    P = mesh["model"]
    blocks = []
    for c in _ranks(mesh):
        local = shd.shard_params(params, axes, mesh, shd.SERVE_RULES,
                                 coords=c)
        blocks.append(local)
        mix = local["layers"][i]["mix"]
        n, d0 = DI // P, c["model"] * (DI // P)
        assert torch.equal(mix[packed][:, :n], whole[packed][:, d0:d0 + n])
        assert torch.equal(mix[packed][:, n:],
                           whole[packed][:, DI + d0:DI + d0 + n])
        for leaf in per_channel:
            dim = 1 if leaf == "conv_w" else 0
            assert torch.equal(mix[leaf], whole[leaf].narrow(dim, d0, n))
    back = shd.gather_params(blocks, axes, mesh, shd.SERVE_RULES,
                             param_shapes(cfg))
    for a, b in zip(torch.utils._pytree.tree_leaves(back),
                    torch.utils._pytree.tree_leaves(params)):
        assert torch.equal(a, b)


def test_slstm_w_x_cut_contiguously_is_cut_by_heads():
    """sLSTM's ``w_x`` (D, 4 D) is head-major (``xg`` reshapes to (B, H,
    4 hd)): its contiguous block is the rank's heads' gate columns, which
    line up with its ``w_h`` / ``b`` block and its ``sl_h`` state, and its
    spec stays the reference's (no packing)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_axes

    cfg = dataclasses.replace(get_config("xlstm-1.3b", smoke=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    mesh = {"model": 2}
    whole = params["layers"][7]["mix"]
    assert shd.parts_of(shd.spec_for(param_axes(cfg)["layers"][7]["mix"][
        "w_x"], shd.SERVE_RULES, mesh, shape=(D, 4 * D))[1]) == 1
    for c in _ranks(mesh):
        mix = shd.shard_params(params, param_axes(cfg), mesh,
                               shd.SERVE_RULES, coords=c)["layers"][7]["mix"]
        h0 = c["model"] * (H // 2)
        heads = whole["w_x"].reshape(D, H, 4 * hd)[:, h0:h0 + H // 2]
        assert torch.equal(mix["w_x"], heads.reshape(D, -1))
        assert torch.equal(mix["w_h"], whole["w_h"][h0:h0 + H // 2])
        assert torch.equal(mix["b"], whole["b"].reshape(H, 4 * hd)[
            h0:h0 + H // 2].reshape(-1))
        with shd.use_rules(mesh, shd.SERVE_RULES):
            from repro_torch.models import ssm
            assert tuple(ssm.init_slstm_cache(cfg, 3, "cpu")["sl_h"].shape) \
                == (3, H // 2, hd)


FAMILIES = ["deepseek-v2-236b", "xlstm-1.3b", "jamba-v0.1-52b",
            "whisper-small", "llama-3.2-vision-90b"]


def _reference_train_specs(arch, mesh):
    """The JAX package's spec of every parameter leaf of ``arch``'s smoke
    config under ``TRAIN_RULES`` on a ``{axis: size}`` mesh (its
    ``spec_for`` reads only the mesh's shape), in the port's per-layer
    layout: a stacked leaf's spec without its leading ``layers`` entry."""
    import types

    import repro  # noqa: F401  (the JAX package's compat shims first)
    from repro.configs import get_config as jax_get_config
    from repro.dist import sharding as jshd
    from repro.models import param_axes as jax_param_axes
    from repro.models import param_shapes as jax_param_shapes
    from repro_torch.configs import get_config
    from repro_torch.models.convert import _plan

    jm = types.SimpleNamespace(shape=dict(mesh))
    rules = jshd.trim_rules(jshd.TRAIN_RULES, jm)
    jcfg = jax_get_config(arch, smoke=True)

    def specs(axes, shapes, stacked=False):
        if isinstance(axes, dict):
            return {k: specs(axes[k], shapes[k], stacked) for k in axes}
        sp = tuple(jshd.spec_for(tuple(axes), rules, jm,
                                 shape=tuple(shapes.shape)))
        return (sp[1:] if sp else ()) if stacked else sp

    axes, shapes = jax_param_axes(jcfg), jax_param_shapes(jcfg)
    ref = {k: specs(axes[k], shapes[k], k == "layers") for k in axes}
    pre, period, n_periods, n_rem = _plan(get_config(arch, smoke=True))
    out = {k: v for k, v in ref.items() if k not in ("layers", "encoder")
           and not k.startswith(("prelude_", "rem_"))}
    out["layers"] = ([ref[f"prelude_{i}"] for i in range(pre)] +
                     [ref["layers"][f"slot_{j}"] for _ in range(n_periods)
                      for j in range(period)] +
                     [ref[f"rem_{i}"] for i in range(n_rem)])
    if "encoder" in ref:
        enc = ref["encoder"]
        out["encoder"] = {"layers": [enc[f"layer_{i}"] for i in
                                     range(len(enc) - 1)],
                          "final_norm": enc["final_norm"]}
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_training_builds_for_the_families(arch):
    """``make_train_step(mesh=)`` builds the step for MLA, the recurrent and
    the context families (it refused them before): the parameters' and
    the optimizer state's specs are the JAX package's ``make_train_step``
    ``in_shardings`` (``TRAIN_RULES`` on mesh (2, 2)), the batch is cut
    over 'data', a context arch's context with it.  The step itself is
    held against the reference's on 4 ranks in
    ``tests/test_torch_tp_train_families.py``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import BuiltStep, make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    mesh = {"data": 2, "model": 2}
    built = make_train_step(cfg, mesh)
    assert isinstance(built, BuiltStep)
    pshard, oshard, bshard = built.in_shardings
    assert pshard == _reference_train_specs(arch, mesh)
    assert all(oshard[k] == pshard for k in ("m", "v", "master"))
    want = {"tokens", "labels"} | ({"context"} if cfg.family in
                                   ("audio", "vlm") else set())
    assert set(bshard) == want
    assert all(spec == ("data",) for spec in bshard.values())
    assert built.ctx.batch_axes == ("data",)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_scope_serves_the_families(arch):
    """``_mesh_scope`` opens for every family (it refused these three
    before): its rules are SERVE_RULES, and ``init_cache`` under them
    builds this rank's blocks."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import RunCtx, init_params
    from repro_torch.models.transformer import _mesh_scope

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    mesh = {"data": 1, "model": 2}
    with _mesh_scope(cfg, RunCtx(mesh=mesh)):
        _, rules = shd.current_rules()
        assert rules["heads"] == "model" and rules["d_inner"] == "model"
        if arch == "xlstm-1.3b":
            from repro_torch.models.transformer import _init_cache
            params = init_params(cfg, torch.Generator(), device="meta")
            cache = _init_cache(params, cfg, 3, 16, None, True)
            assert tuple(cache["layers"][0]["ml_C"].shape) == (3, 2, 32, 32)
    assert shd.current_rules() is None
