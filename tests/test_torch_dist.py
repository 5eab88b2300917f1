"""The mesh tier of the port against the JAX package's, on 8 ranks.

Twins of ``tests/test_distributed.py``'s monoid-shuffle tests (the sharded
MapReduce strategies and the plan's shuffle at 16 and 13 keys,
``combine_keyed_table`` with both algorithms, hierarchical == flat psum,
the ``attn_state`` allreduce, the mesh tier of ``execute_fold``
hierarchical and ragged, the DCN axis crossed once on (pod, data, model),
async == sync == auto, the lossy error-feedback invariant), plus every
function of ``dist/collectives.py`` and of ``core/aggregation.py``'s mesh
half per monoid family, ``sync_stats`` and ``session_fold(mesh_axes=)``.

The JAX side runs every case in ONE subprocess on 8 fake XLA devices, as
``run_distributed`` does; the port runs every case in ONE 8-rank gloo
world on the CPU, one process per rank (``FileStore`` rendezvous under the
test's temporary directory, one torch thread per rank).  Both build their
inputs from the same numpy seeds; each rank's results are checked here,
one test per check.  Integer and sketch results match bit for bit, floats
at the reference test's own tolerance.  The worlds have a join timeout, so
a hung rank fails the tests instead of waiting into the suite's limit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
TIMEOUT_S = 240

# ---------------------------------------------------------------------------
# the JAX package, 8 fake devices, one subprocess
# ---------------------------------------------------------------------------

JAX_CODE = r'''
import sys
import repro  # noqa: F401  (installs the jax API compat shims first)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
assert len(jax.devices()) == 8, jax.devices()
from repro.core import MapReduceJob, average_by_key_job, execute_fold, monoids
from repro.core.aggregation import (hierarchical_psum, monoid_allreduce,
                                    monoid_hierarchical_allreduce,
                                    monoid_reduce_scatter)
from repro.dist import collectives as col
from repro.optim.compress import LossySpec
from repro.data.stats import make_stream_stats, init_stats, update_stats, sync_stats
from repro.data.windows import sessionize, session_fold

def mk(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))

def smap(fn, mesh, in_specs, out_specs=P()):
    # jitted: an eager shard_map dispatches op by op on 8 devices
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))

def sharded(job, records, **kw):
    return np.asarray(jax.jit(lambda r: job.run_sharded(r, **kw))(records))

mesh = mk((8,), ("data",))
mesh2 = mk((4, 2), ("data", "model"))
mesh_pod = mk((4, 2), ("data", "pod"))
mesh3 = mk((2, 2, 2), ("pod", "data", "model"))
mesh_ov = mk((2, 4), ("pod", "x"))
out = {}
tree = jax.tree_util.tree_map

# sharded MapReduce strategies
rng = np.random.default_rng(0)
keys = rng.integers(0, 16, 128); vals = rng.normal(size=128).astype(np.float32)
records = {"key": jnp.asarray(keys), "value": jnp.asarray(vals)}
job = average_by_key_job(16)
maxjob = MapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                      monoid=monoids.max_, num_keys=16)
for s in ("naive", "combiner", "in_mapper"):
    out[f"mr_{s}"] = sharded(job, records, mesh=mesh, strategy=s)
    out[f"mrmax_{s}"] = sharded(maxjob, records, mesh=mesh, strategy=s)

# the plan's shuffle at 16 and 13 keys
rng = np.random.default_rng(4)
for nk in (16, 13):
    keys = rng.integers(0, nk, 128); vals = rng.normal(size=128).astype(np.float32)
    records = {"key": jnp.asarray(keys), "value": jnp.asarray(vals)}
    job = average_by_key_job(nk)
    plan = job.plan(records, strategy="combiner", num_shards=8, axis_name="data")
    out[f"ps{nk}_algo"] = np.array(plan.shuffle_algorithm)
    out[f"ps{nk}_pred"] = np.array(
        job.stats(records, strategy="combiner", num_shards=8).predicted_us)
    for s in ("combiner", "in_mapper"):
        out[f"ps{nk}_{s}"] = sharded(job, records, mesh=mesh, strategy=s)

# combine_keyed_table, both algorithms, additive and generic
rng = np.random.default_rng(5)
tables = {"sum": rng.normal(size=(8, 16, 3)).astype(np.float32),
          "isum": rng.integers(-50, 50, (8, 16, 3)).astype(np.int32),
          "max": rng.normal(size=(8, 16, 3)).astype(np.float32)}
for algo in ("allreduce", "reduce_scatter"):
    for name, t in tables.items():
        m = monoids.max_ if name == "max" else monoids.sum_
        fn = smap(lambda t, m=m, algo=algo: col.combine_keyed_table(
            m, t[0], "data", algorithm=algo), mesh, (P("data"),))
        out[f"ckt_{name}_{algo}"] = np.asarray(fn(jnp.asarray(t)))
# monoid_reduce_scatter (out_specs P("data"): the shards concatenated)
for name in ("isum", "max"):
    m = monoids.max_ if name == "max" else monoids.sum_
    fn = smap(lambda t, m=m: monoid_reduce_scatter(m, t[0], "data"), mesh,
              (P("data"),), P("data"))
    out[f"mrs_{name}"] = np.asarray(fn(jnp.asarray(tables[name])))

# hierarchical psum == flat
x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
f1 = smap(lambda v: jax.lax.psum(v, ("data", "model")), mesh2, P("data"), P("data"))
f2 = smap(lambda v: hierarchical_psum(v, ici_axis="model", dcn_axis="data"),
          mesh2, P("data"), P("data"))
out["hp_flat"] = np.asarray(f1(x)); out["hp_hier"] = np.asarray(f2(x))
xo = jnp.arange(12, dtype=jnp.float32).reshape(4, 3)   # 3 per rank: padded
out["hp_pad"] = np.asarray(f2(xo))

# the attn_state and logsumexp allreduce
rng = np.random.default_rng(1)
S, d = 64, 4
logits = jnp.asarray(rng.normal(size=(S,)).astype(np.float32))
v = jnp.asarray(rng.normal(size=(S, d)).astype(np.float32))
def attn_fn(lg, vv):
    m = jnp.max(lg); e = jnp.exp(lg - m)
    st = monoid_allreduce(monoids.attn_state, (m, e.sum(), e @ vv), "data")
    return monoids.attn_state.extract(st)
out["attn"] = np.asarray(smap(attn_fn, mesh, (P("data"), P("data")))(logits, v))
out["attn_want"] = np.asarray(jax.nn.softmax(logits) @ v)
def lse_fn(lg):
    m = jnp.max(lg)
    st = monoid_allreduce(monoids.logsumexp, (m, jnp.exp(lg - m).sum()), "data")
    return monoids.logsumexp.extract(st)
out["lse"] = np.asarray(smap(lse_fn, mesh, (P("data"),))(logits))

# monoid_allreduce per family
rng = np.random.default_rng(51)
fam = {"sum": (monoids.sum_, rng.normal(size=(8, 5)).astype(np.float32)),
       "max": (monoids.max_, rng.normal(size=(8, 5)).astype(np.float32)),
       "min": (monoids.min_, rng.normal(size=(8, 5)).astype(np.float32)),
       "or": (monoids.bitwise_or, rng.integers(0, 2, (8, 6)).astype(np.uint8)),
       "hll": (monoids.hyperloglog(4), rng.integers(0, 12, (8, 16)).astype(np.uint8)),
       "cms": (monoids.count_min(2, 8), rng.integers(0, 99, (8, 2, 8)).astype(np.int32)),
       "mean": (monoids.mean, (rng.normal(size=(8, 3)).astype(np.float32),
                               rng.integers(1, 5, 8).astype(np.int32))),
       "affine": (monoids.affine_scan, (rng.uniform(0.5, 1.5, (8, 3)).astype(np.float32),
                                        rng.normal(size=(8, 3)).astype(np.float32)))}
for name, (m, xs) in fam.items():
    fn = smap(lambda x, m=m: monoid_allreduce(m, tree(lambda t: t[0], x), "data"),
              mesh, (P("data"),))
    out[f"fam_{name}"] = tree(np.asarray, fn(tree(jnp.asarray, xs)))
m, xs = fam["affine"]
fn = smap(lambda x: monoid_hierarchical_allreduce(
    monoids.affine_scan, tree(lambda t: t[0], x), ("data", "model")),
    mesh2, (P(("data", "model")),))
out["fam_affine2"] = tree(np.asarray, fn(tree(jnp.asarray, xs)))

# the mesh tier of execute_fold: hierarchical, ragged
for seed, ragged in ((5, False), (11, True)):
    rng = np.random.default_rng(seed)
    n, nk = 128, 8
    vals = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    segs = jnp.asarray(rng.integers(0, nk, n).astype(np.int32))
    mask = jnp.asarray(rng.random(n) < 0.6) if ragged else jnp.ones(n, bool)
    def body(v, k, mk):
        return execute_fold(monoids.sum_, v, segment_ids=k, num_segments=nk,
                            valid_mask=mk if ragged else None,
                            mesh_axes=("pod", "data"))
    spec = P(("data", "pod"))
    out[f"efm_{seed}"] = np.asarray(smap(body, mesh_pod, (spec, spec, spec))(
        vals, segs, mask))

# the DCN axis crossed once on (pod, data, model)
x = jnp.arange(32, dtype=jnp.float32).reshape(8, 4)
kw = dict(mesh=mesh3, in_specs=P("data"), out_specs=P("data"))
out["dcn_flat"] = np.asarray(smap(
    lambda v: jax.lax.psum(v, ("pod", "data", "model")), **kw)(x))
out["dcn_grad"] = np.asarray(smap(lambda v: col.grad_sync(v, mesh3), **kw)(x))
out["dcn_metrics"] = np.asarray(smap(lambda v: col.metrics_sync(v, mesh3), **kw)(x))
out["dcn_max"] = np.asarray(smap(
    lambda v: col.cross_mesh_allreduce(monoids.max_, v, mesh3), **kw)(x))
out["dcn_flatmax"] = np.asarray(smap(
    lambda v: jax.lax.pmax(v, ("pod", "data", "model")), **kw)(x))
out["dcn_grad_odd"] = np.asarray(smap(lambda v: col.grad_sync(v, mesh3), **kw)(
    jnp.arange(6, dtype=jnp.float32).reshape(2, 3)))
out["dcn_axes"] = np.array(",".join(col.dcn_axes(mesh3)))
out["ici_axes"] = np.array(",".join(col.ici_axes(mesh3)))

# async == sync == auto; the lossy EF invariant; the direct collectives
spec = P(("pod", "x"))
for seed in (21, 22):
    rng = np.random.default_rng(seed)
    data = jnp.asarray(rng.normal(size=(8, 4, 16)).astype(np.float32))
    out[f"ov_want_{seed}"] = np.asarray(data).sum((0, 1))
    if seed == 21:
        for layout in ("scan", "async", "auto"):
            body = lambda v, layout=layout: execute_fold(
                monoids.sum_, v[0], mesh_axes=("x", "pod"), layout=layout)
            out[f"async_{layout}"] = np.asarray(smap(body, mesh_ov, (spec,))(data))
        body = lambda v: col.async_microbatch_fold(
            monoids.sum_, v[0], ("x", "pod"), map_fn=lambda r: r * 2.0)[0]
        out["amf_map"] = np.asarray(smap(body, mesh_ov, (spec,))(data))
        continue
    for layout in ("scan", "async"):
        for lossy in ("topk:0.25", "int8"):
            def body(v, layout=layout, lossy=lossy):
                o, ef = execute_fold(monoids.sum_, v[0], mesh_axes=("x", "pod"),
                                     layout=layout, lossy=lossy)
                return o + jax.lax.psum(ef, "pod")
            out[f"lossy_{layout}_{lossy}"] = np.asarray(smap(body, mesh_ov, (spec,))(data))
    for lossy in ("topk:0.25", "int8"):
        def body(v, lossy=lossy):
            g = v[0].sum(0)
            o, ef = col.lossy_cross_axes(LossySpec.parse(lossy), g, ("x", "pod"),
                                         ef=jnp.zeros_like(g))
            return o + jax.lax.psum(ef, "pod")
        out[f"lca_{lossy}"] = np.asarray(smap(body, mesh_ov, (spec,))(data))

# sync_stats over one and two axes
m = make_stream_stats(cms_depth=2, cms_width=64, hll_precision=4, bloom_bits=256)
rng = np.random.default_rng(31)
toks = rng.integers(0, 1000, (8, 3, 32)).astype(np.int32)
mask = rng.random((8, 3, 32)) < 0.8
states = [update_stats(init_stats(m), jnp.asarray(toks[r]), jnp.asarray(mask[r]))
          for r in range(8)]
stacked = tree(lambda *xs: jnp.stack(xs), *states)
for tag, mm, axes, sp in (("1", mesh, ("data",), P("data")),
                          ("2", mesh_pod, ("data", "pod"), P(("data", "pod")))):
    fn = smap(lambda s, axes=axes: sync_stats(m, tree(lambda v: v[0], s), axes),
              mm, (sp,))
    for k, val in fn(stacked).items():
        out[f"stats{tag}_{k}"] = np.asarray(val)

# session_fold(mesh_axes=)
rng = np.random.default_rng(41)
n = 128
users = rng.integers(0, 12, n); ts = np.sort(rng.uniform(0, 100, n))
sids, ns = sessionize(users, ts, gap=5.0)
vals = rng.integers(0, 100, n).astype(np.int32)
for name, m in (("sum", monoids.sum_), ("max", monoids.max_)):
    fn = smap(lambda v, s, m=m: session_fold(m, v, s, ns, mesh_axes=("data",)),
              mesh, (P("data"), P("data")))
    out[f"sess_{name}"] = np.asarray(fn(jnp.asarray(vals), jnp.asarray(sids)))

flat = {}
for k, val in out.items():
    for i, leaf in enumerate(jax.tree_util.tree_leaves(val)):
        flat[f"{k}#{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **flat)
print("ok")
'''

# ---------------------------------------------------------------------------
# the port, one process per rank of an 8-rank gloo world
# ---------------------------------------------------------------------------

RANK_CODE = r'''
import sys
import numpy as np
import torch
import torch.distributed as tdist
import torch.utils._pytree as pytree
torch.set_num_threads(1)
rank, world, store, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from repro_torch import dist
from repro_torch.core import MapReduceJob, average_by_key_job, execute_fold, monoids
from repro_torch.core.aggregation import (hierarchical_psum, monoid_allreduce,
                                          monoid_hierarchical_allreduce,
                                          monoid_reduce_scatter)
from repro_torch.core.calibration import default_calibration, use_calibration
from repro_torch.dist import collectives as col
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.optim.compress import LossySpec
from repro_torch.data.stats import make_stream_stats, init_stats, update_stats, sync_stats
from repro_torch.data.windows import sessionize, session_fold

init_distributed("gloo", rank, world, tdist.FileStore(store, world), timeout_s=120)
mk = lambda shape, names: make_mesh(shape, names, device="cpu")
mesh = mk((8,), ("data",))
mesh2 = mk((4, 2), ("data", "model"))
mesh_pod = mk((4, 2), ("data", "pod"))
mesh3 = mk((2, 2, 2), ("pod", "data", "model"))
mesh_ov = mk((2, 4), ("pod", "x"))
out = {}
tree = pytree.tree_map
T = lambda x: tree(torch.from_numpy, x)
calib = use_calibration(default_calibration()); calib.__enter__()

# sharded MapReduce strategies
rng = np.random.default_rng(0)
keys = rng.integers(0, 16, 128); vals = rng.normal(size=128).astype(np.float32)
records = T({"key": keys, "value": vals})
job = average_by_key_job(16)
maxjob = MapReduceJob(mapper=lambda r: (r["key"], r["value"]),
                      monoid=monoids.max_, num_keys=16)
for s in ("naive", "combiner", "in_mapper"):
    out[f"mr_{s}"] = job.run_sharded(records, mesh, strategy=s)
    out[f"mrmax_{s}"] = maxjob.run_sharded(records, mesh, strategy=s)
out["mr_local"] = job.run_local(records, num_shards=8)
out["mrmax_local"] = maxjob.run_local(records, strategy="combiner", num_shards=8)

# the plan's shuffle at 16 and 13 keys
rng = np.random.default_rng(4)
for nk in (16, 13):
    keys = rng.integers(0, nk, 128); vals = rng.normal(size=128).astype(np.float32)
    records = T({"key": keys, "value": vals})
    job = average_by_key_job(nk)
    plan = job.plan(records, strategy="combiner", num_shards=8, axis_name="data")
    out[f"ps{nk}_algo"] = plan.shuffle_algorithm
    out[f"ps{nk}_pred"] = job.stats(records, strategy="combiner", num_shards=8).predicted_us
    for s in ("combiner", "in_mapper"):
        dist.reset_counts()
        out[f"ps{nk}_{s}"] = job.run_sharded(records, mesh, strategy=s)
        out[f"ps{nk}_{s}_counts"] = dist.counts()
        out[f"ps{nk}_{s}_plan_wire"] = plan.collective_wire_bytes
    out[f"ps{nk}_oracle"] = np.array(
        [vals[keys == k].mean() if (keys == k).any() else 0.0 for k in range(nk)])

# combine_keyed_table, both algorithms, additive and generic
rng = np.random.default_rng(5)
tables = {"sum": rng.normal(size=(8, 16, 3)).astype(np.float32),
          "isum": rng.integers(-50, 50, (8, 16, 3)).astype(np.int32),
          "max": rng.normal(size=(8, 16, 3)).astype(np.float32)}
with dist.use_mesh(mesh):
    for algo in ("allreduce", "reduce_scatter"):
        for name, t in tables.items():
            m = monoids.max_ if name == "max" else monoids.sum_
            mine = torch.from_numpy(t[rank])
            out[f"ckt_{name}_{algo}"] = col.combine_keyed_table(m, mine, "data", algorithm=algo)
            assert torch.equal(mine, torch.from_numpy(t[rank]))   # inputs untouched
    for name in ("isum", "max"):
        m = monoids.max_ if name == "max" else monoids.sum_
        out[f"mrs_{name}"] = monoid_reduce_scatter(m, torch.from_numpy(tables[name][rank]), "data")

# hierarchical psum == flat
x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
with dist.use_mesh(mesh2):
    blk = dist.local_block(x, mesh2, "data")
    out["hp_flat"] = dist.psum(blk, ("data", "model"))
    out["hp_hier"] = hierarchical_psum(blk, ici_axis="model", dcn_axis="data")
    xo = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out["hp_pad"] = hierarchical_psum(dist.local_block(xo, mesh2, "data"),
                                      ici_axis="model", dcn_axis="data")
    out["hp_coord"] = dist.axis_index("data")

# the attn_state and logsumexp allreduce
rng = np.random.default_rng(1)
S, d = 64, 4
logits = torch.from_numpy(rng.normal(size=(S,)).astype(np.float32))
v = torch.from_numpy(rng.normal(size=(S, d)).astype(np.float32))
with dist.use_mesh(mesh):
    lg, vv = dist.local_block((logits, v), mesh, "data")
    m = lg.max(); e = torch.exp(lg - m)
    st = monoid_allreduce(monoids.attn_state, (m, e.sum(), e @ vv), "data")
    out["attn"] = monoids.attn_state.extract(st)
    st = monoid_allreduce(monoids.logsumexp, (m, e.sum()), "data")
    out["lse"] = monoids.logsumexp.extract(st)

# monoid_allreduce per family
rng = np.random.default_rng(51)
fam = {"sum": (monoids.sum_, rng.normal(size=(8, 5)).astype(np.float32)),
       "max": (monoids.max_, rng.normal(size=(8, 5)).astype(np.float32)),
       "min": (monoids.min_, rng.normal(size=(8, 5)).astype(np.float32)),
       "or": (monoids.bitwise_or, rng.integers(0, 2, (8, 6)).astype(np.uint8)),
       "hll": (monoids.hyperloglog(4), rng.integers(0, 12, (8, 16)).astype(np.uint8)),
       "cms": (monoids.count_min(2, 8), rng.integers(0, 99, (8, 2, 8)).astype(np.int32)),
       "mean": (monoids.mean, (rng.normal(size=(8, 3)).astype(np.float32),
                               rng.integers(1, 5, 8).astype(np.int32))),
       "affine": (monoids.affine_scan, (rng.uniform(0.5, 1.5, (8, 3)).astype(np.float32),
                                        rng.normal(size=(8, 3)).astype(np.float32)))}
with dist.use_mesh(mesh):
    for name, (m, xs) in fam.items():
        dist.reset_counts()
        out[f"fam_{name}"] = monoid_allreduce(m, tree(lambda t: torch.as_tensor(t[rank]), xs), "data")
        out[f"fam_{name}_counts"] = dist.counts()
    # bool bitmaps cross as uint8 (OR == max)
    out["fam_or_bool"] = monoid_allreduce(
        monoids.bitwise_or, torch.from_numpy(fam["or"][1][rank]).to(torch.bool), "data")
m, xs = fam["affine"]
with dist.use_mesh(mesh2):
    out["fam_affine2"] = monoid_hierarchical_allreduce(
        monoids.affine_scan, tree(lambda t: torch.as_tensor(t[rank]), xs), ("data", "model"))

# the mesh tier of execute_fold: hierarchical, ragged
for seed, ragged in ((5, False), (11, True)):
    rng = np.random.default_rng(seed)
    n, nk = 128, 8
    vals = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    segs = torch.from_numpy(rng.integers(0, nk, n).astype(np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.6) if ragged else None
    v, k = dist.local_block((vals, segs), mesh_pod, ("data", "pod"))
    mk_ = None if mask is None else dist.local_block(mask, mesh_pod, ("data", "pod"))
    with dist.use_mesh(mesh_pod):
        out[f"efm_{seed}"] = execute_fold(monoids.sum_, v, segment_ids=k, num_segments=nk,
                                          valid_mask=mk_, mesh_axes=("pod", "data"))
    # with mesh= the planner knows the sizes: reduce-scatter on both axes
    dist.reset_counts()
    got, plan = execute_fold(monoids.sum_, v, segment_ids=k, num_segments=nk,
                             valid_mask=mk_, mesh_axes=("pod", "data"), mesh=mesh_pod,
                             with_plan=True)
    out[f"efm_{seed}_mesh"] = got
    out[f"efm_{seed}_mesh_tiers"] = [t.kind for t in plan.tiers]
    out[f"efm_{seed}_mesh_counts"] = dist.counts()
    out[f"efm_{seed}_mesh_wire"] = plan.collective_wire_bytes

# the DCN axis crossed once on (pod, data, model)
x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
blk = dist.local_block(x, mesh3, "data")
out["dcn_coord"] = (mesh3.get_local_rank("pod"), mesh3.get_local_rank("data"),
                    mesh3.get_local_rank("model"))
with dist.use_mesh(mesh3):
    out["dcn_flat"] = dist.psum(blk, ("pod", "data", "model"))
    out["dcn_flatmax"] = dist.pmax(blk, ("pod", "data", "model"))
for name, fn in (("grad", lambda b: col.grad_sync(b, mesh3)),
                 ("metrics", lambda b: col.metrics_sync(b, mesh3)),
                 ("max", lambda b: col.cross_mesh_allreduce(monoids.max_, b, mesh3))):
    dist.reset_counts()
    out[f"dcn_{name}"] = fn(blk)
    out[f"dcn_{name}_counts"] = dist.counts()
out["dcn_grad_odd"] = col.grad_sync(
    dist.local_block(torch.arange(6, dtype=torch.float32).reshape(2, 3), mesh3, "data"),
    mesh3)
out["dcn_axes"] = ",".join(col.dcn_axes(mesh3))
out["ici_axes"] = ",".join(col.ici_axes(mesh3))
with dist.use_mesh(mesh3):
    out["cross_axes_max"] = col.cross_axes_allreduce(monoids.max_, blk, ("pod", "data", "model"))

# async == sync == auto; the lossy EF invariant; the direct collectives
for seed in (21, 22):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.normal(size=(8, 4, 16)).astype(np.float32))
    mine = dist.local_block(data, mesh_ov, ("pod", "x"))[0]
    if seed == 21:
        for layout in ("scan", "async", "auto"):
            with dist.use_mesh(mesh_ov):
                out[f"async_{layout}"] = execute_fold(monoids.sum_, mine, mesh_axes=("x", "pod"),
                                                      layout=layout)
            dist.reset_counts()
            got, plan = execute_fold(monoids.sum_, mine, mesh_axes=("x", "pod"),
                                     layout=layout, mesh=mesh_ov, with_plan=True)
            out[f"async_{layout}_mesh"] = got
            out[f"async_{layout}_mesh_plan"] = (plan.local_tier.kind, plan.dense_wire_bytes,
                                                plan.lossy_wire_bytes)
            out[f"async_{layout}_mesh_counts"] = dist.counts()
        with dist.use_mesh(mesh_ov):
            out["amf_map"] = col.async_microbatch_fold(
                monoids.sum_, mine, ("x", "pod"), map_fn=lambda r: r * 2.0)[0]
            out["amf_serial"] = col.async_microbatch_fold(
                monoids.sum_, mine, ("x", "pod"), map_fn=lambda r: r * 2.0, overlap=False)[0]
        continue
    for layout in ("scan", "async"):
        for lossy in ("topk:0.25", "int8"):
            dist.reset_counts()
            (o, ef), plan = execute_fold(monoids.sum_, mine, mesh_axes=("x", "pod"),
                                         layout=layout, lossy=lossy, mesh=mesh_ov,
                                         with_plan=True)
            counts = dist.counts()
            with dist.use_mesh(mesh_ov):
                out[f"lossy_{layout}_{lossy}"] = o + dist.psum(ef, "pod")
            out[f"lossy_{layout}_{lossy}_wire"] = (counts["pod"]["wire_bytes"],
                                                   plan.lossy_wire_bytes, plan.dense_wire_bytes)
    for lossy in ("topk:0.25", "int8"):
        g = mine.sum(0)
        with dist.use_mesh(mesh_ov):
            o, ef = col.lossy_cross_axes(LossySpec.parse(lossy), g, ("x", "pod"),
                                         ef=torch.zeros_like(g))
            out[f"lca_{lossy}"] = o + dist.psum(ef, "pod")

# sync_stats over one and two axes
m = make_stream_stats(cms_depth=2, cms_width=64, hll_precision=4, bloom_bits=256)
rng = np.random.default_rng(31)
toks = rng.integers(0, 1000, (8, 3, 32)).astype(np.int32)
mask = rng.random((8, 3, 32)) < 0.8
for tag, mm, axes, sp in (("1", mesh, ("data",), "data"),
                          ("2", mesh_pod, ("data", "pod"), ("data", "pod"))):
    r = dist.local_block(torch.arange(8), mm, sp).item()
    state = update_stats(init_stats(m, device="cpu"), torch.from_numpy(toks[r]),
                         torch.from_numpy(mask[r]))
    for k, val in sync_stats(m, state, axes, mesh=mm).items():
        out[f"stats{tag}_{k}"] = val

# session_fold(mesh_axes=)
rng = np.random.default_rng(41)
n = 128
users = rng.integers(0, 12, n); ts = np.sort(rng.uniform(0, 100, n))
sids, ns = sessionize(users, ts, gap=5.0)
vals = rng.integers(0, 100, n).astype(np.int32)
v, s = dist.local_block((torch.from_numpy(vals), torch.from_numpy(sids)), mesh, "data")
with dist.use_mesh(mesh):
    for name, m in (("sum", monoids.sum_), ("max", monoids.max_)):
        out[f"sess_{name}"] = session_fold(m, v, s.numpy(), ns, mesh_axes=("data",))

torch.save(out, path)
tdist.destroy_process_group()
'''


def _wait(procs, what):
    import time

    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{what}: a process was still running after "
                        f"{TIMEOUT_S}s (killed)")
    bad = [(i, p.returncode, p.stderr.read()[-3000:]) for i, p in
           enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"{what} failed: " + "\n".join(
            f"[{i}] rc={rc}\n{err}" for i, rc, err in bad))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the JAX package's results, each rank's results), the two worlds
    run side by side."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_out = str(tmp / "jax.npz")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_CODE, jax_out],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    env = {k: v for k, v in env.items() if k != "XLA_FLAGS"}
    store = str(tmp / "store")
    outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
    ranks = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(r),
                               str(WORLD), store, outs[r]], cwd=ROOT,
                              env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    _wait(ranks, f"the port's {WORLD}-rank gloo world")
    _wait([jax_proc], "the JAX package on 8 fake devices")
    flat = np.load(jax_out)
    jax_res = {}
    for key in flat.files:
        name, i = key.rsplit("#", 1)
        jax_res.setdefault(name, []).append((int(i), flat[key]))
    jax_res = {k: [a for _, a in sorted(v)] for k, v in jax_res.items()}
    jax_res = {k: (v[0] if len(v) == 1 else v) for k, v in jax_res.items()}
    return jax_res, [torch.load(o, weights_only=False) for o in outs]


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), want
    if isinstance(got, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    if tol == 0:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _every_rank(results, key, tol, jkey=None):
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        try:
            _close(res[key], jax_res[jkey or key], tol)
        except AssertionError as e:
            raise AssertionError(f"rank {r}, {key}: {e}") from None


# -- the sharded MapReduce ----------------------------------------------------

@pytest.mark.parametrize("strategy", ["naive", "combiner", "in_mapper"])
def test_sharded_mapreduce_strategies(results, strategy):
    _every_rank(results, f"mr_{strategy}", 1e-5)
    # and the mesh == run_local's simulated shards
    for res in results[1]:
        _close(res[f"mr_{strategy}"], _np(res["mr_local"]), 1e-5)


@pytest.mark.parametrize("strategy", ["naive", "combiner", "in_mapper"])
def test_sharded_max_by_key_is_bit_for_bit(results, strategy):
    _every_rank(results, f"mrmax_{strategy}", 0)
    for res in results[1]:
        _close(res[f"mrmax_{strategy}"], _np(res["mrmax_local"]), 0)


@pytest.mark.parametrize("num_keys", [16, 13])
def test_sharded_mapreduce_executes_plan_shuffle(results, num_keys):
    jax_res, ranks = results
    want_algo = "reduce_scatter" if num_keys % 8 == 0 else "allreduce"
    assert str(jax_res[f"ps{num_keys}_algo"]) == want_algo
    for res in ranks:
        assert res[f"ps{num_keys}_algo"] == want_algo
        assert res[f"ps{num_keys}_pred"] == pytest.approx(
            float(jax_res[f"ps{num_keys}_pred"]), rel=1e-6)
        for s in ("combiner", "in_mapper"):
            _close(res[f"ps{num_keys}_{s}"], jax_res[f"ps{num_keys}_{s}"],
                   1e-5)
            _close(res[f"ps{num_keys}_{s}"], res[f"ps{num_keys}_oracle"],
                   1e-5)
            # the table crossed as the plan says: its per-device wire bytes
            # times the axis size are the plan's group total
            counts = res[f"ps{num_keys}_{s}_counts"]["data"]
            assert counts["wire_bytes"] * WORLD == \
                res[f"ps{num_keys}_{s}_plan_wire"]


# -- combine_keyed_table, reduce-scatter, hierarchical psum -------------------

@pytest.mark.parametrize("algorithm", ["allreduce", "reduce_scatter"])
def test_combine_keyed_table_both_algorithms(results, algorithm):
    _every_rank(results, f"ckt_sum_{algorithm}", 1e-5)
    _every_rank(results, f"ckt_isum_{algorithm}", 0)
    _every_rank(results, f"ckt_max_{algorithm}", 0)
    jax_res, ranks = results
    np.testing.assert_allclose(jax_res[f"ckt_sum_{algorithm}"],
                               jax_res["ckt_sum_allreduce"], atol=1e-5)


@pytest.mark.parametrize("name", ["isum", "max"])
def test_monoid_reduce_scatter_owns_one_key_shard(results, name):
    """Rank i holds key shard i; the shards concatenated are the JAX
    package's (psum_scatter for sum, all_to_all + fold for max)."""
    jax_res, ranks = results
    _close(np.concatenate([_np(r[f"mrs_{name}"]) for r in ranks]),
           jax_res[f"mrs_{name}"], 0)


def test_hierarchical_psum_equals_flat(results):
    jax_res, ranks = results
    np.testing.assert_allclose(jax_res["hp_flat"], jax_res["hp_hier"],
                               rtol=1e-6)
    for r, res in enumerate(ranks):
        d = res["hp_coord"]
        assert d == r // 2
        for key in ("hp_flat", "hp_hier"):
            _close(res[key], jax_res[key][2 * d:2 * d + 2], 1e-6)


def test_hierarchical_psum_pads_leaves_the_axis_does_not_divide(results):
    """3 elements a rank over an ICI axis of 2 (hierarchical_psum) and of 4
    (grad_sync on (pod, data, model)): _pad_to's zeros never show."""
    jax_res, ranks = results
    for r, res in enumerate(ranks):
        d = res["hp_coord"]
        _close(res["hp_pad"], jax_res["hp_pad"][d:d + 1], 1e-6)
        dd = res["dcn_coord"][1]
        _close(res["dcn_grad_odd"], jax_res["dcn_grad_odd"][dd:dd + 1], 1e-6)


def test_monoid_allreduce_attn_state(results):
    jax_res, _ = results
    np.testing.assert_allclose(jax_res["attn"], jax_res["attn_want"],
                               rtol=1e-5, atol=1e-5)
    _every_rank(results, "attn", 1e-5)
    _every_rank(results, "lse", 1e-5)


@pytest.mark.parametrize("family,tol", [
    ("sum", 1e-6), ("max", 0), ("min", 0), ("or", 0), ("hll", 0), ("cms", 0),
    ("mean", 1e-6), ("affine", 1e-5)])
def test_monoid_allreduce_per_family(results, family, tol):
    """Each family's lowering (sum / max / min / max on bitmaps and HLL
    registers / sum on CMS / gather + fold in rank order for the
    non-commutative affine maps) gives the JAX package's value."""
    _every_rank(results, f"fam_{family}", tol)
    counts = results[1][0][f"fam_{family}_counts"]["data"]
    leaves = 2 if family in ("mean", "affine") else 1
    assert counts["calls"] == leaves


def test_bool_bitmaps_cross_as_uint8(results):
    jax_res, ranks = results
    for res in ranks:
        got = res["fam_or_bool"]
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy().astype(np.uint8),
                                      jax_res["fam_or"])


def test_hierarchical_allreduce_keeps_mesh_lexicographic_order(results):
    _every_rank(results, "fam_affine2", 1e-5)


# -- the mesh tier of execute_fold ---------------------------------------------

@pytest.mark.parametrize("seed", [5, 11], ids=["hierarchical", "ragged"])
def test_execute_fold_mesh_tier(results, seed):
    """Per-rank keyed folds (ragged with a valid_mask), then ICI-first-then-
    DCN combine: the JAX package's table.  With ``mesh=`` the planner knows
    the axis sizes and runs a reduce-scatter on each axis, and the bytes
    each axis moved are the plan's."""
    _every_rank(results, f"efm_{seed}", 1e-4)
    _every_rank(results, f"efm_{seed}_mesh", 1e-4, f"efm_{seed}")
    for res in results[1]:
        assert res[f"efm_{seed}_mesh_tiers"][1:] == ["reduce_scatter"] * 2
        counts = res[f"efm_{seed}_mesh_counts"]
        # data (4 ranks) then pod (2): each group's total is size x device
        assert counts["data"]["wire_bytes"] * 4 + \
            counts["pod"]["wire_bytes"] * 2 == res[f"efm_{seed}_mesh_wire"]


@pytest.mark.parametrize("fn", ["grad", "metrics", "max"])
def test_collectives_cross_dcn_once(results, fn):
    """grad_sync / metrics_sync / cross_mesh_allreduce(max) on (pod, data,
    model) = (2, 2, 2) equal the flat collective, and the pod axis is
    crossed once per leaf: grad_sync moves the 1/|ici| shard, the others
    the pre-combined value."""
    jax_res, ranks = results
    want = jax_res["dcn_flatmax" if fn == "max" else "dcn_flat"]
    np.testing.assert_allclose(jax_res[f"dcn_{fn}"], want, rtol=1e-6)
    assert str(jax_res["dcn_axes"]) == "pod"
    assert str(jax_res["ici_axes"]) == "data,model"
    for r, res in enumerate(ranks):
        p, d, m = res["dcn_coord"]
        assert (p, d, m) == (r // 4, (r // 2) % 2, r % 2)
        _close(res[f"dcn_{fn}"], jax_res[f"dcn_{fn}"][4 * d:4 * d + 4], 1e-6)
        assert res["dcn_axes"] == "pod" and res["ici_axes"] == "data,model"
        pod = res[f"dcn_{fn}_counts"]["pod"]
        assert pod["calls"] == 1
        assert pod["bytes"] == (4 * 4 * 4 // 4 if fn == "grad" else 4 * 4 * 4)


def test_cross_axes_allreduce_orders_by_name(results):
    jax_res, ranks = results
    for res in ranks:
        d = res["dcn_coord"][1]
        _close(res["cross_axes_max"], jax_res["dcn_flatmax"][4 * d:4 * d + 4],
               0)


@pytest.mark.parametrize("layout", ["scan", "async", "auto"])
def test_async_microbatch_fold_equals_sync_dense(results, layout):
    jax_res, ranks = results
    _every_rank(results, f"async_{layout}", 1e-4)
    for res in ranks:
        _close(res[f"async_{layout}"], jax_res["ov_want_21"], 1e-4)
        _close(res[f"async_{layout}_mesh"], jax_res["ov_want_21"], 1e-4)
        kind, dense, lossy = res[f"async_{layout}_mesh_plan"]
        pod = res[f"async_{layout}_mesh_counts"]["pod"]
        # dense crossings: the plan's per-device DCN bytes were moved
        assert pod["wire_bytes"] == dense == lossy
        assert pod["calls"] == (4 if kind == "async" else 1)
        if layout != "auto":
            assert kind == ("async" if layout == "async" else "scan")


def test_async_microbatch_fold_direct(results):
    jax_res, ranks = results
    _every_rank(results, "amf_map", 1e-4)
    for res in ranks:
        _close(res["amf_serial"], _np(res["amf_map"]), 0)


@pytest.mark.parametrize("layout", ["scan", "async"])
@pytest.mark.parametrize("lossy", ["topk:0.25", "int8"])
def test_lossy_fold_ef_invariant_at_mesh_scale(results, layout, lossy):
    """Output plus the pod-summed error feedback == the dense sum, and the
    DCN axis moved the plan's compressed bytes, fewer than dense."""
    jax_res, ranks = results
    _every_rank(results, f"lossy_{layout}_{lossy}", 1e-4,
                f"lossy_{layout}_{lossy}")
    for res in ranks:
        _close(res[f"lossy_{layout}_{lossy}"], jax_res["ov_want_22"], 1e-4)
        moved, planned, dense = res[f"lossy_{layout}_{lossy}_wire"]
        assert moved == planned < dense


@pytest.mark.parametrize("lossy", ["topk:0.25", "int8"])
def test_lossy_cross_axes_direct(results, lossy):
    _every_rank(results, f"lca_{lossy}", 1e-4)


# -- sync_stats, session_fold ---------------------------------------------------

@pytest.mark.parametrize("axes", ["1", "2"], ids=["data", "data_pod"])
@pytest.mark.parametrize("key", ["cms", "hll", "bloom", "count"])
def test_sync_stats_is_bit_for_bit(results, axes, key):
    _every_rank(results, f"stats{axes}_{key}", 0)


@pytest.mark.parametrize("name", ["sum", "max"])
def test_session_fold_across_ranks(results, name):
    _every_rank(results, f"sess_{name}", 0)


def test_allreduce_wire_bytes_matches_jax():
    pytest.importorskip("jax")
    from repro.core.aggregation import allreduce_wire_bytes as jwire
    from repro_torch.core.aggregation import allreduce_wire_bytes

    for nbytes, size, algo in ((1000, 1, "ring"), (1000, 4, "ring"),
                               (999, 3, "ring"), (1000, 8, "gather"),
                               (7, 2, "gather")):
        assert allreduce_wire_bytes(nbytes, size, algorithm=algo) == \
            jwire(nbytes, size, algorithm=algo)
    with pytest.raises(ValueError):
        allreduce_wire_bytes(1, 2, algorithm="tree")


def test_split_axis_names_is_one_definition():
    pytest.importorskip("jax")
    from repro.dist.collectives import split_axis_names as jsplit
    from repro_torch.core import plan
    from repro_torch.dist.collectives import split_axis_names

    for axes in (("data",), ("pod", "data", "model"), ("x", "pod"), ()):
        assert split_axis_names(axes) == jsplit(axes) == \
            plan._split_ici_dcn(axes)


@pytest.mark.parametrize("call", ["psum", "all_gather", "axis_size"])
def test_an_unbound_axis_raises_naming_it(call):
    """Outside ``dist.use_mesh`` a name-based collective raises; it never
    runs as a world of one."""
    from repro_torch import dist

    with pytest.raises(ValueError, match="'data' is not bound"):
        if call == "axis_size":
            dist.axis_size("data")
        else:
            getattr(dist, call)(torch.ones(2), "data")


def _rank_result(rank, world, store_path, fail_rank=None):
    """A rank of ``run_world``'s own tests: no process group, its rank."""
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails")
    return torch.full((2,), rank)


def test_run_world_returns_rank_order_and_removes_its_directory(tmp_path):
    from repro_torch.launch.mesh import run_world

    out = run_world(_rank_result, 2, timeout_s=120, store_dir=str(tmp_path))
    assert [t.tolist() for t in out] == [[0, 0], [1, 1]]
    assert list(tmp_path.iterdir()) == []


def test_run_world_fails_when_a_rank_fails(tmp_path):
    from repro_torch.launch.mesh import run_world

    with pytest.raises(RuntimeError, match=r"ranks \[1\] failed"):
        run_world(_rank_result, 2, args=(1,), timeout_s=120,
                  store_dir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []
