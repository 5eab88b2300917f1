"""The mesh tier's train half for MLA, the recurrent and the context
families against the JAX package's, on 4 ranks.

deepseek-v2-236b (MLA, two shared experts, a dense prelude layer),
xlstm-1.3b (mLSTM / sLSTM), jamba-v0.1-52b (Mamba, attention and MoE),
whisper-small (encoder-decoder) and llama-3.2-vision-90b (gated
cross-attention), each at its f32 smoke config, trained on explicit
per-rank shards with ``make_train_step(mesh=)`` under ``TRAIN_RULES``
(the batch and the context cut over 'data'; heads, KV heads, mlp,
d_inner, vocab and experts over 'model'; Mamba's ``w_in`` and mLSTM's
``w_up`` cut by their halves).  whisper's vocabulary is 515 here, which
neither 2 nor 4 divides, as the published 51865 is not: the tied
embedding stays replicated and the cross-entropy runs on the whole logits
under the mesh.

The JAX side runs the reference's ``make_train_step`` in ONE subprocess on
4 fake XLA devices, mesh (2, 2) ('data', 'model'); it writes the f32
smoke weights first (the cross-attention gates at 0.5: at the reference's
0 the cross-attention weights get no gradient; an expert capacity of
every routed pair, so the mesh drops none), and the port's ONE 4-rank
gloo world (one process per rank, ``FileStore`` under the test's
temporary directory, one torch thread each) loads them and runs every
case while the JAX side goes on.  Each case runs 3 chained steps, each
package carrying its own state with its float32 master weights as the
parameters.  The world then runs ``train()`` for xlstm at (2, 2), saves,
and restores the save onto (1, 4).  Both worlds have a join timeout that
kills only the fixture's own children.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 420
B, S, STEPS, GATE = 4, 16, 3, 0.5
OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=50)

# the smoke configs in f32, by name: (arch, overrides); capacity 4 = the
# largest model axis here, so no routed pair is dropped on the mesh
ARCHS = {"deepseek": ("deepseek-v2-236b", {"moe_capacity_factor": 4.0}),
         "xlstm": ("xlstm-1.3b", {}),
         "jamba": ("jamba-v0.1-52b", {"moe_capacity_factor": 4.0}),
         "whisper": ("whisper-small", {"vocab_size": 515}),
         "vision": ("llama-3.2-vision-90b", {})}
# case -> (arch name, microbatches, lossy, chained): a chained case carries
# each package's own state from step to step; the others start each step
# from the JAX package's state after the step before (as
# tests/test_torch_train_step.py holds the one-device step), because in
# the recurrent models the chains part: Adam's update g / (|g| + eps) on a
# gradient near eps moves an element of the masters by up to lr (xlstm's
# embedding, 9.4e-3 after step 0), and by step 2 the losses of the two
# packages' chains differ by 2.6e-2 (xlstm) and 1.5e-2 (jamba) relative
CASES = {"deepseek": ("deepseek", 1, None, True),
         "whisper": ("whisper", 1, None, True),
         "vision": ("vision", 1, None, True),
         "xlstm": ("xlstm", 1, None, False),
         "jamba_mb2": ("jamba", 2, None, False),
         "xlstm_int8": ("xlstm", 1, "int8", False)}

SHARED_CODE = r'''
import sys
import numpy as np
ARCHS, CASES, B, S, STEPS, OPT, GATE = (eval(a) for a in sys.argv[2:9])


def batches(cfg):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                                1)
        b = {"tokens": toks, "labels": labels}
        rows = {"audio": cfg.encoder_seq,
                "vlm": cfg.num_image_tokens}.get(cfg.family)
        if rows:
            b["context"] = rng.normal(size=(B, rows, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out
'''

# ---------------------------------------------------------------------------
# the JAX package, 4 fake devices, one subprocess
# ---------------------------------------------------------------------------

JAX_CODE = SHARED_CODE + r'''
import dataclasses, os
import repro  # noqa: F401  (installs the jax API compat shims first)
import jax, jax.numpy as jnp
assert len(jax.devices()) == 4, jax.devices()
from repro.configs import ShapeCell, get_config
from repro.launch.steps import make_train_step
from repro.models import RunCtx, init_params
from repro.optim import OptConfig, init_opt_state
out_path, params_path = sys.argv[1], sys.argv[9]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
tree = jax.tree_util


def flat(prefix, t, into):
    for path, leaf in tree.tree_flatten_with_path(t)[0]:
        into[prefix + "|" + "/".join(k.key for k in path)] = np.asarray(leaf)


def gated(path, leaf):
    return jnp.full_like(leaf, GATE) if path[-1].key == "gate" else leaf


cfgs, params, w = {}, {}, {}
for name, (arch, over) in ARCHS.items():
    cfgs[name] = dataclasses.replace(get_config(arch, smoke=True),
                                     dtype=jnp.float32, **over)
    params[name] = tree.tree_map_with_path(
        gated, init_params(cfgs[name], jax.random.PRNGKey(0))[0])
    flat(name, params[name], w)
np.savez(params_path + ".tmp.npz", **w)
os.replace(params_path + ".tmp.npz", params_path)   # the ranks wait for it

out = {}
# the cases the ranks feed from these states first, each in a file of its
# own as soon as it is done
for case in sorted(CASES, key=lambda c: CASES[c][3]):
    name, mb, lossy, _ = CASES[case]
    cfg = cfgs[name]
    mine = {}
    built = make_train_step(cfg, mesh, ShapeCell("t", "train", S, B),
                            opt=OptConfig(**OPT), ctx=RunCtx(mesh=mesh),
                            num_microbatches=mb, lossy=lossy, donate=False)
    opt = jax.device_put(init_opt_state(params[name],
                                        with_ef=lossy is not None),
                         built.in_shardings[1])
    for i, b in enumerate(batches(cfg)):
        batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                               built.in_shardings[2])
        _, opt, m = built.fn(opt["master"], opt, batch)
        for k, v in m.items():
            mine[f"{case}|{i}|metric|{k}"] = np.asarray(v)
        for part, t in opt.items():
            if part != "step":
                flat(f"{case}|{i}|{part}", t, mine)
    np.savez(f"{out_path}.{case}.tmp.npz", **mine)
    os.replace(f"{out_path}.{case}.tmp.npz", f"{out_path}.{case}.npz")
    out.update(mine)
np.savez(out_path, **out)
'''

# ---------------------------------------------------------------------------
# the port, one process per rank of a 4-rank gloo world
# ---------------------------------------------------------------------------

RANK_CODE = SHARED_CODE + r'''
import dataclasses, os, time
import torch
import torch.distributed as tdist
import torch.utils._pytree as pytree
torch.set_num_threads(1)
rank, params_path, store, path, tmp, jax_out = (
    int(sys.argv[1]), sys.argv[9], sys.argv[10], sys.argv[11], sys.argv[12],
    sys.argv[13])
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainerConfig, train
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import param_axes, param_shapes
from repro_torch.optim import OptConfig, init_opt_state

init_distributed("gloo", rank, 4, tdist.FileStore(store, 4), timeout_s=200)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
deadline = time.monotonic() + 300
while not os.path.exists(params_path):      # the JAX side writes it first
    assert time.monotonic() < deadline, "no weights from the JAX side"
    time.sleep(0.2)
flat = np.load(params_path)


def unflat(prefix):
    tree = {}
    for key in flat.files:
        case, leaf = key.split("|", 1)
        if case != prefix:
            continue
        node = tree
        *parents, last = leaf.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = flat[key]
    return tree


cfgs, params = {}, {}
for name, (arch, over) in ARCHS.items():
    cfgs[name] = dataclasses.replace(get_config(arch, smoke=True),
                                     dtype=torch.float32, **over)
    params[name] = params_from_jax(unflat(name), cfgs[name], device="cpu")
opt_cfg = OptConfig(**OPT)
out = {"cases": {}}


def gathered(tree, cfg):
    return shd.gather_params(tree, param_axes(cfg), mesh, shd.TRAIN_RULES,
                             param_shapes(cfg))


def _keys(tree, prefix=""):
    """A tree shaped like ``tree`` whose leaves are their paths."""
    if isinstance(tree, dict):
        return {k: _keys(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return prefix


def jax_state(case, i, cfg, with_ef):
    """The JAX package's optimizer state after step ``i`` of ``case``."""
    file = f"{jax_out}.{case}.npz"
    deadline = time.monotonic() + 300
    while not os.path.exists(file):
        assert time.monotonic() < deadline, f"no {case} states from JAX"
        time.sleep(0.2)
    ref = np.load(file)

    def part(name):
        tree = {}
        prefix = f"{case}|{i}|{name}|"
        for key in ref.files:
            if not key.startswith(prefix):
                continue
            node = tree
            *parents, last = key[len(prefix):].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = ref[key]
        return params_from_jax(tree, cfg, device="cpu")
    state = {"step": torch.tensor(i + 1, dtype=torch.int32)}
    for name in ("m", "v", "master") + (("ef",) if with_ef else ()):
        state[name] = part(name)
    return state


# the chained cases first: the JAX side writes the others' states first
for case in sorted(CASES, key=lambda c: not CASES[c][3]):
    name, mb, lossy, chained = CASES[case]
    cfg = cfgs[name]
    built = make_train_step(cfg, mesh, opt=opt_cfg, num_microbatches=mb,
                            lossy=lossy)
    one = make_train_step(cfg, opt=opt_cfg, num_microbatches=mb, lossy=lossy)
    state = init_opt_state(params[name], with_ef=lossy is not None)
    p, o, _ = built.local(state["master"], state, {})
    steps, single, reps = [], None, None
    for i, b in enumerate(batches(cfg)):
        full_b = {k: torch.from_numpy(v) for k, v in b.items()}
        if i == 0:      # one rank from the same state and batch
            _, _, m1 = one(state["master"], state, full_b)
            single = {k: float(m1[k]) for k in ("loss", "grad_norm")}
        lb = {k: shd.block_of(v, built.in_shardings[2][k], mesh)
              for k, v in full_b.items()}
        if i and not chained:
            _, o, _ = built.local(state["master"], jax_state(
                case, i - 1, cfg, lossy is not None), {})
        p, o, m = built.fn(o["master"], o, lb)
        # every rank gathers (a collective); rank 0 keeps the whole state
        whole = {part: gathered(o[part], cfg)
                 for part in ("m", "v", "master", "ef") if part in o}
        steps.append({"metrics": {k: v.clone() for k, v in m.items()},
                      **(whole if rank == 0 else {})})
        if i == 0:      # this rank's copies of the replicated leaves
            reps = {}
            shd._walk(lambda t, sp, k: None if sp else
                      reps.__setitem__(k, t.clone()),
                      o["master"], built.in_shardings[0], _keys(o["master"]))
    out["cases"][case] = {"steps": steps, "single": single,
                          "replicated": reps}
'''

RANK_CODE += r'''
# train() for xlstm at (2, 2), its packed leaves saved whole; the save
# restored onto (1, 4), every leaf of the parameters and the optimizer
# state gathered back bit-equal to the saved one
tc = TrainerConfig(arch="xlstm-1.3b", steps=2, global_batch=4, seq_len=16,
                   ckpt_every=2, log_every=1, device="cpu",
                   model_parallel=2, ckpt_dir=f"{tmp}/xlstm")
run = train(tc)
xcfg = get_config("xlstm-1.3b", smoke=True)
axes, shapes = param_axes(xcfg), param_shapes(xcfg)
saved = (shd.gather_params(run["params"], axes, mesh, shd.TRAIN_RULES,
                           shapes),
         {k: (v if k == "step" else shd.gather_params(
             v, axes, mesh, shd.TRAIN_RULES, shapes))
          for k, v in run["opt_state"].items()})
mesh14 = make_mesh((1, 4), ("data", "model"), device="cpu")
built14 = make_train_step(xcfg, mesh14)
_, (p14, o14) = CheckpointStore(f"{tmp}/xlstm").restore(
    (run["params"], run["opt_state"]), step=2,
    shardings=built14.in_shardings[:2], mesh=mesh14)
back = (shd.gather_params(p14, axes, mesh14, shd.TRAIN_RULES, shapes),
        {k: (v if k == "step" else shd.gather_params(
            v, axes, mesh14, shd.TRAIN_RULES, shapes))
         for k, v in o14.items()})
out["restore"] = {
    "equal": all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(back), pytree.tree_leaves(saved))),
    "leaves": len(pytree.tree_leaves(saved)),
    "w_up_14": tuple(p14["layers"][0]["mix"]["w_up"].shape),
    "steps_done": run["steps_done"],
    "losses": [h["loss"] for h in run["history"]]}
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
    tmp = tmp_path_factory.mktemp("tp_train_families")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    shared = [repr(ARCHS), repr(CASES), str(B), str(S), str(STEPS),
              repr(OPT), repr(GATE)]
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
            [params_path, store, outs[r], str(tmp), jax_out], cwd=ROOT,
            env=env,
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
    return dict(np.load(jax_out)), [torch.load(o, weights_only=False)
                                    for o in outs]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_tree(jax_res, prefix):
    tree = {}
    for key, val in jax_res.items():
        if not key.startswith(prefix + "|"):
            continue
        node = tree
        *parents, last = key[len(prefix) + 1:].split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = val
    return tree


def _port_cfg(name):
    from repro_torch.configs import get_config
    arch, over = ARCHS[name]
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32, **over)


def _hold(got, want, most, within, rel=1e-5):
    """Each leaf within ``rel`` of its max magnitude (or 1e-6), but for at
    most ``most`` elements in all, each within ``within``
    (``tests/test_torch_tp_train.py``'s measure)."""
    bad = 0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        d = (g.double() - w.double()).abs()
        off = d > max(rel * float(w.abs().max()), 1e-6)
        bad += int(off.sum())
        assert not off.any() or float(d[off].max()) <= within
    assert bad <= most, (bad, most)
    return bad


# (case, most elements off per part and step, each within), set above the
# readings, the most of any part over the 3 steps (m and v: none off but
# in the int8 case; the masters, where Adam's update g / (|g| + eps) meets
# a gradient near eps, an element moving by up to lr): deepseek 83 at
# 1.5e-4, whisper 9 at 7.9e-5, vision 772 at 6.2e-4 (chained: the count
# grows by step), xlstm 264 at 9.4e-3 (one embedding element, its update's
# sign flipped), jamba_mb2 243 at 3.3e-4, xlstm_int8 110 at 3.1e-3 (m: 79
# at 4.9e-5 where an int8 code at a .5 boundary flips)
STATE_CASES = [("deepseek", 128, 3e-4), ("whisper", 32, 2e-4),
               ("vision", 1024, 1e-3), ("xlstm", 384, 2e-2),
               ("jamba_mb2", 384, 1e-3), ("xlstm_int8", 192, 5e-3)]
# the int8 residual: each is what the code left of its element, and the
# code's scale rides the leaf's largest gradient, so a 4e-6 relative
# difference there moves a residual by 1e-3 of the largest; it is held at
# 1e-2 of each leaf's largest, but for the elements whose code flipped
# (116 at most in the readings), each within one quantum (2.0e-2 at most)
EF_HOLD = dict(rel=1e-2, most=192, within=2.5e-2)


@pytest.mark.parametrize("case,most,within", STATE_CASES)
def test_chained_mesh_train_steps_match_jax(results, case, most, within):
    """Three steps at mesh (2, 2), chained or each from the reference's
    state (``CASES``): every rank's metrics within 1e-5 of the JAX
    package's step on 4 devices, and the optimizer moments and the float32
    masters gathered from the blocks within 1e-5 of each leaf's max
    magnitude, but for the elements counted (the error-feedback residual
    as ``EF_HOLD`` says)."""
    from repro_torch.models import params_from_jax
    jax_res, ranks = results
    cfg = _port_cfg(CASES[case][0])
    for i in range(STEPS):
        for r, res in enumerate(ranks):
            got = res["cases"][case]["steps"][i]["metrics"]
            for k, v in got.items():
                w = jax_res[f"{case}|{i}|metric|{k}"]
                np.testing.assert_allclose(_np(v), w, rtol=1e-5, atol=1e-5,
                                           err_msg=f"rank {r} step {i} {k}")
        state = ranks[0]["cases"][case]["steps"][i]
        for part in ("m", "v", "master", "ef"):
            tree = _jax_tree(jax_res, f"{case}|{i}|{part}")
            if not tree:
                assert part not in state
                continue
            want = params_from_jax(tree, cfg, device="cpu")
            bad = _hold(state[part], want, **(
                EF_HOLD if part == "ef" else dict(most=most, within=within)))
            print(f"{case} step {i} {part}: {bad} elements off")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_matches_one_rank(results, case):
    """The first step's loss and grad_norm within 5e-3 relative of one
    rank's step from the same state and batch (the reference's bound,
    ``tests/test_distributed.py``'s (DP x TP) step against one device)."""
    _, ranks = results
    for r, res in enumerate(ranks):
        one = res["cases"][case]["single"]
        got = res["cases"][case]["steps"][0]["metrics"]
        for k in ("loss", "grad_norm"):
            a, b = float(got[k]), one[k]
            assert abs(a - b) / max(abs(b), 1e-6) < 5e-3, (r, k, a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_equal_across_model_ranks(results, case):
    """Every leaf replicated over 'model' (norms, MLA's ``wq_a`` /
    ``wkv_a``, the router, mLSTM's ``b_if``, the gates, whisper's
    embedding, KV heads the axis does not divide) is bit-equal on the
    model ranks of a data rank after a step: their gradients were
    equal."""
    _, ranks = results
    for r, res in enumerate(ranks):
        partner = ranks[r ^ 1]["cases"][case]["replicated"]
        mine = res["cases"][case]["replicated"]
        assert sorted(mine) == sorted(partner) and mine
        for k, a in mine.items():
            assert torch.equal(a, partner[k]), (r, case, k)
    if case == "whisper":           # 515 rows: the axis divides neither
        assert "/embed" in ranks[0]["cases"][case]["replicated"]


def test_train_save_restores_onto_another_mesh_bit_for_bit(results):
    """``train()`` for xlstm at mesh (2, 2), its checkpoint restored onto
    (1, 4): the packed ``w_up`` holds a quarter of each half a rank, and
    every leaf of the parameters and the optimizer state gathered back is
    the saved one, bit for bit."""
    _, ranks = results
    for res in ranks:
        rs = res["restore"]
        assert rs["equal"] and rs["leaves"] > 0 and rs["steps_done"] == 2
        assert rs["w_up_14"] == (64, 2 * 128 // 4)
        assert all(np.isfinite(rs["losses"]))


def test_world_memory(results):
    """The ranks' summed peak RSS (recorded in CHANGES.md) stays small."""
    _, ranks = results
    total_gib = sum(res["maxrss_kb"] for res in ranks) / 2 ** 20
    print(f"the 4 ranks' summed peak RSS: {total_gib:.2f} GiB")
    assert total_gib < 6.0, total_gib


def test_cli_model_parallel_trains_a_context_arch_as_one_rank():
    """The train CLI's ``--model-parallel 2`` world for whisper-small's
    smoke model (its stub context drawn by the corpus, cut over the batch)
    against the CLI on one rank: the losses within 5e-3 relative, the
    stream stats bit-equal."""
    from repro_torch.launch.train import main

    argv = ["--arch", "whisper-small", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    one = main(argv)
    two = main(argv + ["--model-parallel", "2"])
    assert two["steps_done"] == 3
    np.testing.assert_allclose([h["loss"] for h in two["history"]],
                               [h["loss"] for h in one["history"]],
                               rtol=5e-3)
    for k, v in one["stream_stats"].items():
        assert torch.equal(two["stream_stats"][k], v), k
