"""The port's checkpoint store against the JAX package's: twins of
``tests/test_checkpoint.py`` (atomicity, async, GC, restart exactness by
monoid merge, restoring onto another sharding: per-rank blocks of a
simulated ``{axis: size}`` mesh, through ``gather_params`` / ``block_of``),
and aggregates of plain arrays (f32, bf16, int32) written by either
package and restored by the other, bit for bit.  The save and restore on a
world of ranks are in ``tests/test_torch_tp_train.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.checkpoint import CheckpointStore as JaxStore
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import monoids


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 8), generator=g),
            "b16": torch.randn((3,), generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": {"m": torch.ones((2, 2))}}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_save_restore_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = _tree()
    store.save(3, t)
    step, r = store.restore(t)
    assert step == 3
    for a, b in zip(pytree.tree_leaves(t), pytree.tree_leaves(r)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_async_save_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save_async(1, _tree(1))
    store.save_async(2, _tree(2))
    store.wait()
    assert store.latest_step() == 2
    _, r = store.restore(_tree())
    assert torch.equal(r["w"], _tree(2)["w"])


def test_gc_keeps_newest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _tree(s))
    assert store.all_steps() == [3, 4]


def test_no_tmp_dirs_left(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_aggregate_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    agg = monoids.mean.lift(torch.tensor(4.0))
    store.save(5, _tree(), aggregates={"metrics": ("mean", agg)})
    r = store.restore_aggregate("metrics", like=agg)
    np.testing.assert_allclose(float(r[0]), 4.0)
    assert int(r[1]) == 1
    assert store.restore_aggregate("absent", like=agg) is None


def test_restart_exactness_monoid_merge(tmp_path):
    """aggregate(0..n) == combine(aggregate(0..k) from the checkpoint,
    aggregate(k..n) after the restart), exactly: a Sum monoid."""
    m = monoids.sum_
    stream = [torch.tensor(x, dtype=torch.float32)
              for x in np.random.default_rng(0).normal(size=20)]
    full = stream[0]
    for x in stream[1:]:
        full = m.combine(full, x)
    store = CheckpointStore(str(tmp_path))
    acc = stream[0]
    for x in stream[1:8]:
        acc = m.combine(acc, x)
    store.save(8, {"dummy": torch.zeros(())},
               aggregates={"acc": ("sum", acc)})
    acc2 = store.restore_aggregate("acc", like=acc)
    for x in stream[8:]:
        acc2 = m.combine(acc2, x)
    assert torch.equal(acc2, full)


def test_restore_places_leaves_on_the_template_device(tmp_path):
    """Each restored leaf lands where its ``like`` leaf lives (here the
    CPU; the trainer's template lives on the card) in the saved dtype."""
    store = CheckpointStore(str(tmp_path))
    store.save(1, _tree())
    like = pytree.tree_map(lambda t: torch.zeros(t.shape, device="meta"),
                           _tree())
    _, r = store.restore(like)
    assert {t.device.type for t in pytree.tree_leaves(r)} == {"meta"}
    with pytest.raises(ValueError, match="leaves"):
        store.restore({"w": torch.zeros(4, 8)})
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "empty")).restore(_tree())


def _ranks(sizes):
    """Every rank's {axis: index} of a row-major ``{axis: size}`` mesh."""
    names, out = list(sizes), []
    for r in range(int(np.prod(list(sizes.values())))):
        coords, rest = {}, r
        for n in reversed(names):
            coords[n] = rest % sizes[n]
            rest //= sizes[n]
        out.append(coords)
    return out


def test_restore_onto_different_sharding(tmp_path):
    """Elastic-remesh path: the on-disk layout is mesh-agnostic.  The
    reference's case (a replicated spec on a 1-axis mesh), then the blocks
    of the smoke qwen3 under ``TRAIN_RULES`` at mesh (data 2, model 2),
    assembled (``gather_params``) and saved, restored onto (1, 4) and onto
    no mesh: every block, and the whole tree, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_axes, param_shapes

    store = CheckpointStore(str(tmp_path))
    t = _tree()
    store.save(1, t)
    shardings = {"w": (), "b16": (), "step": (), "nested": {"m": ()}}
    step, r = store.restore(t, shardings=shardings, mesh={"data": 1},
                            coords={"data": 0})
    assert step == 1 and torch.equal(r["w"], t["w"])

    cfg = get_config("qwen3-0.6b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    axes, shapes = param_axes(cfg), param_shapes(cfg)
    m22, m14 = {"data": 2, "model": 2}, {"data": 1, "model": 4}
    blocks = [shd.shard_params(params, axes, m22, shd.TRAIN_RULES, coords=c)
              for c in _ranks(m22)]
    assert blocks[1]["layers"][0]["mix"]["wq"].shape[1] == \
        cfg.num_heads // 2
    saved = shd.gather_params(blocks, axes, m22, shd.TRAIN_RULES, shapes)
    store.save(2, saved)
    specs = shd.param_shardings(shapes, axes, m14,
                                shd.trim_rules(shd.TRAIN_RULES, m14))
    got = []
    for c in _ranks(m14):
        _, b = store.restore(params, step=2, shardings=specs, mesh=m14,
                             coords=c)
        want = shd.shard_params(params, axes, m14, shd.TRAIN_RULES, coords=c)
        for x, y in zip(pytree.tree_leaves(b), pytree.tree_leaves(want)):
            assert x.shape == y.shape and torch.equal(x, y)
        # a cut block owns its storage: the whole leaf can go
        leaf = b["layers"][0]["mix"]["wq"]
        assert leaf.untyped_storage().nbytes() == \
            leaf.numel() * leaf.element_size()
        got.append(b)
    back = shd.gather_params(got, axes, m14, shd.TRAIN_RULES, shapes)
    _, whole = store.restore(params, step=2)
    for x, y, z in zip(pytree.tree_leaves(back), pytree.tree_leaves(whole),
                       pytree.tree_leaves(params)):
        assert torch.equal(x, z) and torch.equal(y, z)


def _agg_np(seed):
    rng = np.random.default_rng(seed)
    return {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "bf16": rng.normal(size=(7,)).astype(np.float32),
            "i32": rng.integers(-2**31, 2**31 - 1, size=(4,)).astype(np.int32),
            "nest": {"b": [rng.normal(size=(2,)).astype(np.float32),
                           np.int32(9)],
                     "a": rng.normal(size=()).astype(np.float32)}}


def _as_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["bf16"] = out["bf16"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    out["bf16"] = out["bf16"].to(torch.bfloat16)
    return out


def _same(t_leaf, j_leaf):
    j = np.asarray(j_leaf)
    if t_leaf.dtype == torch.bfloat16:
        assert j.dtype.name == "bfloat16"
        return np.array_equal(t_leaf.view(torch.int16).numpy(),
                              j.view(np.int16))
    assert t_leaf.numpy().dtype == j.dtype
    return np.array_equal(t_leaf.numpy(), j)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_aggregates_cross_packages_bit_for_bit(tmp_path, writer):
    """An aggregate of f32, bf16 and int32 arrays in nested dicts and lists
    saved by one package restores in the other bit for bit, and the model
    state's leaves line up key for key."""
    jt, tt = _as_jax(_agg_np(1)), _as_torch(_agg_np(1))
    state_j = {"z": jnp.ones((2,)), "a": [jnp.zeros((1,), jnp.int32)]}
    state_t = {"z": torch.ones(2), "a": [torch.zeros(1, dtype=torch.int32)]}
    if writer == "jax":
        JaxStore(str(tmp_path)).save(4, state_j,
                                     aggregates={"stats": ("sum", jt)})
        step, st = CheckpointStore(str(tmp_path)).restore(state_t)
        got = CheckpointStore(str(tmp_path)).restore_aggregate("stats",
                                                               like=tt)
        assert step == 4 and torch.equal(st["z"], state_t["z"])
        pairs = zip(pytree.tree_leaves(_sorted(got)),
                    jax.tree_util.tree_leaves(jt))
    else:
        CheckpointStore(str(tmp_path)).save(4, state_t,
                                            aggregates={"stats": ("sum", tt)})
        step, st = JaxStore(str(tmp_path)).restore(state_j)
        got = JaxStore(str(tmp_path)).restore_aggregate("stats", like=jt)
        assert step == 4
        np.testing.assert_array_equal(np.asarray(st["z"]), np.ones(2))
        pairs = zip(pytree.tree_leaves(_sorted(tt)),
                    jax.tree_util.tree_leaves(got))
    pairs = list(pairs)
    assert len(pairs) == 6
    for t_leaf, j_leaf in pairs:
        assert _same(t_leaf, j_leaf)
    import json
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        keys = [e["key"] for e in json.load(f)["aggregates"]["stats"]
                ["leaves"]]
    assert keys == [jax.tree_util.keystr(p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(jt)[0]]


def _sorted(tree):
    """``tree`` with its dicts' keys in sorted order (JAX's leaf order)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(x) for x in tree)
    return tree
