"""The port's logical sharding (``repro_torch.dist.sharding``) and the
models' logical axes against the JAX package's, in one process, no world.

The rule tables, ``trim_rules`` and ``spec_for`` on the cases of
``tests/test_distributed.py``'s sharding tests (the 1-device and 4 x 2
meshes, pod x data) and on a sweep of every logical name against each
mesh, compared with ``tuple(repro.dist.sharding.spec_for(...))`` on a mesh
stand-in that has the sizes (the reference reads only ``mesh.shape``);
``param_axes`` / ``param_shapes`` leaf for leaf against the JAX package's
stacked trees; ``shard_params`` then ``gather_params`` over every rank's
blocks (the world simulated rank by rank) giving the parameters back bit
for bit.
"""
import dataclasses
import itertools
import types

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (the JAX package's compat shims first)
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as jshd
from repro.models import param_axes as jax_param_axes
from repro.models import param_shapes as jax_param_shapes
from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.models.convert import _plan
from repro_torch.models.transformer import (init_params, param_axes,
                                            param_shapes)

ARCHS = ["qwen3-0.6b", "qwen2-moe-a2.7b", "gemma3-1b", "qwen2.5-14b",
         "starcoder2-15b", "deepseek-v2-236b", "xlstm-1.3b",
         "jamba-v0.1-52b", "whisper-small", "llama-3.2-vision-90b"]
MESHES = {"1x1": {"data": 1, "model": 1}, "4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2},
          "model4": {"model": 4}, "data2model3": {"data": 2, "model": 3}}


def _jmesh(sizes):
    """What the reference's rule functions read of a mesh: ``shape``."""
    return types.SimpleNamespace(shape=dict(sizes))


def test_rule_tables_are_the_references():
    assert shd.TRAIN_RULES == jshd.TRAIN_RULES
    assert shd.SERVE_RULES == jshd.SERVE_RULES
    for mesh in MESHES.values():
        for rules in (shd.TRAIN_RULES, shd.SERVE_RULES):
            assert shd.trim_rules(rules, mesh) == \
                jshd.trim_rules(rules, _jmesh(mesh))


def test_sharding_rules_1_device():
    """``tests/test_distributed.py::test_sharding_rules_1_device``'s
    specs."""
    mesh = {"data": 1, "model": 1}
    rules = shd.trim_rules(shd.TRAIN_RULES, mesh)
    assert rules["batch"] == "data" and rules["mlp"] == "model"
    assert rules["embed"] is None
    assert shd.spec_for(("batch", "seq", "mlp"), rules, mesh,
                        shape=(4, 16, 8)) == ("data", None, "model")
    assert shd.spec_for(("embed",), rules, mesh, shape=(8,)) == ()


def test_sharding_rules_8_devices():
    """``tests/test_distributed.py::test_sharding_rules_8_devices``'s
    specs: first dimension wins, divisibility, pod x data."""
    mesh2 = {"data": 4, "model": 2}
    rules = shd.trim_rules(shd.TRAIN_RULES, mesh2)
    assert shd.spec_for(("expert", "embed", "mlp"), rules, mesh2,
                        shape=(8, 16, 32)) == ("model",)
    assert shd.spec_for(("batch", "seq"), rules, mesh2, shape=(3, 16)) == ()
    assert shd.spec_for(("batch", "seq"), rules, mesh2,
                        shape=(8, 16)) == ("data",)
    mesh3 = {"pod": 2, "data": 2, "model": 2}
    r3 = shd.trim_rules(shd.TRAIN_RULES, mesh3)
    assert shd.spec_for(("batch", "seq"), r3, mesh3,
                        shape=(8, 16)) == (("pod", "data"),)


NAMES = [None] + sorted(shd.TRAIN_RULES)
SIZES = (1, 2, 3, 4, 6, 8, 12)


def _sweep(seed, n=60):
    """Fixed-seed (names, shape) cases: 1-4 logical dims."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = int(rng.integers(1, 5))
        names = tuple(NAMES[i] for i in rng.integers(0, len(NAMES), d))
        shape = tuple(int(SIZES[i]) for i in rng.integers(0, len(SIZES), d))
        out.append((names, shape))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("table", ["train", "serve"])
def test_spec_for_equals_the_references(mesh_name, table):
    mesh = MESHES[mesh_name]
    rules = shd.trim_rules(shd.TRAIN_RULES if table == "train"
                           else shd.SERVE_RULES, mesh)
    jm = _jmesh(mesh)
    seed = 2 * sorted(MESHES).index(mesh_name) + (table == "serve")
    for names, shape in _sweep(seed):
        for sh in (shape, None):
            want = tuple(jshd.spec_for(names, rules, jm, shape=sh))
            assert shd.spec_for(names, rules, mesh, shape=sh) == want, \
                (names, sh)


def _jax_layout(tree, cfg, stacked):
    """The port's per-layer tree in the JAX package's layout:
    ``stacked(leaves)`` merges one slot's leaves over its periods."""
    pre, P, n_periods, n_rem = _plan(cfg)
    layers = tree["layers"]
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    for i in range(pre):
        out[f"prelude_{i}"] = layers[i]
    if n_periods:
        def merge(*xs):
            if isinstance(xs[0], dict):
                return {k: merge(*(x[k] for x in xs)) for k in xs[0]}
            return stacked(xs)
        out["layers"] = {f"slot_{j}": merge(*[layers[pre + p * P + j]
                                              for p in range(n_periods)])
                         for j in range(P)}
    for i in range(n_rem):
        out[f"rem_{i}"] = layers[pre + n_periods * P + i]
    if "encoder" in tree:
        out["encoder"] = {f"layer_{i}": l for i, l in
                          enumerate(tree["encoder"]["layers"])}
        out["encoder"]["final_norm"] = tree["encoder"]["final_norm"]
    return out


def _stack_axes(xs):
    assert all(x == xs[0] for x in xs), xs
    return ("layers",) + tuple(xs[0])


def _stack_shapes(xs):
    assert all(tuple(x.shape) == tuple(xs[0].shape) for x in xs)
    return (len(xs),) + tuple(xs[0].shape)


def _stack_spec(xs):
    """A stacked leaf's spec: its layer's behind the period dim (rule
    ``layers``: None), trailing Nones trimmed."""
    assert all(x == xs[0] for x in xs), xs
    return (None,) + tuple(xs[0]) if xs[0] else ()


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree.shape) if hasattr(tree, "shape") else tuple(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_are_the_references(arch):
    cfg = get_config(arch, smoke=True)
    got = _jax_layout(param_axes(cfg), cfg, _stack_axes)
    assert _plain(got) == _plain(jax_param_axes(jax_get_config(arch,
                                                               smoke=True)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_are_the_references(arch):
    cfg = get_config(arch, smoke=True)
    shapes = param_shapes(cfg)
    assert all(t.device.type == "meta" for t in
               torch.utils._pytree.tree_leaves(shapes))
    got = _jax_layout(shapes, cfg, _stack_shapes)
    want = jax_param_shapes(jax_get_config(arch, smoke=True))
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_param_shardings_are_the_references(arch):
    """Every leaf's spec on a 1-device mesh, against the reference's
    ``NamedSharding`` (its real mesh), stacked leaves with their leading
    ``layers`` dim."""
    cfg = get_config(arch, smoke=True)
    jcfg = jax_get_config(arch, smoke=True)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    want = jshd.param_shardings(jax_param_shapes(jcfg), jax_param_axes(jcfg),
                                jmesh, jshd.TRAIN_RULES)
    mesh = {"data": 1, "model": 1}
    specs = shd.param_shardings(param_shapes(cfg), param_axes(cfg), mesh,
                                shd.TRAIN_RULES)
    got = _jax_layout(specs, cfg, _stack_spec)
    flat_w = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    for path, ns in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        assert node == tuple(ns.spec), (path, node, ns.spec)


def _params(arch, seed=3):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    return cfg, init_params(cfg, gen, device="cpu")


def _ranks(mesh):
    names = list(mesh)
    for idx in itertools.product(*(range(mesh[n]) for n in names)):
        yield dict(zip(names, idx))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("mesh_name", ["4x2", "model4", "data2model3"])
@pytest.mark.parametrize("table", ["train", "serve"])
def test_shard_then_gather_is_the_identity(arch, mesh_name, table):
    cfg, params = _params(arch)
    mesh = MESHES[mesh_name]
    rules = shd.TRAIN_RULES if table == "train" else shd.SERVE_RULES
    axes = param_axes(cfg)
    blocks = [shd.shard_params(params, axes, mesh, rules, coords=c)
              for c in _ranks(mesh)]
    specs = shd.param_shardings(params, axes, mesh,
                                shd.trim_rules(rules, mesh))

    def check(t, spec, *bs):
        want = shd.block_shape(tuple(t.shape), spec, mesh)
        assert all(tuple(b.shape) == want for b in bs), (spec, want)
        if want != tuple(t.shape):      # a cut block owns its storage
            assert all(b.untyped_storage().nbytes() ==
                       b.numel() * b.element_size() for b in bs), spec
    shd._walk(check, params, specs, *blocks)
    back = shd.gather_params(blocks, axes, mesh, rules, param_shapes(cfg))
    flat_p = torch.utils._pytree.tree_leaves(params)
    flat_b = torch.utils._pytree.tree_leaves(back)
    assert len(flat_p) == len(flat_b)
    for p, b in zip(flat_p, flat_b):
        assert torch.equal(p, b)
    if arch == "qwen2-moe-a2.7b" and mesh.get("model", 1) in (2, 4):
        P = mesh["model"]
        ffn = blocks[-1]["layers"][0]["ffn"]
        assert ffn["we_gate"].shape[0] == cfg.num_experts // P
        assert ffn["router"].shape == params["layers"][0]["ffn"][
            "router"].shape


def test_shard_hook_of_init_params_keeps_the_same_numbers():
    """``init_params(shard=)`` keeps each rank's blocks of the numbers the
    whole draw gives."""
    cfg, params = _params("qwen2-moe-a2.7b", seed=11)
    mesh = {"data": 2, "model": 2}
    for c in _ranks(mesh):
        gen = torch.Generator().manual_seed(11)
        got = init_params(cfg, gen, device="cpu", shard=lambda t, ax, c=c:
                          shd.shard_params(t, ax, mesh, shd.SERVE_RULES,
                                           coords=c))
        want = shd.shard_params(params, param_axes(cfg), mesh,
                                shd.SERVE_RULES, coords=c)
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(g, w)


def test_act_checks_blocks_and_moves_nothing():
    x = torch.zeros((2, 16, 32))
    assert shd.act(x, ("batch", "seq", "mlp")) is x     # no scope: no-op
    mesh = {"data": 4, "model": 2}
    with shd.use_rules(mesh, shd.TRAIN_RULES):
        assert shd.current_rules()[1]["batch"] == "data"
        assert shd.act(x, ("batch", "seq", "mlp"), shape=(8, 16, 64)) is x
        assert shd.cut(("batch", "seq", "mlp"), (8, 16, 64), 2) == ("model",)
        assert shd.cut(("batch", "seq", "mlp"), (3, 16, 64), 0) == ()
        with pytest.raises(ValueError, match="block"):
            shd.act(x, ("batch", "seq", "mlp"), shape=(8, 16, 32))
        with pytest.raises(ValueError):
            shd.act(x, ("batch", "seq"))
    assert shd.current_rules() is None
    assert shd.cut(("mlp",), (64,), 0) == ()
