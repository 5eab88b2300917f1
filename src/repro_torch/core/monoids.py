"""The monoid zoo — the kernel-lowered family.

``sum_``, ``count``, ``max_``, ``min_``, ``mean`` (the paper's running
example, Algorithms 3/4) and ``bitwise_or`` — every monoid the planner can
lower onto the segment-fold kernel.  Each is registered with law samples, so
the law suite covers everything in :data:`REGISTRY`.

All monoid values are pytrees of tensors.  Shape-polymorphic monoids take
their shapes, dtypes and device from ``identity_like(example)``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.utils._pytree as pytree

from .monoid import Monoid, Pytree


def _device_of(tree: Pytree) -> torch.device:
    leaves = [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _tree_binary(op):
    def combine(a, b):
        return pytree.tree_map(op, a, b)
    return combine


def _zeros_like_identity(*, example: Pytree) -> Pytree:
    return pytree.tree_map(torch.zeros_like, example)


sum_ = Monoid(
    name="sum",
    combine=_tree_binary(torch.add),
    identity_fn=_zeros_like_identity,
)


def _neginf_like(x):
    x = torch.as_tensor(x)
    if x.is_floating_point():
        return torch.full_like(x, -float("inf"))
    return torch.full_like(x, torch.iinfo(x.dtype).min)


def _posinf_like(x):
    x = torch.as_tensor(x)
    if x.is_floating_point():
        return torch.full_like(x, float("inf"))
    return torch.full_like(x, torch.iinfo(x.dtype).max)


max_ = Monoid(
    name="max",
    combine=_tree_binary(torch.maximum),
    identity_fn=lambda *, example: pytree.tree_map(_neginf_like, example),
)

min_ = Monoid(
    name="min",
    combine=_tree_binary(torch.minimum),
    identity_fn=lambda *, example: pytree.tree_map(_posinf_like, example),
)

bitwise_or = Monoid(
    name="bitwise_or",
    combine=_tree_binary(torch.bitwise_or),
    identity_fn=lambda *, example: pytree.tree_map(torch.zeros_like, example),
)


# ---------------------------------------------------------------------------
# mean — the paper's running example (Algorithms 3/4)
# ---------------------------------------------------------------------------

def _mean_combine(a, b):
    (sa, ca), (sb, cb) = a, b
    return (pytree.tree_map(torch.add, sa, sb), ca + cb)


def _mean_identity(*, example=None):
    if example is None:
        return (torch.zeros(()), torch.zeros((), dtype=torch.int32))
    s, c = example
    return (pytree.tree_map(torch.zeros_like, s), torch.zeros_like(c))


def _mean_extract(m):
    s, c = m
    return pytree.tree_map(
        lambda x: x / torch.clamp(c, min=1).to(torch.promote_types(
            x.dtype, torch.float32)), s)


mean = Monoid(
    name="mean",
    combine=_mean_combine,
    identity_fn=_mean_identity,
    lift=lambda r: (r, torch.ones((), dtype=torch.int32, device=_device_of(r))),
    extract=_mean_extract,
)

count = Monoid(
    name="count",
    combine=torch.add,
    identity_fn=lambda *, example=None: torch.zeros(
        (), dtype=torch.int32,
        device=_device_of(example) if example is not None else None),
    lift=lambda x: torch.ones((), dtype=torch.int32, device=_device_of(x)),
)


REGISTRY: Dict[str, Monoid] = {}

# ---------------------------------------------------------------------------
# law-sample registry: every monoid in REGISTRY comes with a sample provider
# (a zero-arg callable returning >= 3 post-lift monoid values), so a monoid
# cannot ship law-unchecked
# ---------------------------------------------------------------------------

_LAW_SAMPLES: Dict[str, object] = {}


def register_monoid(m: Monoid, law_samples, *, replace: bool = False) -> Monoid:
    """Register ``m`` in :data:`REGISTRY` together with its law samples.

    Registering a name twice without ``replace=True`` is an error —
    silently shadowing a monoid is how laws stop being checked.
    """
    if m.name in REGISTRY and not replace:
        raise ValueError(f"monoid {m.name!r} is already registered")
    REGISTRY[m.name] = m
    _LAW_SAMPLES[m.name] = law_samples
    return m


def law_samples_for(name: str):
    """The registered sample provider for ``name`` (None when missing)."""
    return _LAW_SAMPLES.get(name)


def missing_law_samples() -> list:
    """Registered monoid names with no law samples — must stay empty."""
    return sorted(name for name in REGISTRY if name not in _LAW_SAMPLES)


def _f32(seed, shape=(3,)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


# the same samples as the JAX zoo's law registry, seed for seed
register_monoid(sum_, lambda: [_f32(s) for s in (0, 1, 2)])
register_monoid(max_, lambda: [_f32(s) for s in (3, 4, 5)])
register_monoid(min_, lambda: [_f32(s) for s in (6, 7, 8)])
register_monoid(mean, lambda: [(_f32(s), torch.tensor(s + 1, dtype=torch.int32))
                               for s in (0, 1, 2)])
register_monoid(count, lambda: [torch.tensor(c, dtype=torch.int32)
                                for c in (1, 4, 9)])
register_monoid(bitwise_or, lambda: [
    torch.from_numpy(np.random.default_rng(s).integers(0, 255, 4)
                     .astype(np.uint8)) for s in (0, 1, 2)])
