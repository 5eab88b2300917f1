"""The monoid zoo.

* the kernel-lowered family: ``sum_``, ``count``, ``max_``, ``min_``,
  ``mean`` (the paper's running example, Algorithms 3/4) and ``bitwise_or``
  — every monoid the planner can lower onto the segment-fold kernel;
* the rest of the algebra: ``prod``, ``welford``, ``logsumexp``,
  ``attn_state``, ``affine_scan``, :func:`top_k` and the :func:`product`
  combinator;
* the §3 sketches: :func:`bloom_filter`, :func:`count_min` (batch update on
  the ``cms_update`` CUDA kernel) and :func:`hyperloglog`, over the
  multiply-xorshift hash :func:`_uhash`, bit for bit the JAX package's;
* Algorithm 5's ``stripes`` and :func:`cooccurrence_stripes` (on the
  ``stripes`` CUDA kernel);
* the time-decay monoids (:func:`decayed_sum`, :func:`decayed_count`,
  :func:`decayed_lru`, re-anchored by :func:`decayed_value`) and the prefix
  cache's :func:`cache_stats` product.

Each monoid in :data:`REGISTRY` is registered with law samples (the JAX
registry's, seed for seed), so the law suite covers all of them.

All monoid values are pytrees of tensors.  Shape-polymorphic monoids take
their shapes, dtypes and device from ``identity_like(example)``.  Lifts are
written out of place (comparisons against ``arange`` instead of indexed
writes) because the planner runs them under ``torch.func.vmap``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

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

prod = Monoid(
    name="prod",
    combine=_tree_binary(torch.mul),
    identity_fn=lambda *, example: pytree.tree_map(torch.ones_like, example),
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




# ---------------------------------------------------------------------------
# Welford / Chan parallel variance — streaming (count, mean, M2)
# ---------------------------------------------------------------------------

def _welford_combine(a, b):
    na, ma, m2a = a
    nb, mb, m2b = b
    n = na + nb
    nf = torch.clamp(n, min=1.0)
    delta = mb - ma
    return (n, ma + delta * (nb / nf), m2a + m2b + delta * delta * (na * nb / nf))


def _welford_identity(*, example=None):
    if example is None:
        return (torch.zeros(()), torch.zeros(()), torch.zeros(()))
    return tuple(torch.zeros_like(x) for x in example)


welford = Monoid(
    name="welford",
    combine=_welford_combine,
    identity_fn=_welford_identity,
    lift=lambda x: (torch.ones_like(x), x, torch.zeros_like(x)),
    extract=lambda m: {"count": m[0], "mean": m[1],
                       "var": m[2] / torch.clamp(m[0], min=1.0)},
)


# ---------------------------------------------------------------------------
# logsumexp and the attention-state monoid (online softmax)
# ---------------------------------------------------------------------------

def _safe_coeff(m_old, m_new):
    """exp(m_old - m_new), with the convention exp(-inf - -inf) = 0."""
    return torch.where(torch.isneginf(m_old), torch.zeros_like(m_old),
                       torch.exp(m_old - m_new))


def _lse_combine(a, b):
    (ma, la), (mb, lb) = a, b
    m = torch.maximum(ma, mb)
    return (m, la * _safe_coeff(ma, m) + lb * _safe_coeff(mb, m))


def _lse_identity(*, example=None):
    if example is None:
        return (torch.full((), -float("inf")), torch.zeros(()))
    return (torch.full_like(example[0], -float("inf")),
            torch.zeros_like(example[1]))


logsumexp = Monoid(
    name="logsumexp",
    combine=_lse_combine,
    identity_fn=_lse_identity,
    lift=lambda x: (x, torch.ones_like(x)),
    extract=lambda m: m[0] + torch.log(m[1]),
)


def _attn_combine(a, b):
    """Merge two partial softmax-attention states (m, l, o): running max of
    logits, running sum of exp(logit - m), running sum of exp(logit - m) * V
    (m, l: (...,); o: (..., d)) — the flash-decoding merge."""
    (ma, la, oa), (mb, lb, ob) = a, b
    m = torch.maximum(ma, mb)
    ca = _safe_coeff(ma, m)
    cb = _safe_coeff(mb, m)
    return (m, la * ca + lb * cb, oa * ca[..., None] + ob * cb[..., None])


def _attn_identity(*, example=None):
    if example is None:
        raise ValueError("attn_state identity requires an example "
                         "(shape-polymorphic)")
    m, l, o = example
    return (torch.full_like(m, -float("inf")), torch.zeros_like(l),
            torch.zeros_like(o))


attn_state = Monoid(
    name="attn_state",
    combine=_attn_combine,
    identity_fn=_attn_identity,
    extract=lambda s: s[2] / torch.clamp(s[1], min=1e-30)[..., None],
)


# ---------------------------------------------------------------------------
# affine-map composition — linear recurrences (NOT commutative)
# ---------------------------------------------------------------------------

def _affine_combine(f, g):
    """Compose x -> g(f(x)) for affine maps f=(a1,b1), g=(a2,b2):
    (a2*a1, a2*b1 + b2)."""
    a1, b1 = f
    a2, b2 = g
    return (a2 * a1, a2 * b1 + b2)


def _affine_identity(*, example=None):
    if example is None:
        return (torch.ones(()), torch.zeros(()))
    return (torch.ones_like(example[0]), torch.zeros_like(example[1]))


affine_scan = Monoid(
    name="affine_scan",
    combine=_affine_combine,
    identity_fn=_affine_identity,
    commutative=False,
    extract=lambda f: f[1],     # applied to initial state 0: h = b
)


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------

def top_k(k: int) -> Monoid:
    """Monoid of the k largest (value, id) pairs, values sorted descending."""

    def combine(a, b):
        (va, ia), (vb, ib) = a, b
        v = torch.cat([va, vb], dim=-1)
        i = torch.cat([ia, ib], dim=-1)
        vals, idx = torch.topk(v, k, dim=-1)
        return (vals, torch.take_along_dim(i, idx, dim=-1))

    def identity_fn(*, example=None):
        if example is None:
            return (torch.full((k,), -float("inf")),
                    torch.full((k,), -1, dtype=torch.int32))
        v, i = example
        return (torch.full_like(v, -float("inf")), torch.full_like(i, -1))

    def lift(vi):
        v, i = vi
        v = torch.as_tensor(v)
        i = torch.as_tensor(i)
        dtype = torch.promote_types(v.dtype, torch.float32)
        pad_v = torch.full((k - 1,), -float("inf"), dtype=dtype,
                           device=v.device)
        pad_i = torch.full((k - 1,), -1, dtype=torch.int32, device=i.device)
        return (torch.cat([torch.atleast_1d(v).to(dtype), pad_v]),
                torch.cat([torch.atleast_1d(i).to(torch.int32), pad_i]))

    return Monoid(name=f"top{k}", combine=combine, identity_fn=identity_fn,
                  lift=lift)


# ---------------------------------------------------------------------------
# hashing for the sketch monoids: JAX's uint32 arithmetic, in int64
# ---------------------------------------------------------------------------

# the JAX package's _HASH_PRIMES (repro/core/monoids.py), in order; the CUDA
# kernel csrc/cms_update.cu holds the same table
_HASH_PRIMES = (
    0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
    0xD3A2646C, 0xFD7046C5, 0xB55A4F09, 0x8DA6B343, 0xD8163841,
)
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, a: int) -> torch.Tensor:
    """``h * a mod 2**32`` for ``h`` in [0, 2**32) held in int64, without
    overflowing int64: multiply by the prime's two 16-bit halves."""
    lo, hi = a & 0xFFFF, a >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def _uhash(x, seed: int) -> torch.Tensor:
    """Multiply-xorshift universal hash of int token ids, bit for bit the
    JAX package's uint32 ``_uhash``: the id's low 32 bits (JAX's int32 ->
    uint32 convert) hashed mod 2**32.  Returns int64 in [0, 2**32)."""
    x = torch.as_tensor(x).to(torch.int64) & _MASK32
    a = _HASH_PRIMES[seed % len(_HASH_PRIMES)]
    b = _HASH_PRIMES[(seed + 3) % len(_HASH_PRIMES)]
    h = _mul32(x ^ (x >> 16), a)
    h = _mul32(h ^ (h >> 13), b)
    return h ^ (h >> 16)


def _one_hot_rows(idx: torch.Tensor, width: int) -> torch.Tensor:
    """(..., width) bool: True at ``idx`` along the last axis."""
    return torch.arange(width, device=idx.device) == idx[..., None]


# ---------------------------------------------------------------------------
# Bloom filter (paper §3, [Bloom 1970])
# ---------------------------------------------------------------------------

def bloom_filter(num_bits: int, num_hashes: int = 4) -> Monoid:
    """Bloom filter over int ids. Monoid under bitwise OR; identity = empty."""
    assert num_bits % 8 == 0

    def lift(item):
        idx = torch.stack([_uhash(item, s) % num_bits
                           for s in range(num_hashes)])
        return _one_hot_rows(idx, num_bits).any(dim=0).to(torch.uint8)

    return Monoid(
        name=f"bloom({num_bits},{num_hashes})",
        combine=_tree_binary(torch.bitwise_or),
        identity_fn=lambda *, example=None: torch.zeros(
            (num_bits,), dtype=torch.uint8,
            device=_device_of(example) if example is not None else None),
        lift=lift,
    )


def bloom_contains(filt: torch.Tensor, item, num_hashes: int = 4
                   ) -> torch.Tensor:
    num_bits = filt.shape[-1]
    idx = torch.stack([_uhash(item, s) % num_bits for s in range(num_hashes)])
    return torch.all(filt[idx.to(filt.device)] > 0)


# ---------------------------------------------------------------------------
# count-min sketch (paper §3, [Cormode & Muthukrishnan 2005])
# ---------------------------------------------------------------------------

def count_min(depth: int, width: int) -> Monoid:
    """Count-min sketch: (depth, width) counters; monoid under elementwise +."""

    def lift(item):
        # one item -> a (depth, width) one-hot increment
        idx = torch.stack([_uhash(item, d) % width for d in range(depth)])
        return _one_hot_rows(idx, width).to(torch.int32)

    return Monoid(
        name=f"cms({depth},{width})",
        combine=_tree_binary(torch.add),
        identity_fn=lambda *, example=None: torch.zeros(
            (depth, width), dtype=torch.int32,
            device=_device_of(example) if example is not None else None),
        lift=lift,
    )


def cms_query(sketch: torch.Tensor, item) -> torch.Tensor:
    depth, width = sketch.shape
    ests = torch.stack([sketch[d, (_uhash(item, d) % width).to(sketch.device)]
                        for d in range(depth)])
    return torch.min(ests)


def cms_update_batch(sketch: torch.Tensor, items: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vectorised in-mapper combine of a whole batch into the sketch, out of
    place: the ``cms_update`` CUDA kernel's int32 counts for CUDA tensors
    (its plain version for CPU tensors), added to ``sketch``."""
    from ..kernels.cms import cms_counts

    depth, width = sketch.shape
    return sketch + cms_counts(items, depth, width, weights=weights)


# ---------------------------------------------------------------------------
# HyperLogLog (paper §3, [Flajolet et al. 2007])
# ---------------------------------------------------------------------------

def _rho(v: torch.Tensor, bitwidth: int) -> torch.Tensor:
    """Position (1-based) of the leftmost 1 bit within `bitwidth` bits; 0 ->
    bitwidth+1.  (``argmax`` returns the first maximum.)"""
    shifts = torch.arange(bitwidth - 1, -1, -1, device=v.device)
    bits = (v[..., None] >> shifts) & 1
    first_one = torch.argmax(bits, dim=-1)
    any_one = (bits > 0).any(dim=-1)
    return torch.where(any_one, first_one + 1,
                       torch.full_like(first_one, bitwidth + 1)
                       ).to(torch.uint8)


def _hll_bucket_rank(items, p: int):
    suffix_bits = 32 - p
    h = _uhash(items, 7)
    return h >> suffix_bits, _rho(h & ((1 << suffix_bits) - 1), suffix_bits)


def hyperloglog(precision: int = 8) -> Monoid:
    """HLL with 2^precision registers; monoid under elementwise max."""
    p = precision
    m_regs = 1 << p

    def lift(item):
        idx, r = _hll_bucket_rank(item, p)
        return torch.where(_one_hot_rows(idx, m_regs), r,
                           torch.zeros_like(r)).to(torch.uint8)

    def extract(regs):
        if p >= 7:
            alpha = 0.7213 / (1 + 1.079 / m_regs)
        else:
            alpha = {4: 0.673, 5: 0.697, 6: 0.709}.get(
                p, 0.7213 / (1 + 1.079 / m_regs))
        z = torch.sum(torch.exp2(-regs.to(torch.float32)))
        est = alpha * m_regs * m_regs / z
        # small-range (linear counting) correction
        zeros = torch.sum(regs == 0)
        lc = m_regs * torch.log(
            m_regs / torch.clamp(zeros, min=1).to(torch.float32))
        return torch.where((est <= 2.5 * m_regs) & (zeros > 0), lc, est)

    return Monoid(
        name=f"hll(p={p})",
        combine=_tree_binary(torch.maximum),
        identity_fn=lambda *, example=None: torch.zeros(
            (m_regs,), dtype=torch.uint8,
            device=_device_of(example) if example is not None else None),
        lift=lift,
        extract=extract,
    )


def hll_update_batch(regs: torch.Tensor, items: torch.Tensor,
                     valid_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Vectorised in-mapper combine of a batch of ids into the registers,
    out of place.  ``valid_mask`` marks the items that count; invalid items
    contribute rank 0 — a no-op under the register max."""
    p = int(math.log2(regs.shape[-1]))
    idx, r = _hll_bucket_rank(items.reshape(-1), p)
    if valid_mask is not None:
        r = torch.where(valid_mask.reshape(-1).to(torch.bool), r,
                        torch.zeros_like(r))
    return regs.scatter_reduce(0, idx, r, reduce="amax", include_self=True)


# ---------------------------------------------------------------------------
# stripes — the paper's Algorithm 5 (associative arrays under elementwise sum)
# ---------------------------------------------------------------------------

# A stripe H_w is the dense count vector over the (bucketed) vocabulary for
# focus word w: associative arrays under element-wise sum are ``sum_`` on
# the dense representation.
stripes = sum_

# Gradients under element-wise sum (the weight-vector monoid of §3): the
# gradient sync collectives fold with it.
grad_sum = sum_


def stripe_of_window(window: torch.Tensor, vocab: int,
                     center: int) -> torch.Tensor:
    """Lift one context window into the stripe for its center word (Alg 5
    map): neighbour counts over the vocab (ids in [0, vocab))."""
    neigh = torch.cat([window[:center], window[center + 1:]])
    return _one_hot_rows(neigh, vocab).sum(dim=0).to(torch.int32)


def cooccurrence_stripes(tokens: torch.Tensor, vocab: int,
                         window: int) -> torch.Tensor:
    """Full (vocab, vocab) co-occurrence via stripes: pairs (w, u) with
    |pos(w) - pos(u)| <= window, counted both ways, on the ``stripes`` CUDA
    kernel for CUDA tensors (its plain version for CPU tensors).  int32."""
    from ..kernels.stripes import stripe_counts

    return stripe_counts(tokens.reshape(-1), vocab, window)


# ---------------------------------------------------------------------------
# exponential time-decay monoids — windowed analytics, cache eviction
# ---------------------------------------------------------------------------
# State = (value, anchor_time): ``value`` is the decayed aggregate as of
# ``anchor_time`` (the latest event time folded in).  combine re-anchors both
# sides to the later time and merges; re-scaling by a common exp factor
# commutes with + and max, so it is associative.  The identity anchors at
# t = -inf with value 0: its decay weight to any finite time is exactly 0,
# so it is a two-sided unit (an identity anchored at t = 0 would re-weight
# values with earlier timestamps).

def _f32_on(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _decay_weight(t_from, t_to, lam: float) -> torch.Tensor:
    """exp(-lam * (t_to - t_from)) with the convention weight(-inf -> t) = 0.

    The where() guard keeps the identity exact: exp(-inf - -inf) would be
    NaN in the untaken branch, but the literal 0.0 is selected instead.
    """
    t_from = _f32_on(t_from, t_to)
    t_to = _f32_on(t_to, t_from)
    return torch.where(torch.isneginf(t_from), torch.zeros_like(t_from),
                       torch.exp(-lam * (t_to - t_from)))


def _decay_combine(lam: float, op):
    def combine(a, b):
        (va, ta), (vb, tb) = a, b
        t = torch.maximum(_f32_on(ta, tb), _f32_on(tb, ta))
        return (op(va * _decay_weight(ta, t, lam),
                   vb * _decay_weight(tb, t, lam)), t)
    return combine


def _decay_identity(*, example=None):
    if example is None:
        return (torch.zeros(()), torch.full((), -math.inf))
    v, t = example
    return (torch.zeros_like(v),
            torch.full_like(_f32_on(t, v), -math.inf))


def _decay_monoid(name: str, half_life: float, op, lift) -> Monoid:
    if half_life <= 0:
        raise ValueError(f"half_life must be positive, got {half_life}")
    lam = math.log(2.0) / float(half_life)
    return Monoid(
        name=f"{name}(hl={half_life:g})",
        combine=_decay_combine(lam, op),
        identity_fn=_decay_identity,
        lift=lift,
        extract=lambda s: s[0],     # aggregate as of the anchor time s[1]
    )


def _decay_lift(vt):
    v, t = vt
    return (_f32_on(v), _f32_on(t))


def decayed_sum(half_life: float) -> Monoid:
    """Exponentially-decayed sum: fold (value, time) events; the state is
    the decayed total as of the newest event.  half_life in time units."""
    return _decay_monoid("decayed_sum", half_life, torch.add, _decay_lift)


def decayed_count(half_life: float) -> Monoid:
    """Decayed event count: :func:`decayed_sum` with lift (t) -> (1, t) — a
    rate estimator (events per recent half-life window)."""
    return _decay_monoid(
        "decayed_count", half_life, torch.add,
        lambda t: (torch.ones_like(_f32_on(t)), _f32_on(t)))


def decayed_lru(half_life: float) -> Monoid:
    """Decayed-LRU score: max over accesses of the decayed access weight —
    the cache-eviction score (recency with smooth aging).  Access weights
    must be non-negative (0 is the identity value)."""
    return _decay_monoid(
        "decayed_lru", half_life, torch.maximum,
        lambda vt: (torch.clamp(_f32_on(vt[0]), min=0.0), _f32_on(vt[1])))


def decayed_value(state, t, half_life: float) -> torch.Tensor:
    """Re-anchor a decay-monoid state to query time ``t`` (extract-at-t)."""
    v, ts = state
    lam = math.log(2.0) / float(half_life)
    return v * _decay_weight(ts, _f32_on(t, ts), lam)


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------

def product(**named: Monoid) -> Monoid:
    """Product monoid over a dict of monoids — one fold for many stats."""
    names = sorted(named)

    def combine(a, b):
        return {k: named[k].combine(a[k], b[k]) for k in names}

    def identity_fn(*, example=None):
        if example is None:
            return {k: named[k].identity() for k in names}
        return {k: named[k].identity_like(example[k]) for k in names}

    def lift(x):
        return {k: named[k].lift(x[k]) for k in names}

    def extract(m):
        return {k: named[k].extract(m[k]) for k in names}

    return Monoid(
        name="product(" + ",".join(f"{k}={named[k].name}" for k in names) + ")",
        combine=combine,
        identity_fn=identity_fn,
        lift=lift,
        extract=extract,
        commutative=all(named[k].commutative for k in names),
    )


def cache_stats(half_life: float) -> Monoid:
    """Per-node prefix-cache bookkeeping, folded as ONE monoid: hit counts
    and resident bytes (additive) and the :func:`decayed_lru` eviction
    score in one :func:`product` value, so the radix prefix cache's whole
    bookkeeping (``runtime/prefix_cache.py``) is one keyed ``execute_fold``
    per engine step, keyed by trie-node id."""
    m = product(bytes=sum_, hits=sum_, score=decayed_lru(half_life))
    return dataclasses.replace(m, name=f"cache_stats(hl={half_life:g})")


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
register_monoid(prod, lambda: [_f32(s) * 0.5 + 1.0 for s in (0, 1, 2)])
register_monoid(welford, lambda: [
    (torch.tensor(float(n)), _f32(n, ()), torch.abs(_f32(n + 10, ())))
    for n in (1, 2, 3)])
register_monoid(logsumexp, lambda: [
    (_f32(s, ()), torch.abs(_f32(s + 20, ())) + 0.1) for s in (0, 1, 2)])
register_monoid(attn_state, lambda: [
    (_f32(s, ()), torch.abs(_f32(s + 30, ())) + 0.1, _f32(s + 40, (4,)))
    for s in (0, 1, 2)])
register_monoid(affine_scan, lambda: [(_f32(s) * 0.5 + 1.0, _f32(s + 50))
                                      for s in (0, 1, 2)])
register_monoid(top_k(4), lambda: [
    top_k(4).lift((torch.tensor(v, dtype=torch.float32),
                   torch.tensor(i, dtype=torch.int32)))
    for v, i in ((3.0, 7), (1.5, 2), (9.0, 5))])
register_monoid(bloom_filter(64, 2), lambda: [
    bloom_filter(64, 2).lift(torch.tensor(x, dtype=torch.int32))
    for x in (3, 11, 42)])
register_monoid(count_min(2, 32), lambda: [
    count_min(2, 32).lift(torch.tensor(x, dtype=torch.int32))
    for x in (3, 11, 42)])
register_monoid(hyperloglog(4), lambda: [
    hyperloglog(4).lift(torch.tensor(x, dtype=torch.int32))
    for x in (3, 11, 42)])

# decay monoids: samples are post-lift (value, anchor_time) states with
# DISTINCT finite times, a negative one included, so a broken identity
# anchored at t = 0 cannot slip through the law suite
register_monoid(decayed_sum(16.0), lambda: [
    (_f32(s, ()), torch.tensor(t, dtype=torch.float32))
    for s, t in ((0, -3.0), (1, 2.5), (2, 7.0))])
register_monoid(decayed_count(16.0), lambda: [
    (torch.abs(_f32(s, ())) + 1.0, torch.tensor(t, dtype=torch.float32))
    for s, t in ((3, -1.0), (4, 4.0), (5, 9.5))])
register_monoid(decayed_lru(16.0), lambda: [
    (torch.abs(_f32(s, ())), torch.tensor(t, dtype=torch.float32))
    for s, t in ((6, -2.0), (7, 3.0), (8, 8.0))])
# the prefix-cache stats product: the additive hit / byte columns with the
# decayed-LRU score column, again at distinct finite anchor times
register_monoid(cache_stats(32.0), lambda: [
    {"bytes": torch.abs(_f32(s, ())) * 1e3,
     "hits": torch.abs(_f32(s + 10, ())),
     "score": (torch.abs(_f32(s + 20, ())),
               torch.tensor(t, dtype=torch.float32))}
    for s, t in ((11, -4.0), (12, 1.5), (13, 6.0))])
