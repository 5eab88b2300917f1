"""Gradient compression with error feedback (EF14-style), and the lossy
monoids that let compressed representations ride the planner's folds: the
port of the JAX package's ``optim/compress.py``.

Three compressors cut the bytes a gradient puts on a slow wire:

* ``topk``      -- keep the k largest-|g| entries per leaf (values + int32
  idx);
* ``blocktopk`` -- keep the largest-|g| entry of each contiguous block (the
  same sparse representation, one argmax pass instead of a sort);
* ``int8``      -- per-leaf symmetric scale quantisation.

All use error feedback: ``e_{t+1} = (g + e_t) - decompress(compress(g +
e_t))``, so the sum over steps of the applied updates converges to the sum
of the true gradients.  The residual is taken against what the receiver
applies, including the cast back to the parameter dtype, so EF stays exact
for bf16 parameters.

The compressed representations combine as monoids, registered in the
port's registry with the JAX package's law samples:
:func:`topk_sparse_monoid` (concatenate + re-top-k at a fixed capacity) and
:func:`int8_sum_monoid` (dequantise-add-requantise).  :class:`LossySpec`
parses ``"topk:0.01"`` / ``"blocktopk:0.001"`` / ``"int8"`` into
compress / decompress / wire-byte accounting.

Selections follow ``jax.lax.top_k`` and ``jnp.argmax``: the largest first,
ties to the lower index (a stable descending sort; ``torch.argmax``'s first
maximum), so indices and int8 codes agree with the JAX package bit for bit.
Dicts are built with their keys in sorted order, the order in which JAX
flattens them, so the two packages' leaves line up.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.monoid import Monoid
from ..core.monoids import register_monoid

Pytree = Any

LOSSY_METHODS = ("topk", "blocktopk", "int8")


def _is_comp(x) -> bool:
    return isinstance(x, dict) and ("values" in x or "q" in x)


def init_error_state(params: Pytree) -> Pytree:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _clamp_k(size: int, ratio: float) -> int:
    """k for a leaf of ``size`` entries: never 0, never more than the leaf
    holds."""
    return max(1, min(int(size * ratio), size))


def _block_shape(size: int, ratio: float) -> Tuple[int, int]:
    """(num_blocks k, block length) for blocktopk: one survivor per block."""
    blk = max(1, int(round(1.0 / max(ratio, 1e-12))))
    blk = min(blk, size)
    return -(-size // blk), blk          # ceil(size / blk), blk


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-d ``x``, largest first, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _ef_residual(acc: torch.Tensor, idx: torch.Tensor, kept: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Residual of ``acc`` after the receiver applies ``kept`` at ``idx``,
    cast to ``out_dtype`` (the parameter dtype) as the receiver casts it."""
    applied = kept.to(out_dtype).to(torch.float32)
    new = acc.clone()
    new[idx] = acc[idx] - applied
    return new


def _per_leaf(one, grads: Pytree, error: Pytree) -> Tuple[Pytree, Pytree]:
    leaves, spec = pytree.tree_flatten(grads)
    outs = [one(g, e) for g, e in zip(leaves, pytree.tree_leaves(error))]
    return (pytree.tree_unflatten([o[0] for o in outs], spec),
            pytree.tree_unflatten([o[1] for o in outs], spec))


# -- top-k ---------------------------------------------------------------------

def topk_compress(grads: Pytree, error: Pytree, *, ratio: float = 0.01
                  ) -> Tuple[Pytree, Pytree]:
    """-> (sparse {idx, size, values} per leaf, new error state)."""
    def one(g, e):
        acc = g.to(torch.float32).reshape(-1) + e.reshape(-1)
        k = _clamp_k(acc.numel(), ratio)
        idx = _top_k(torch.abs(acc), k)
        kept = acc[idx]
        new_e = _ef_residual(acc, idx, kept, g.dtype).reshape(e.shape)
        return {"idx": idx.to(torch.int32), "size": acc.numel(),
                "values": kept}, new_e
    return _per_leaf(one, grads, error)


def blocktopk_compress(grads: Pytree, error: Pytree, *, ratio: float = 0.01
                       ) -> Tuple[Pytree, Pytree]:
    """Top-1-per-block selection, the O(n) top-k for huge leaves: the same
    sparse {idx, size, values} representation as :func:`topk_compress`,
    the survivors the largest-|g| entry of each contiguous block of
    ~1/ratio entries."""
    def one(g, e):
        acc = g.to(torch.float32).reshape(-1) + e.reshape(-1)
        size = acc.numel()
        k, blk = _block_shape(size, ratio)
        padded = torch.nn.functional.pad(acc, (0, k * blk - size)
                                         ).reshape(k, blk)
        j = torch.argmax(torch.abs(padded), dim=1)
        kept = padded.gather(1, j[:, None])[:, 0]
        idx = torch.clamp(torch.arange(k, device=acc.device) * blk + j,
                          max=size - 1)
        new_e = _ef_residual(acc, idx, kept, g.dtype).reshape(e.shape)
        return {"idx": idx.to(torch.int32), "size": size,
                "values": kept}, new_e
    return _per_leaf(one, grads, error)


def topk_decompress(comp: Pytree, like: Pytree) -> Pytree:
    def one(c, g):
        flat = torch.zeros((c["size"],), dtype=torch.float32,
                           device=c["values"].device)
        flat.index_put_((c["idx"].long(),), c["values"], accumulate=True)
        return flat.reshape(g.shape).to(g.dtype)
    cl = pytree.tree_flatten(comp, is_leaf=_is_comp)[0]
    gl, spec = pytree.tree_flatten(like)
    return pytree.tree_unflatten([one(c, g) for c, g in zip(cl, gl)], spec)


# -- int8 ----------------------------------------------------------------------

def int8_compress(grads: Pytree, error: Pytree) -> Tuple[Pytree, Pytree]:
    def one(g, e):
        acc = g.to(torch.float32) + e
        scale = torch.clamp(torch.max(torch.abs(acc)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(acc / scale), -127, 127).to(torch.int8)
        # residual vs what the receiver applies AFTER casting to g.dtype
        applied = (q.to(torch.float32) * scale).to(g.dtype).to(torch.float32)
        return {"q": q, "scale": scale}, acc - applied
    return _per_leaf(one, grads, error)


def int8_decompress(comp: Pytree, like: Pytree) -> Pytree:
    cl = pytree.tree_flatten(comp, is_leaf=_is_comp)[0]
    gl, spec = pytree.tree_flatten(like)
    return pytree.tree_unflatten(
        [(c["q"].to(torch.float32) * c["scale"]).to(g.dtype)
         for c, g in zip(cl, gl)], spec)


def compressed_bytes(comp: Pytree) -> int:
    """Bytes of the compressed leaves (the python-int ``size`` metadata is
    not counted)."""
    return int(sum(t.numel() * t.element_size()
                   for t in pytree.tree_leaves(comp)
                   if isinstance(t, torch.Tensor)))


# ---------------------------------------------------------------------------
# lossy monoids: the compressed representations ARE monoid values
# ---------------------------------------------------------------------------

def _sparse_key(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Selection key for re-top-k: |value|, padding (idx < 0) at -inf so
    real entries always out-rank unused capacity."""
    return torch.where(idx < 0, -math.inf, torch.abs(vals))


def _sparse_canon(s) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical (values, idx) order: by idx, then value (``jnp.lexsort``),
    so entry multisets compare equal whichever bracketing made them."""
    order = torch.sort(s["values"], stable=True).indices
    order = order[torch.sort(s["idx"][order], stable=True).indices]
    return s["values"][order], s["idx"][order]


def topk_sparse_monoid(k: int) -> Monoid:
    """Fixed-capacity sparse gradients under concatenate + re-top-k.

    Values are ``{"idx": (k,) int32, "values": (k,) float32}`` with idx -1
    marking unused capacity.  Combining keeps the k largest-|value|
    entries of the union; duplicate indices stay separate entries (densify
    with scatter-ADD, so the fold is still a sum).  Exact while the real
    entries fit in k; beyond that lossy, which error feedback recovers.
    """
    def combine(a, b):
        v = torch.cat([a["values"], b["values"]], dim=-1)
        i = torch.cat([a["idx"], b["idx"]], dim=-1)
        pick = _top_k(_sparse_key(v, i), k)
        return {"idx": i[pick], "values": v[pick]}

    def identity_fn(*, example=None):
        return {"idx": torch.full((k,), -1, dtype=torch.int32),
                "values": torch.zeros((k,), dtype=torch.float32)}

    def approx_equal(a, b):
        va, ia = _sparse_canon(a)
        vb, ib = _sparse_canon(b)
        return bool(torch.equal(ia, ib)
                    and torch.allclose(va, vb, rtol=1e-5, atol=1e-6))

    return Monoid(name=f"lossy_topk{k}", combine=combine,
                  identity_fn=identity_fn, approx_equal=approx_equal)


def int8_sum_monoid() -> Monoid:
    """Quantised tensors under dequantise-add-requantise.

    Values are ``{"q": int8, "scale": float32 ()}``.  Associative up to
    one quantisation step per combine; ``approx_equal`` compares the
    dequantised tensors within a tolerance set by the operand scales.  The
    identity (q = 0, scale = 0) is exact.
    """
    def deq(s):
        return s["q"].to(torch.float32) * s["scale"]

    def combine(a, b):
        total = deq(a) + deq(b)
        scale = torch.clamp(torch.max(torch.abs(total)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(total / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}

    def identity_fn(*, example=None):
        if example is None:
            raise ValueError("int8_sum_monoid identity needs an example "
                             "(shape-polymorphic); use identity_like")
        return {"q": torch.zeros_like(example["q"]),
                "scale": torch.zeros_like(example["scale"])}

    def approx_equal(a, b):
        atol = 2.0 * float(a["scale"] + b["scale"]) + 1e-6
        return bool(torch.allclose(deq(a), deq(b), rtol=0.0, atol=atol))

    return Monoid(name="lossy_int8", combine=combine, identity_fn=identity_fn,
                  approx_equal=approx_equal)


def _lossy_topk_samples():
    m = topk_sparse_monoid(8)

    def entry(vals, idxs):
        s = m.identity()
        s["values"][:2] = torch.tensor(vals, dtype=torch.float32)
        s["idx"][:2] = torch.tensor(idxs, dtype=torch.int32)
        return s
    # 2 entries per sample, 6 <= capacity 8: the law check runs in the
    # EXACT regime (truncation loss is EF's job, not associativity's)
    return [entry((3.0, -1.5), (7, 2)), entry((0.25, 4.0), (1, 5)),
            entry((-2.0, 0.75), (9, 0))]


def _lossy_int8_samples():
    out = []
    for seed in (0, 1, 2):
        x = torch.from_numpy(np.random.default_rng(seed).normal(size=(16,))
                             .astype(np.float32))
        comp, _ = int8_compress(x, torch.zeros_like(x))
        out.append(comp)
    return out


register_monoid(topk_sparse_monoid(8), _lossy_topk_samples)
register_monoid(int8_sum_monoid(), _lossy_int8_samples)


# ---------------------------------------------------------------------------
# LossySpec -- the planner-facing annotation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LossySpec:
    """A parsed ``lossy=`` annotation: which compressor, how aggressive.

    Accepted spellings (``LossySpec.parse``): ``"topk:0.01"``,
    ``"blocktopk:0.001"``, ``"int8"``, or an existing LossySpec.
    """

    method: str
    ratio: float = 0.01

    def __post_init__(self):
        if self.method not in LOSSY_METHODS:
            raise ValueError(f"unknown lossy method {self.method!r}; "
                             f"expected one of {LOSSY_METHODS}")
        if not (0.0 < self.ratio <= 1.0):
            raise ValueError(f"lossy ratio must be in (0, 1]; got {self.ratio}")

    @classmethod
    def parse(cls, spec) -> "LossySpec":
        if isinstance(spec, LossySpec):
            return spec
        if not isinstance(spec, str):
            raise TypeError(f"lossy= expects a string or LossySpec; got "
                            f"{type(spec).__name__}")
        method, _, arg = spec.partition(":")
        if method == "int8":
            return cls(method="int8", ratio=1.0)
        return cls(method=method, ratio=float(arg) if arg else 0.01)

    def describe(self) -> str:
        if self.method == "int8":
            return "int8"
        return f"{self.method}:{self.ratio:g}"

    # -- compress / decompress ------------------------------------------------
    def compress(self, grads: Pytree, error: Optional[Pytree] = None
                 ) -> Tuple[Pytree, Pytree]:
        if error is None:
            error = init_error_state(grads)
        if self.method == "topk":
            return topk_compress(grads, error, ratio=self.ratio)
        if self.method == "blocktopk":
            return blocktopk_compress(grads, error, ratio=self.ratio)
        return int8_compress(grads, error)

    def decompress(self, comp: Pytree, like: Pytree) -> Pytree:
        if self.method == "int8":
            return int8_decompress(comp, like)
        return topk_decompress(comp, like)

    # -- byte accounting (shape-only; works on meta tensors) ------------------
    def leaf_wire_bytes(self, size: int) -> int:
        if self.method == "int8":
            return size * 1 + 4
        if self.method == "blocktopk":
            k, _ = _block_shape(size, self.ratio)
        else:
            k = _clamp_k(size, self.ratio)
        return k * 8          # f32 value + i32 index per survivor

    def wire_bytes(self, like: Pytree) -> int:
        return int(sum(self.leaf_wire_bytes(int(math.prod(leaf.shape)) or 1)
                       for leaf in pytree.tree_leaves(like)))
