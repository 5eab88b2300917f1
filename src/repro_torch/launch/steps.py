"""Step builders: the port of the JAX package's ``launch/steps.py``.

The JAX package jit-compiles its steps with explicit shardings for a mesh.
The port's steps are eager functions: the train step runs on one device,
or with ``mesh=`` on a mesh's ranks, as the prefill and decode steps do,
each rank on its own blocks.  The sharding helpers give the same specs as
the reference's ``NamedSharding``s, as tuples (``dist/sharding.py``): a
:class:`BuiltStep` carries them, the step's global argument shapes on the
meta device (the dry run's) and :meth:`BuiltStep.local`, which cuts
global arguments to this rank's blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..configs import ShapeCell, context_spec, input_specs
from ..core.aggregation import grad_accum_fold
from ..dist import sharding as shd
from ..dist.collectives import grad_sync, metrics_sync
from ..models import (ModelConfig, RunCtx, decode_step, forward, init_cache,
                      loss_fn, unembed)
from ..models.common import CACHE_AXES
from ..models.convert import from_jax_layout, to_jax_layout
from ..models.moe import _divisible_batch_axes
from ..models.transformer import param_shapes
from ..optim import OptConfig, adamw_update, opt_state_shapes
from ..optim.compress import LossySpec

Pytree = Any

trim_rules = shd.trim_rules  # canonical definition lives in dist.sharding


# ---------------------------------------------------------------------------
# sharding helpers (specs as tuples: dist.sharding.spec_for's)
# ---------------------------------------------------------------------------

def batch_sharding(mesh, rules, dim0: Optional[int] = None) -> Tuple:
    """Batch-dim spec, dropping axes that don't divide dim0 (e.g. B=1)."""
    ax = rules.get("batch")
    axes = (ax,) if isinstance(ax, str) else tuple(ax or ())
    if dim0 is not None:
        axes = _divisible_batch_axes(mesh, axes, dim0)
    return (axes if len(axes) > 1 else axes[0],) if axes else ()


def data_shardings(cfg: ModelConfig, mesh, rules, specs: Dict) -> Dict:
    """Specs of the data inputs (tokens / labels / context): batch-cut."""
    return {k: batch_sharding(mesh, rules, v.shape[0])
            for k, v in specs.items()}


def cache_shardings(cache_shapes: Pytree, mesh, rules) -> Pytree:
    """The spec of every leaf of a decode cache, by leaf name (see
    ``models.common.CACHE_AXES``, by which the model allocates them; the
    port's cache is per layer, so no leaf carries the
    reference's stacked period dim).  A per-slot ``pos`` follows the
    batch."""
    def one(name, leaf):
        names = CACHE_AXES.get(name, ())
        if name == "pos" and leaf.dim() == 1:
            names = ("batch",)
        return shd.spec_for(names, rules, mesh, shape=tuple(leaf.shape))

    return {"pos": one("pos", cache_shapes["pos"]),
            "layers": [{n: one(n, t) for n, t in layer.items()}
                       for layer in cache_shapes["layers"]]}


def replicated(mesh) -> Tuple:
    """The spec of a replicated value."""
    return ()


@dataclasses.dataclass(frozen=True)
class BuiltStep:
    """A step on this rank's blocks + everything needed to call it: the
    global argument trees on the meta device (``abstract_args``), their
    specs (``in_shardings``; tuple leaves) and the output's, the mesh, the
    trimmed rules and the ``RunCtx`` the step runs with."""
    fn: Any
    abstract_args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    mesh: Any
    rules: Dict[str, Any]
    ctx: Any = None

    def local(self, *args) -> Tuple:
        """Global arguments -> this rank's blocks, per ``in_shardings``."""
        def cut(tree, specs):
            if isinstance(tree, dict):
                return {k: cut(v, specs[k]) for k, v in tree.items()}
            if isinstance(tree, list):
                return [cut(v, sp) for v, sp in zip(tree, specs)]
            return shd.block_of(tree, specs, self.mesh)
        return tuple(cut(a, sp) for a, sp in zip(args, self.in_shardings))


def _step_ctx(cfg, mesh, rules, ctx, B: int) -> RunCtx:
    ctx = ctx or RunCtx(mesh=mesh)
    if ctx.mesh is None:
        ctx = dataclasses.replace(ctx, mesh=mesh)
    batch = batch_sharding(mesh, rules, B)
    axes = shd._axes_tuple(batch[0]) if batch else ()
    return dataclasses.replace(ctx, batch_axes=axes)


def _grad_fn(cfg: ModelConfig, ctx: RunCtx) -> Callable:
    """``(params, batch) -> (metrics, grads)``: ``loss_fn``'s metrics
    (detached) and the gradient of its mean loss w.r.t. every parameter
    leaf, in the leaf's dtype (zeros for a leaf the loss does not reach)."""
    def loss_and_grad(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        req = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(pytree.tree_unflatten(req, spec), cfg,
                                    batch, ctx)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, req)]
        return ({k: v.detach() for k, v in metrics.items()},
                pytree.tree_unflatten(grads, spec))
    return loss_and_grad


def _split_microbatches(batch: Dict, n: int) -> Dict:
    B = batch["tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    return {k: v.reshape((n, B // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _lossy(spec: LossySpec, cfg: ModelConfig, grads: Pytree, ef: Pytree,
           each_leaf=None, mesh=None):
    """(the compressor round trip of ``grads``, the new residual), per JAX
    leaf: the compressors select and scale per leaf, and a JAX leaf stacks
    a layer slot over its periods, so they run in that layout.  Under a
    mesh (``each_leaf`` walks a tree with its leaves' specs) each leaf is
    gathered whole first and this rank's block of each result kept."""
    if mesh is not None:
        grads, ef = (each_leaf(lambda t, sp: shd.gather_leaf(t, sp, mesh),
                               tree) for tree in (grads, ef))
    stacked = to_jax_layout(grads, cfg)
    comp, new_ef = spec.compress(stacked, to_jax_layout(ef, cfg))
    out = (from_jax_layout(spec.decompress(comp, stacked), cfg, grads),
           from_jax_layout(new_ef, cfg, ef))
    if mesh is not None:
        out = tuple(each_leaf(lambda t, sp: shd.block_of(t, sp, mesh), tree)
                    for tree in out)
    return out


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    opt: OptConfig = OptConfig(),
                    ctx: Optional[RunCtx] = None,
                    num_microbatches: int = 1,
                    lossy: Optional[str] = None,
                    model_parallel: int = 1,
                    shape: Optional[ShapeCell] = None,
                    rules: Optional[Dict[str, Any]] = None):
    """The train step ``(params, opt_state, batch) -> (new bf16 params, new
    opt state, metrics)`` for ``cfg`` on the parameters' device.

    ``num_microbatches > 1`` splits the batch's leading axis and folds the
    gradients over the microbatches with :func:`grad_accum_fold` -- the
    paper's in-mapper combining (Algorithm 4) over the gradient Sum monoid,
    one microbatch's gradients live at a time -- then scales the sum by
    ``1 / num_microbatches``.

    ``lossy`` (``"topk:0.01"`` / ``"blocktopk:0.001"`` / ``"int8"``)
    applies the compressor a cross-pod wire would: the update consumes the
    compressed round trip of the folded gradients, and the error-feedback
    residual is carried as ``opt_state["ef"]`` (``init_opt_state(...,
    with_ef=True)``), which checkpoints with the optimizer.  The
    compressors run on the JAX package's stacked layout
    (``models.convert.to_jax_layout``), where one leaf holds a layer slot
    over every period, so top-k, block top-k and the int8 scale select and
    scale over the same entries as the JAX package's.

    ``metrics`` is ``loss_fn``'s Sum-monoid dict plus ``lr``, ``grad_norm``
    and ``loss = loss_sum / max(tokens, 1)``.

    Without ``mesh`` the step is a function on one device.  With a
    ``DeviceMesh`` it is a :class:`BuiltStep` whose ``fn`` each rank calls
    on its blocks (``local`` cuts global arguments): the parameters and the
    optimizer state cut by ``TRAIN_RULES`` (trimmed to the mesh), the batch
    (a context arch's ``context`` too) by :func:`batch_sharding`; every
    family trains so.  Each rank folds the gradients of its rows over its
    microbatches, then ``grad_sync`` sums them over the batch axes, once a
    step, and ``metrics_sync`` sums the Sum-monoid metrics, so
    ``loss``, ``grad_norm``, ``tokens`` and ``correct`` are the global
    values on every rank; the global norm psums the cut leaves' squares
    over ``model`` and counts a replicated leaf once.  ``lossy`` takes the
    round trip of the synced gradient: each leaf's blocks are gathered over
    the axes it is cut over, every rank compresses the whole leaf
    identically (top-k's selection and int8's scale span the leaf, as the
    JAX package's do), and each keeps its block of the result and of the
    residual.  ``model_parallel > 1`` needs ``mesh`` (e.g.
    ``launch.mesh.make_host_mesh(model=...)`` in a bound world).
    """
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1; got "
                         f"{num_microbatches}")
    spec = None if lossy is None else LossySpec.parse(lossy)
    if mesh is None:
        if model_parallel != 1:
            raise ValueError(
                f"model_parallel={model_parallel} cuts the weights over a "
                "mesh: pass mesh= (launch.mesh.make_host_mesh(model=...) "
                "in a bound world)")
        return _step_fn(cfg, opt, ctx or RunCtx(), num_microbatches, spec)
    return _mesh_train_step(cfg, mesh, opt, ctx, num_microbatches, spec,
                            shape, rules)


def _step_fn(cfg, opt, ctx, num_microbatches, spec, mesh=None,
             pshard=None):
    """The train step's body.  Under a mesh (``pshard``: the parameters'
    specs) the gradients and the metrics are summed over
    ``ctx.batch_axes`` after the microbatch fold, ``lossy`` works on the
    gathered leaves and the global norm knows each leaf's cut."""
    loss_and_grad = _grad_fn(cfg, ctx)

    def each_leaf(fn, *trees):
        return shd._walk(fn, *trees, pshard)

    def train_step(params, opt_state, batch):
        if num_microbatches > 1:
            metrics, grads = grad_accum_fold(
                loss_and_grad, params,
                _split_microbatches(batch, num_microbatches))
            gscale = 1.0 / num_microbatches
        else:
            metrics, grads = loss_and_grad(params, batch)
            gscale = 1.0
        norm_axes = None
        if mesh is not None:
            grads = grad_sync(grads, mesh, ctx.batch_axes)
            metrics = metrics_sync(metrics, mesh, ctx.batch_axes)
            # per leaf in the order tree_leaves(grads) meets them (the
            # caller's key order, which need not be the specs')
            norm_axes = []
            each_leaf(lambda t, sp: norm_axes.append(_spec_axes(sp)), grads)
        if spec is not None:
            grads, new_ef = _lossy(spec, cfg, grads, opt_state["ef"],
                                   each_leaf, mesh)
            opt_state = {k: v for k, v in opt_state.items() if k != "ef"}
        new_params, new_opt, om = adamw_update(
            grads, opt_state, opt, grad_scale=gscale, norm_axes=norm_axes)
        if spec is not None:
            new_opt["ef"] = new_ef
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = metrics["loss_sum"] / torch.clamp(
            metrics["tokens"], min=1.0)
        return new_params, new_opt, metrics

    return train_step


def _spec_axes(spec: Tuple) -> Tuple[str, ...]:
    """Every mesh axis a leaf's spec cuts over."""
    return tuple(a for e in spec for a in shd._axes_tuple(e))


def _mesh_train_step(cfg, mesh, opt, ctx, num_microbatches, spec, shape,
                     rules) -> "BuiltStep":
    rules = trim_rules(rules or shd.TRAIN_RULES, mesh)
    ctx = _step_ctx(cfg, mesh, rules, ctx,
                    None if shape is None else shape.global_batch)
    # a batch axis of size 1 sums nothing: no collective on it
    sizes = shd.mesh_sizes(mesh)
    ctx = dataclasses.replace(ctx, batch_axes=tuple(
        a for a in ctx.batch_axes if sizes[a] > 1))
    pshapes, pshard = _param_specs(cfg, mesh, rules)
    body = _step_fn(cfg, opt, ctx, num_microbatches, spec, mesh, pshard)

    def train_step(params, opt_state, batch):
        with shd.use_rules(mesh, rules):
            return body(params, opt_state, batch)

    oshapes = opt_state_shapes(pshapes, with_ef=spec is not None)
    oshard = {"step": replicated(mesh), "m": pshard, "v": pshard,
              "master": pshard}
    if spec is not None:
        oshard["ef"] = pshard
    if shape is not None:
        specs = input_specs(cfg, shape)
        bshard = data_shardings(cfg, mesh, rules, specs)
    else:
        specs = None
        keys = ("tokens", "labels") + (
            ("context",) if context_spec(cfg, 1) is not None else ())
        bshard = {k: batch_sharding(mesh, rules) for k in keys}
    return BuiltStep(fn=train_step, abstract_args=(pshapes, oshapes, specs),
                     in_shardings=(pshard, oshard, bshard),
                     out_shardings=(pshard, oshard, replicated(mesh)),
                     mesh=mesh, rules=rules, ctx=ctx)


# ---------------------------------------------------------------------------
# prefill / decode steps
# ---------------------------------------------------------------------------

def _param_specs(cfg, mesh, rules):
    from ..models.transformer import param_axes
    pshapes = param_shapes(cfg)
    return pshapes, shd.param_shardings(pshapes, param_axes(cfg), mesh, rules)


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeCell, *,
                      ctx: Optional[RunCtx] = None,
                      rules: Optional[Dict[str, Any]] = None) -> BuiltStep:
    """Inference prefill: full-sequence forward + last-token logits.
    ``fn(params, batch)`` takes this rank's blocks (the batch, and a
    context arch's ``context``, cut over the ``batch`` rule's axes) and
    returns its rows' (B, 1, V) float32 logits."""
    rules = trim_rules(rules or shd.SERVE_RULES, mesh)
    ctx = _step_ctx(cfg, mesh, rules, ctx, shape.global_batch)

    def prefill_step(params, batch):
        with shd.use_rules(mesh, rules):
            h = forward(params, cfg, batch["tokens"],
                        context=batch.get("context"), ctx=ctx)
            return unembed(params, cfg, h[:, -1:])

    pshapes, pshard = _param_specs(cfg, mesh, rules)
    specs = input_specs(cfg, shape)
    bshard = data_shardings(cfg, mesh, rules, specs)
    oshard = batch_sharding(mesh, rules, shape.global_batch)
    return BuiltStep(fn=prefill_step, abstract_args=(pshapes, specs),
                     in_shardings=(pshard, bshard), out_shardings=oshard,
                     mesh=mesh, rules=rules, ctx=ctx)


def make_decode_step(cfg: ModelConfig, mesh, shape: ShapeCell, *,
                     ctx: Optional[RunCtx] = None,
                     rules: Optional[Dict[str, Any]] = None) -> BuiltStep:
    """One-token decode against a ``seq_len`` KV cache (the serve step):
    ``fn(params, cache, tokens)`` takes this rank's blocks and returns its
    rows' ((B, 1, V) float32 logits, cache), the cache written in place.

    ``ctx.decode_impl='flash'`` runs the sequence-sharded flash decode
    (the ``attn_state`` monoid over ``model``): the cache's rows are cut
    over ``model`` and the attention weights stay whole there (the rules'
    ``kv_seq`` is set to ``model``, ``heads`` / ``kv_heads`` to None),
    where the JAX package reshards its cache inside ``shard_map``; a
    recurrent state stays cut by its channels or heads.  A context arch's
    cache holds the projected context (``xk`` / ``xv``, cut by KV heads):
    ``abstract_args`` carry their shapes for ``context_spec(cfg, B)``, and
    :func:`make_cache` builds them from a context."""
    rules = dict(rules or shd.SERVE_RULES)
    if ctx is not None and ctx.decode_impl == "flash":
        rules.update(kv_seq="model", heads=None, kv_heads=None)
    rules = trim_rules(rules, mesh)
    B, S = shape.global_batch, shape.seq_len
    ctx = _step_ctx(cfg, mesh, rules, ctx, B)

    def serve_step(params, cache, tokens):
        with shd.use_rules(mesh, rules):
            return decode_step(params, cfg, cache, tokens, ctx=ctx)

    pshapes, pshard = _param_specs(cfg, mesh, rules)
    cache_shapes = init_cache(pshapes, cfg, B, S,
                              context=context_spec(cfg, B))
    cshard = cache_shardings(cache_shapes, mesh, rules)
    tok_spec = torch.empty((B, 1), dtype=torch.int32, device="meta")
    tshard = batch_sharding(mesh, rules, B)
    return BuiltStep(fn=serve_step,
                     abstract_args=(pshapes, cache_shapes, tok_spec),
                     in_shardings=(pshard, cshard, tshard),
                     out_shardings=(tshard, cshard), mesh=mesh, rules=rules,
                     ctx=ctx)


def make_cache(built: BuiltStep, cfg: ModelConfig, params: Pytree,
               batch: int, max_seq: int,
               context: Optional[torch.Tensor] = None) -> Pytree:
    """This rank's decode cache for a :func:`make_decode_step` step:
    ``batch`` is this rank's block of the global batch, ``max_seq`` the
    global length (the step's rules cut the rows for the flash decode);
    ``context`` (a context arch's) is this rank's rows of it, encoded and
    projected into the rank's ``xk`` / ``xv``."""
    with shd.use_rules(built.mesh, built.rules):
        return init_cache(params, cfg, batch, max_seq, context=context,
                          ctx=built.ctx)


def build_step(cfg: ModelConfig, mesh, shape: ShapeCell, **kw) -> BuiltStep:
    """Dispatch on the cell kind."""
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape=shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape, **kw)
    if shape.kind == "decode":
        return make_decode_step(cfg, mesh, shape, **kw)
    raise ValueError(shape.kind)
