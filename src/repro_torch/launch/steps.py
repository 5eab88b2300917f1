"""The train step on one device: the port of ``make_train_step`` of the JAX
package's ``launch/steps.py``.

The JAX package jit-compiles its steps with explicit shardings for a mesh;
the port runs eagerly on one device, so the step is a plain function.  A
mesh, ``model_parallel > 1`` and the dry run wait for the mesh tier's model
half (ROADMAP §1 item 4).  The prefill and decode steps of that file are not
ported: the port's engine (``runtime/engine.py``) runs them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..core.aggregation import grad_accum_fold
from ..models import ModelConfig, RunCtx, loss_fn
from ..models.convert import from_jax_layout, to_jax_layout
from ..optim import OptConfig, adamw_update
from ..optim.compress import LossySpec

Pytree = Any
_MESH_TODO = ("needs the mesh tier's model half, the next slice of the port "
              "(ROADMAP §1 item 4)")


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


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    opt: OptConfig = OptConfig(),
                    ctx: Optional[RunCtx] = None,
                    num_microbatches: int = 1,
                    lossy: Optional[str] = None,
                    model_parallel: int = 1
                    ) -> Callable[[Pytree, Dict, Dict],
                                  Tuple[Pytree, Dict, Dict]]:
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
    """
    if mesh is not None or model_parallel != 1:
        raise NotImplementedError(f"make_train_step(mesh=, model_parallel>1) "
                                  f"{_MESH_TODO}")
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1; got "
                         f"{num_microbatches}")
    ctx = ctx or RunCtx()
    spec = None if lossy is None else LossySpec.parse(lossy)
    loss_and_grad = _grad_fn(cfg, ctx)

    def train_step(params, opt_state, batch):
        if num_microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % num_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{num_microbatches} microbatches")
            mbatch = {k: v.reshape((num_microbatches, B // num_microbatches)
                                   + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            metrics, grads = grad_accum_fold(loss_and_grad, params, mbatch)
            gscale = 1.0 / num_microbatches
        else:
            metrics, grads = loss_and_grad(params, batch)
            gscale = 1.0
        if spec is not None:
            # the compressors select and scale per leaf, and a JAX leaf
            # stacks a layer slot over its periods: compress in that layout
            stacked = to_jax_layout(grads, cfg)
            comp, new_ef = spec.compress(stacked,
                                         to_jax_layout(opt_state["ef"], cfg))
            grads = from_jax_layout(spec.decompress(comp, stacked), cfg,
                                    grads)
            new_ef = from_jax_layout(new_ef, cfg, opt_state["ef"])
            opt_state = {k: v for k, v in opt_state.items() if k != "ef"}
        new_params, new_opt, om = adamw_update(grads, opt_state, opt,
                                               grad_scale=gscale)
        if spec is not None:
            new_opt["ef"] = new_ef
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = metrics["loss_sum"] / torch.clamp(
            metrics["tokens"], min=1.0)
        return new_params, new_opt, metrics

    return train_step
