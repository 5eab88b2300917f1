"""AdamW with mixed precision, global-norm clipping and a warmup-cosine
schedule: the port of the JAX package's ``optim/adamw.py``.

Monoid hooks (the paper's §3 SGD observation, generalised):

* Gradients are a Sum monoid over microbatches, so the accumulation order
  is free: :func:`repro_torch.core.aggregation.grad_accum_fold` folds them
  in-mapper (Algorithm 4).
* The optimizer *state* (m, v) is not a monoid in the update (Adam's
  normaliser is order-sensitive), but parameter *deltas* under addition
  are, which the error-feedback compression of ``optim/compress.py``
  exploits.

Master weights, ``m`` and ``v`` are float32 on the parameters' device; the
update returns the new parameters cast to bfloat16, as the JAX package's
does, whatever the parameters' dtype was.  The state is a dict of tensors
(``step`` an int32 0-d tensor), so it checkpoints like the parameters.
:func:`opt_state_shapes` is the abstract state on the meta device (the
dry run's).

Under a mesh each rank holds its blocks of the parameters and of the
state; AdamW stays elementwise on the blocks, and only the global norm
that clipping reads crosses ranks (``norm_axes``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

Pytree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio * peak`` (float32,
    on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _device(params: Pytree) -> torch.device:
    leaves = pytree.tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def init_opt_state(params: Pytree, *, with_ef: bool = False
                   ) -> Dict[str, Pytree]:
    """``step``, float32 ``m`` / ``v`` zeros and the float32 ``master``
    copy; ``with_ef`` adds the error-feedback residual of a ``lossy=``
    gradient fold (optim/compress.py), fold state that must persist across
    steps, so it lives (and checkpoints) with the optimizer state."""
    def f32_zeros(t):
        return pytree.tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), t)

    state = {
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
        "m": f32_zeros(params),
        "v": f32_zeros(params),
        "master": pytree.tree_map(lambda x: x.to(torch.float32), params),
    }
    if with_ef:
        state["ef"] = f32_zeros(params)
    return state


def opt_state_shapes(param_shapes: Pytree, *, with_ef: bool = False
                     ) -> Dict[str, Pytree]:
    """The abstract optimizer state (the dry run's): :func:`init_opt_state`'s
    tree with float32 ``m`` / ``v`` / ``master`` (and ``ef``) shaped like
    ``param_shapes`` and an int32 0-d ``step``, on the meta device."""
    def f32(t):
        return pytree.tree_map(lambda x: torch.empty(
            x.shape, dtype=torch.float32, device="meta"), t)

    state = {"step": torch.empty((), dtype=torch.int32, device="meta"),
             "m": f32(param_shapes), "v": f32(param_shapes),
             "master": f32(param_shapes)}
    if with_ef:
        state["ef"] = f32(param_shapes)
    return state


def global_norm(tree: Pytree,
                norm_axes: Optional[Sequence[Tuple[str, ...]]] = None
                ) -> torch.Tensor:
    """The float32 2-norm over every leaf.  Under a mesh, where each leaf
    is this rank's block, ``norm_axes`` gives per leaf (in
    ``tree_leaves`` order) the mesh axes its block is cut over: the
    squares of the blocks cut over the same axes are summed and psummed
    over them, and a replicated leaf (``()``) counts once."""
    squares = [torch.sum(torch.square(x.to(torch.float32)))
               for x in pytree.tree_leaves(tree)]
    if norm_axes is None:
        return torch.sqrt(sum(squares))
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for sq, axes in zip(squares, norm_axes):
        axes = tuple(axes)
        groups[axes] = groups[axes] + sq if axes in groups else sq
    from .. import dist
    return torch.sqrt(sum(dist.psum(v, axes) if axes else v
                          for axes, v in groups.items()))


def clip_by_global_norm(grads: Pytree, max_norm: float,
                        norm_axes: Optional[Sequence[Tuple[str, ...]]] = None
                        ) -> Tuple[Pytree, torch.Tensor]:
    norm = global_norm(grads, norm_axes)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return pytree.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(grads: Pytree, opt_state: Dict[str, Pytree], cfg: OptConfig,
                 *, grad_scale: float = 1.0,
                 norm_axes: Optional[Sequence[Tuple[str, ...]]] = None
                 ) -> Tuple[Pytree, Dict[str, Pytree], Dict[str, torch.Tensor]]:
    """One AdamW step -> (new bf16 params, new state, ``{"lr",
    "grad_norm"}``).  The new state holds ``step``, ``m``, ``v`` and
    ``master`` only (a caller carrying ``ef`` puts it back).

    ``grad_scale`` multiplies the summed gradients (the ``extract`` of the
    gradient Sum monoid: 1 / num_microbatches after ``grad_accum_fold``).
    ``norm_axes`` (blocks under a mesh) is :func:`global_norm`'s.
    """
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    grads = pytree.tree_map(lambda g: g.to(torch.float32) * grad_scale, grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm_axes)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(m, v, g, p):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        return m, v, p - lr * delta

    flat_m, spec = pytree.tree_flatten(opt_state["m"])
    flat_v = pytree.tree_leaves(opt_state["v"])
    flat_g = pytree.tree_leaves(grads)
    flat_p = pytree.tree_leaves(opt_state["master"])
    out = [upd(m, v, g, p) for m, v, g, p in zip(flat_m, flat_v, flat_g,
                                                   flat_p)]
    new_master = pytree.tree_unflatten([o[2] for o in out], spec)
    new_state = {"step": step,
                 "m": pytree.tree_unflatten([o[0] for o in out], spec),
                 "v": pytree.tree_unflatten([o[1] for o in out], spec),
                 "master": new_master}
    new_params = pytree.tree_map(lambda x: x.to(torch.bfloat16), new_master)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
