"""Weight carry-over from the JAX package.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
parameters: the same leaves, with ``params["layers"]`` — stacked over a
leading ``n_periods`` dim in the JAX package — unstacked into one dict per
layer.  The two models then compute the same function.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.utils._pytree as pytree

from .common import ModelConfig
from .transformer import _check_supported


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # numpy has no bfloat16: JAX's bf16 arrays arrive as ml_dtypes arrays,
    # which go through float32 (exact for bf16 values)
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(
        device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """The port's parameters from the JAX package's (dense family; layers
    scanned with period 1), cast to ``cfg.dtype`` on ``device``."""
    _check_supported(cfg)
    if cfg.period != 1:
        raise NotImplementedError("only period-1 stacks carry over")
    device = torch.device(device)

    def conv(a):
        return _to_tensor(a, cfg.dtype, device)

    stacked = tree["layers"]["slot_0"]
    n = pytree.tree_leaves(stacked)[0].shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"JAX stack holds {n} layers; config says "
                         f"{cfg.num_layers}")
    layers = [pytree.tree_map(lambda a, i=i: conv(np.asarray(a)[i]), stacked)
              for i in range(n)]
    out = {k: conv(v) for k, v in tree.items()
           if k not in ("layers",) and not isinstance(v, dict)}
    out["layers"] = layers
    return out
