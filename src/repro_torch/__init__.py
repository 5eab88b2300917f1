"""repro_torch — the PyTorch + CUDA twin of :mod:`repro`.

The paper's monoid folds (lift / combine / identity / extract) and the
execution planner that lowers every fold to one tier, written in PyTorch,
with the planner's kernel tier as a hand-written CUDA kernel for Hopper
(``kernels/csrc/segment_fold.cu``).  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on CPU tensors every kernel wrapper
runs its plain PyTorch version.

  from repro_torch.serving import ServeConfig, build_engine

  engine = build_engine(ServeConfig(arch="qwen3-0.6b", full=True))
"""
from .core import Monoid, execute_fold, monoids, plan_fold
from . import optim  # noqa: F401,E402  (registers the lossy monoids)

__all__ = ["Monoid", "execute_fold", "monoids", "plan_fold"]
