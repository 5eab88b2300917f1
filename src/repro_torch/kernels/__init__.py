"""Hand-written CUDA kernels for Hopper, each beside its plain version."""
from .ops import mean_by_key, segment_fold
from .segment_fold import segment_fold_plain

__all__ = ["mean_by_key", "segment_fold", "segment_fold_plain"]
