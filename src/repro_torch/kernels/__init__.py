"""Hand-written CUDA kernels for Hopper, each beside its plain version."""
from .cms import cms_counts_plain
from .ops import cms_update, mean_by_key, segment_fold, stripes
from .segment_fold import segment_fold_plain
from .stripes import stripe_counts_plain

__all__ = ["cms_update", "cms_counts_plain", "mean_by_key", "segment_fold",
           "segment_fold_plain", "stripes", "stripe_counts_plain"]
