"""Hand-written CUDA kernels for Hopper, each beside its plain version."""
from .cms import cms_counts_plain
from .flash_attention import flash_attention_plain
from .ops import cms_update, flash_attn, mean_by_key, segment_fold, stripes
from .segment_fold import segment_fold_plain
from .stripes import stripe_counts_plain

__all__ = ["cms_update", "cms_counts_plain", "flash_attn",
           "flash_attention_plain", "mean_by_key", "segment_fold",
           "segment_fold_plain", "stripes", "stripe_counts_plain"]
