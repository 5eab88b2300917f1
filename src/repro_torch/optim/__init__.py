"""repro_torch.optim -- the optimizer substrate (AdamW, schedules, gradient
compression with error feedback)."""
from .adamw import (OptConfig, adamw_update, clip_by_global_norm, global_norm,
                    init_opt_state, schedule)
from .compress import (LossySpec, blocktopk_compress, compressed_bytes,
                       init_error_state, int8_compress, int8_decompress,
                       int8_sum_monoid, topk_compress, topk_decompress,
                       topk_sparse_monoid)

__all__ = ["LossySpec", "OptConfig", "adamw_update", "blocktopk_compress",
           "clip_by_global_norm", "compressed_bytes", "global_norm",
           "init_error_state", "init_opt_state", "int8_compress",
           "int8_decompress", "int8_sum_monoid", "schedule", "topk_compress",
           "topk_decompress", "topk_sparse_monoid"]
