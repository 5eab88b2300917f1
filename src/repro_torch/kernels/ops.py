"""Public wrappers for the port's kernels.

The JAX package's ``kernels/ops.py`` jits each Pallas kernel and picks
interpret mode off-TPU; here a wrapper launches its CUDA kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

# the counted wrapper itself (``segment_fold.launches``), re-exported
from .segment_fold import segment_fold


def mean_by_key(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int, *,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's running example, kernel edition: extract(sum/count),
    sums and counts from ONE launch."""
    sums, counts = segment_fold(values, seg_ids, num_segments,
                                 with_count=True, valid_mask=valid_mask)
    return sums / torch.clamp(counts, min=1.0)[:, None]
