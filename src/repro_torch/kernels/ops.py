"""Public wrappers for the port's kernels.

The JAX package's ``kernels/ops.py`` jits each Pallas kernel and picks
interpret mode off-TPU; here a wrapper launches its CUDA kernel for CUDA
tensors and runs the plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cms import cms_counts
# the counted wrapper itself (``segment_fold.launches``), re-exported
from .segment_fold import segment_fold
from .stripes import stripe_counts


def mean_by_key(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int, *,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's running example, kernel edition: extract(sum/count),
    sums and counts from ONE launch."""
    sums, counts = segment_fold(values, seg_ids, num_segments,
                                 with_count=True, valid_mask=valid_mask)
    return sums / torch.clamp(counts, min=1.0)[:, None]


def cms_update(tokens: torch.Tensor, depth: int = 4,
               width: int = 2048) -> torch.Tensor:
    """Count-min sketch of a token batch as ``(depth, width)`` float32, the
    JAX package's ``ops.cms_update`` contract (the kernel's exact int32
    counts, cast; ``kernels.cms.cms_counts.launches`` counts the launch)."""
    return cms_counts(tokens, depth, width).to(torch.float32)


def stripes(tokens: torch.Tensor, vocab: int, window: int) -> torch.Tensor:
    """Symmetric ``(vocab, vocab)`` co-occurrence counts as float32, the JAX
    package's ``ops.stripes`` contract (the kernel's exact int32 counts,
    cast; ``kernels.stripes.stripe_counts.launches`` counts the launch)."""
    return stripe_counts(tokens, vocab, window).to(torch.float32)
