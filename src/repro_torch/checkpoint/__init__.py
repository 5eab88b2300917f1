"""repro_torch.checkpoint -- atomic, async checkpoints with monoid-merge
resume, in the JAX package's on-disk layout."""
from .store import CheckpointStore

__all__ = ["CheckpointStore"]
