"""Request coalescing (reference pkg/batcher)."""

from karpenter_tpu_torch.batcher.core import Batcher, BatchStats

__all__ = ["Batcher", "BatchStats"]
