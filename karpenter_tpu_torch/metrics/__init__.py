"""Metrics registry (reference: Prometheus metric set, website v0.31 metrics.md)."""

from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry

__all__ = ["REGISTRY", "Registry"]
