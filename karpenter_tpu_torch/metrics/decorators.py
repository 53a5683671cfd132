"""CloudProvider metrics decorator (reference cmd/controller/main.go:46
`metrics.Decorate(cloudProvider)`): wraps every facade method with a
duration histogram and an error counter so the API surface is observable
without touching the facade itself.

Metric names mirror the reference's cloudprovider metrics
(website v0.31 concepts/metrics.md):
- karpenter_cloudprovider_duration_seconds{method, provider}
- karpenter_cloudprovider_errors_total{method, provider, error}
"""

from __future__ import annotations

import functools
from typing import Callable

from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry

_WRAPPED = (
    "create",
    "delete",
    "get",
    "list",
    "get_instance_types",
    "is_drifted",
)


class MetricsCloudProvider:
    """Duration/error recording proxy around a CloudProvider.

    The six facade methods are wrapped ONCE at construction (hot paths
    call them per claim per tick); everything else forwards to the inner
    provider untouched."""

    def __init__(self, inner, registry: Registry = REGISTRY):
        self._inner = inner
        self._registry = registry
        provider = inner.name()
        for method in _WRAPPED:
            setattr(
                self, method, self._wrap(method, getattr(inner, method), provider)
            )

    def name(self) -> str:
        return self._inner.name()

    def __getattr__(self, attr: str):
        return getattr(self._inner, attr)

    def _wrap(self, method: str, fn: Callable, provider: str) -> Callable:
        registry = self._registry
        labels = {"method": method, "provider": provider}
        err_labels = dict(labels)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with registry.time(
                "karpenter_cloudprovider_duration_seconds", labels
            ):
                try:
                    return fn(*args, **kwargs)
                except Exception as exc:
                    registry.inc(
                        "karpenter_cloudprovider_errors_total",
                        {**err_labels, "error": type(exc).__name__},
                    )
                    raise

        return timed
