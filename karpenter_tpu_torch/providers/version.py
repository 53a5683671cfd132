"""Cluster-version provider (reference pkg/providers/version): discovery
with a cache; feeds default-image queries."""

from __future__ import annotations

from karpenter_tpu_torch.cache.ttl import DEFAULT_TTL, TTLCache
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud
from karpenter_tpu_torch.providers.stale import StaleGuard
from karpenter_tpu_torch.utils.clock import Clock


class VersionProvider:
    def __init__(self, cloud: FakeCloud, clock: Clock, registry=None):
        self.cloud = cloud
        self._cache = TTLCache(clock, DEFAULT_TTL * 5)
        self._stale = StaleGuard("version", clock, registry)

    def get(self) -> str:
        cached = self._cache.get("version")
        if cached is not None:
            return cached
        v, fresh = self._stale.fetch(
            "version", self.cloud.describe_cluster_version
        )
        if fresh:
            self._cache.set("version", v)
        return v
