"""Security-group provider (reference pkg/providers/securitygroup):
selector terms -> groups, TTL-cached."""

from __future__ import annotations

from typing import List

from karpenter_tpu_torch.api import NodeClass
from karpenter_tpu_torch.cache.ttl import DEFAULT_TTL, TTLCache
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, FakeSecurityGroup
from karpenter_tpu_torch.providers.stale import StaleGuard
from karpenter_tpu_torch.utils.clock import Clock


class SecurityGroupProvider:
    def __init__(self, cloud: FakeCloud, clock: Clock, registry=None):
        self.cloud = cloud
        self._cache = TTLCache(clock, DEFAULT_TTL)
        self._stale = StaleGuard("securitygroup", clock, registry)

    def list(self, node_class: NodeClass) -> List[FakeSecurityGroup]:
        key = tuple(node_class.security_group_selector_terms)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        groups, fresh = self._stale.fetch(
            key,
            lambda: self.cloud.describe_security_groups(
                node_class.security_group_selector_terms
            ),
        )
        if fresh:
            self._cache.set(key, groups)
        return groups

    def invalidate(self) -> None:
        self._cache.flush()
