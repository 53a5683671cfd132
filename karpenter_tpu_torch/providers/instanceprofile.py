"""Instance-profile provider (reference pkg/providers/instanceprofile):
create/get/delete the machine identity for nodeClass.spec.role, 15m TTL."""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api import NodeClass
from karpenter_tpu_torch.cache.ttl import INSTANCE_PROFILE_TTL, TTLCache
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud
from karpenter_tpu_torch.utils.clock import Clock


class InstanceProfileProvider:
    def __init__(self, cloud: FakeCloud, clock: Clock, cluster_name: str = ""):
        self.cloud = cloud
        self.cluster_name = cluster_name
        self._cache = TTLCache(clock, INSTANCE_PROFILE_TTL)

    def _profile_name(self, node_class: NodeClass) -> str:
        return f"{self.cluster_name}-{node_class.name}"

    def ensure(self, node_class: NodeClass) -> Optional[str]:
        if not node_class.role:
            return None
        name = self._profile_name(node_class)
        if self._cache.get(name) is not None:
            return name
        self.cloud.ensure_instance_profile(name, node_class.role)
        self._cache.set(name, node_class.role)
        return name

    def delete(self, node_class: NodeClass) -> None:
        name = self._profile_name(node_class)
        self.cloud.delete_instance_profile(name)
        self._cache.delete(name)
