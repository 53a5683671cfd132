"""NodeClass status controller (reference pkg/controllers/nodeclass
controller.go:76-126): resolve selector terms into status every pass,
and a finalizer that blocks deletion while NodeClaims still reference the
class, then deletes the instance profile."""

from __future__ import annotations

import logging

from karpenter_tpu_torch.providers.image import ImageProvider
from karpenter_tpu_torch.providers.instanceprofile import InstanceProfileProvider
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.state.kube import KubeStore

log = logging.getLogger(__name__)


class NodeClassController:
    def __init__(
        self,
        kube: KubeStore,
        subnets: SubnetProvider,
        security_groups: SecurityGroupProvider,
        images: ImageProvider,
        instance_profiles: InstanceProfileProvider,
    ):
        self.kube = kube
        self.subnets = subnets
        self.security_groups = security_groups
        self.images = images
        self.instance_profiles = instance_profiles

    def reconcile(self) -> None:
        for nc in list(self.kube.node_classes.values()):
            if nc.deleted:
                self._finalize(nc)
            else:
                self._resolve_status(nc)

    def _resolve_status(self, nc) -> None:
        nc.resolved_subnets = [s.id for s in self.subnets.list(nc)]
        nc.resolved_security_groups = [
            g.id for g in self.security_groups.list(nc)
        ]
        nc.resolved_images = [c.image.id for c in self.images.list(nc)]
        profile = self.instance_profiles.ensure(nc)
        nc.resolved_instance_profile = profile or ""
        if not nc.resolved_subnets:
            self.kube.record_event(
                "NodeClass", "NoSubnets", nc.name, "selector matched nothing"
            )

    def _finalize(self, nc) -> None:
        """Finalizer: wait for referencing claims, then release the
        instance profile and drop the object (controller.go:100-126)."""
        referencing = [
            c
            for c in self.kube.node_claims.values()
            if c.node_class_ref == nc.name
        ]
        if referencing:
            return
        self.instance_profiles.delete(nc)
        self.kube.node_classes.pop(nc.name, None)
