"""Instance tagging controller (reference
pkg/controllers/nodeclaim/tagging/controller.go:62-126): after a claim
registers, stamp the instance with its node name and the managed-by tag so
out-of-band tooling can attribute machines."""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud
from karpenter_tpu_torch.state.kube import KubeStore


class TaggingController:
    def __init__(self, kube: KubeStore, cloud: FakeCloud):
        self.kube = kube
        self.cloud = cloud

    def reconcile(self) -> None:
        for claim in self.kube.node_claims.values():
            if not claim.provider_id or not claim.registered:
                continue
            node = self.kube.node_by_provider_id(claim.provider_id)
            if node is None:
                continue
            inst = self.cloud.instances.get(claim.provider_id)
            if inst is None:
                continue
            want = {
                L.ANNOTATION_MANAGED_BY: "karpenter-tpu",
                "karpenter.sh/node-name": node.name,
            }
            if any(inst.tags.get(k) != v for k, v in want.items()):
                inst.tags.update(want)
