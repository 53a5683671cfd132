"""Instance garbage collection (reference
pkg/controllers/nodeclaim/garbagecollection/controller.go:62-121): reap
cloud instances older than 30s with no matching NodeClaim — leak
prevention for failed registrations — and drop Nodes whose backing
instance is gone."""

from __future__ import annotations

import logging

from karpenter_tpu_torch.cloud.provider import CloudProvider
from karpenter_tpu_torch.errors import NodeClaimNotFoundError
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

MIN_INSTANCE_AGE = 30.0  # reference controller.go:104-121


class GarbageCollectionController:
    def __init__(
        self,
        kube: KubeStore,
        cloud_provider: CloudProvider,
        clock: Clock,
        registry: Registry = REGISTRY,
    ):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.registry = registry

    def reconcile(self) -> None:
        claimed_ids = {
            c.provider_id for c in self.kube.node_claims.values() if c.provider_id
        }
        now = self.clock.now()
        listed = self.cloud_provider.list()  # one describe sweep per tick
        live_ids = {c.provider_id for c in listed}
        for claim in listed:
            if claim.provider_id in claimed_ids:
                continue
            if now - claim.created_at < MIN_INSTANCE_AGE:
                continue  # grace period for the claim write to land
            log.info("garbage-collecting orphaned instance %s", claim.provider_id)
            try:
                self.cloud_provider.delete(claim)
            except NodeClaimNotFoundError:
                pass
            live_ids.discard(claim.provider_id)
            self.registry.inc("karpenter_instances_garbage_collected")
            node = self.kube.node_by_provider_id(claim.provider_id)
            if node is not None:
                self.kube.delete_node(node.name)
        # nodes whose instance vanished (out-of-band termination)
        for node in list(self.kube.nodes.values()):
            if node.provider_id and node.provider_id not in live_ids:
                claim = self.kube.claim_by_provider_id(node.provider_id)
                self.kube.delete_node(node.name)
                if claim is not None:
                    self.kube.delete_node_claim(claim.name)
                self.registry.inc("karpenter_nodes_garbage_collected")
