"""NodeClaim lifecycle: launch -> register -> initialize -> liveness.

Re-derivation of karpenter-core's machine-lifecycle controller (SURVEY.md
§2b: "machine lifecycle (launch/register/initialize/liveness)"):

- **register**: a Node whose provider-id matches the claim appeared —
  stamp registration, sync labels.
- **initialize**: the registered node is Ready and its startup taints are
  gone — the node can take disruption actions from now on.
- **liveness**: a claim that hasn't registered within
  REGISTRATION_TTL is assumed dead (bad image, network, lost instance) —
  delete the claim and its instance so the pods reschedule.
"""

from __future__ import annotations

import logging
from typing import List

from karpenter_tpu_torch.api import NodeClaim, NodeClaimCondition
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.provider import CloudProvider
from karpenter_tpu_torch.errors import NodeClaimNotFoundError
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

REGISTRATION_TTL = 15 * 60.0  # liveness window for kubelet registration


class LifecycleController:
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
        for claim in list(self.kube.node_claims.values()):
            if claim.deleted_at is not None:
                continue
            self._reconcile_claim(claim)

    def _reconcile_claim(self, claim: NodeClaim) -> None:
        node = (
            self.kube.node_by_provider_id(claim.provider_id)
            if claim.provider_id
            else None
        )
        if node is not None and not claim.registered:
            claim.set_condition(NodeClaimCondition.REGISTERED)
            # node label sync: pool-owned labels stamp onto the node
            node.labels.update(claim.labels)
            node.labels[L.LABEL_NODE_REGISTERED] = "true"
            self.registry.inc(
                "karpenter_nodeclaims_registered", {"nodepool": claim.pool_name}
            )
        if (
            node is not None
            and claim.registered
            and not claim.initialized
            and node.ready
            and not _has_startup_taints(node, claim)
        ):
            claim.set_condition(NodeClaimCondition.INITIALIZED)
            node.labels[L.LABEL_NODE_INITIALIZED] = "true"
            self.registry.inc(
                "karpenter_nodeclaims_initialized", {"nodepool": claim.pool_name}
            )
        if node is None and not claim.registered:
            age = self.clock.now() - (claim.created_at or self.clock.now())
            if claim.launched and age > REGISTRATION_TTL:
                log.warning(
                    "claim %s failed to register within %.0fs; terminating",
                    claim.name, REGISTRATION_TTL,
                )
                self.registry.inc(
                    "karpenter_nodeclaims_terminated",
                    {"reason": "liveness", "nodepool": claim.pool_name},
                )
                try:
                    self.cloud_provider.delete(claim)
                except NodeClaimNotFoundError:
                    pass
                self.kube.delete_node_claim(claim.name)


def _has_startup_taints(node, claim: NodeClaim) -> bool:
    startup = {(t.key, t.value, t.effect) for t in claim.startup_taints}
    return any((t.key, t.value, t.effect) in startup for t in node.taints)
