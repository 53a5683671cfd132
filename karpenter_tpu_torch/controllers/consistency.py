"""Consistency checker: periodic cross-object invariant checks.

Analogue of karpenter-core's consistency controller (SURVEY.md §2b core
controller list): every CHECK_PERIOD it walks the claim/instance/node
triangle and the nomination ledger, emitting a Kubernetes event and a
``karpenter_consistency_errors{check}`` counter for each violated
invariant (the reference publishes ``karpenter_consistency_errors`` the
same way, website v0.31 concepts/metrics.md).

Checks:
- **claim-instance linkage**: a launched claim's provider_id must resolve
  to a live cloud instance (otherwise the GC/liveness path is failing).
- **node-claim linkage**: a registered node's provider_id must belong to
  a claim, and a registered+initialized claim must have a node.
- **capacity**: a node must not report MORE allocatable than its claim's
  capacity on any axis (a node lying about its size corrupts every
  scheduling simulation; the reference compares node capacity against the
  instance-type expectation the same way).
- **pod binding**: no pod may be bound to a node object that no longer
  exists.
- **nominations**: no nomination may target a node/claim that no longer
  exists (the ledger self-heals on snapshot, but a stuck entry here means
  the provisioner is reserving capacity that cannot materialize).

The checker never mutates state — it surfaces drift between the stores
for operators and tests, exactly like the reference controller.
"""

from __future__ import annotations

import logging

from karpenter_tpu_torch.errors import NodeClaimNotFoundError
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

CHECK_PERIOD = 60.0  # seconds between full passes


class ConsistencyController:
    def __init__(
        self,
        kube: KubeStore,
        cluster: Cluster,
        cloud_provider,
        clock: Clock,
        registry: Registry = REGISTRY,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.registry = registry
        self._last_run = float("-inf")

    def reconcile(self) -> None:
        now = self.clock.now()
        if now - self._last_run < CHECK_PERIOD:
            return
        self._last_run = now
        self._check_claim_instance()
        self._check_node_claim()
        self._check_capacity()
        self._check_pod_bindings()
        self._check_nominations()

    # ------------------------------------------------------------- internals
    def _violation(self, check: str, obj_name: str, message: str) -> None:
        log.warning("consistency: %s %s: %s", check, obj_name, message)
        self.registry.inc("karpenter_consistency_errors", {"check": check})
        self.kube.record_event(
            "NodeClaim", "ConsistencyViolation", obj_name, f"{check}: {message}"
        )

    def _check_claim_instance(self) -> None:
        for claim in list(self.kube.node_claims.values()):
            if not claim.provider_id or claim.deleted_at is not None:
                continue
            try:
                self.cloud_provider.get(claim.provider_id)
            except NodeClaimNotFoundError:
                self._violation(
                    "claim-instance",
                    claim.name,
                    f"claim's instance {claim.provider_id} is gone",
                )

    def _check_node_claim(self) -> None:
        claims_by_provider = {
            c.provider_id: c
            for c in self.kube.node_claims.values()
            if c.provider_id
        }
        for node in list(self.kube.nodes.values()):
            if node.deleted_at is not None:
                continue
            if node.provider_id and node.provider_id not in claims_by_provider:
                # adopted nodes are linked by the link controller; a node
                # that stays claimless is unmanaged capacity
                self._violation(
                    "node-claim",
                    node.name,
                    f"node's provider id {node.provider_id} has no claim",
                )
        for claim in list(self.kube.node_claims.values()):
            if claim.deleted_at is not None or not claim.registered:
                continue
            if (
                claim.provider_id
                and self.kube.node_by_provider_id(claim.provider_id) is None
            ):
                self._violation(
                    "claim-node",
                    claim.name,
                    "registered claim has no node object",
                )

    def _check_capacity(self) -> None:
        for claim in list(self.kube.node_claims.values()):
            if claim.deleted_at is not None or not claim.provider_id:
                continue
            node = self.kube.node_by_provider_id(claim.provider_id)
            if node is None or not claim.capacity:
                continue
            for axis, reported in node.allocatable.items():
                expected = claim.capacity.get(axis)
                if expected and reported > expected * 1.001:
                    self._violation(
                        "capacity",
                        claim.name,
                        f"node reports {axis}={reported:g} above claim "
                        f"capacity {expected:g}",
                    )

    def _check_pod_bindings(self) -> None:
        for pod in list(self.kube.pods.values()):
            if pod.node_name and pod.node_name not in self.kube.nodes:
                self._violation(
                    "pod-binding",
                    pod.key(),
                    f"pod bound to missing node {pod.node_name}",
                )

    def _check_nominations(self) -> None:
        for pod_key, target in self.cluster.nominations():
            if (
                target not in self.kube.nodes
                and target not in self.kube.node_claims
            ):
                self._violation(
                    "nomination",
                    pod_key,
                    f"nomination targets missing node {target}",
                )
