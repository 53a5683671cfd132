"""Termination controller: cordon -> drain -> terminate -> cleanup.

Re-derivation of karpenter-core's termination finalizer (reference
designs/termination.md): a Node/NodeClaim marked for deletion is tainted
(karpenter.sh/disruption), its pods are evicted respecting
PodDisruptionBudgets and the do-not-evict annotation, and only once
drained does the cloud instance terminate and the API objects disappear.
"""

from __future__ import annotations

import logging
import threading
from typing import List

from karpenter_tpu_torch.api import NodeClaim, Pod, Taint
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.provider import CloudProvider
from karpenter_tpu_torch.errors import NodeClaimNotFoundError
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.state.kube import KubeStore, Node
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.locks import make_lock

log = logging.getLogger(__name__)

DISRUPTION_TAINT = Taint(
    key=L.TAINT_DISRUPTION_KEY, value="disrupting", effect=L.TAINT_EFFECT_NO_SCHEDULE
)


class TerminationController:
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
        self._mark_lock = make_lock("TerminationController._mark_lock")

    # -------------------------------------------------------------- external
    def mark_for_deletion(self, claim: NodeClaim, reason: str = "") -> None:
        """The deprovisioner/interruption entry point: start graceful
        termination of a claim's node.  Callers may be concurrent (the
        interruption worker pool can carry several messages for one
        instance in a batch), so the mark is check-and-set under a lock —
        exactly one disruption metric/event per claim."""
        with self._mark_lock:
            if claim.deleted_at is not None:
                return
            claim.deleted_at = self.clock.now()
        self.registry.inc(
            "karpenter_nodeclaims_disrupted",
            {"reason": reason or "unknown", "nodepool": claim.pool_name},
        )
        self.kube.record_event("NodeClaim", "Disrupting", claim.name, reason)

    # ------------------------------------------------------------- reconcile
    def reconcile(self) -> None:
        for claim in list(self.kube.node_claims.values()):
            if claim.deleted_at is None:
                continue
            self._terminate(claim)

    def _terminate(self, claim: NodeClaim) -> None:
        node = (
            self.kube.node_by_provider_id(claim.provider_id)
            if claim.provider_id
            else None
        )
        if node is not None:
            self._cordon(node)
            remaining = self._drain(node)
            if remaining:
                return  # PDB-blocked or do-not-evict; retry next tick
        # drained (or no node ever registered): release the instance
        try:
            self.cloud_provider.delete(claim)
        except NodeClaimNotFoundError:
            pass
        if node is not None:
            self.kube.delete_node(node.name)
        self.kube.delete_node_claim(claim.name)
        self.registry.inc(
            "karpenter_nodes_terminated", {"nodepool": claim.pool_name}
        )
        # deletion-stamp -> gone latency (reference
        # karpenter_nodes_termination_time_seconds)
        self.registry.observe(
            "karpenter_nodes_termination_time_seconds",
            max(self.clock.now() - claim.deleted_at, 0.0),
            {"nodepool": claim.pool_name},
        )

    # -------------------------------------------------------------- internals
    def _cordon(self, node: Node) -> None:
        if not node.cordoned:
            node.cordoned = True
            if not any(t.key == L.TAINT_DISRUPTION_KEY for t in node.taints):
                node.taints.append(DISRUPTION_TAINT)
            if node.deleted_at is None:
                node.deleted_at = self.clock.now()

    def _drain(self, node: Node) -> List[Pod]:
        """Evict evictable pods; return those still blocking the drain."""
        blocking: List[Pod] = []
        pods = self.kube.pods_on_node(node.name)
        # per-PDB eviction allowances for this pass; already-unavailable
        # matching pods (evicted, not yet rescheduled) consume the budget
        all_pods = list(self.kube.pods.values())
        allowances = {
            name: pdb.disruptions_allowed(all_pods)
            for name, pdb in self.kube.pdbs.items()
        }
        for pod in pods:
            if pod.is_daemonset:
                continue  # daemonsets die with the node
            if pod.do_not_evict():
                blocking.append(pod)
                continue
            # two-phase: an eviction must fit EVERY selecting PDB before
            # any allowance is consumed
            selecting = [
                name for name, pdb in self.kube.pdbs.items() if pdb.selects(pod)
            ]
            if any(allowances[name] <= 0 for name in selecting):
                blocking.append(pod)
                continue
            for name in selecting:
                allowances[name] -= 1
            self._evict(pod)
        return blocking

    def _evict(self, pod: Pod) -> None:
        self.registry.inc("karpenter_pods_evicted")
        self.kube.evict_pod(pod.key())
