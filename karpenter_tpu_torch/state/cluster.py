"""In-memory cluster state: the scheduling snapshot.

Analogue of karpenter-core's `state.Cluster` (instantiated at reference
cmd/controller/main.go:49-55): a cache over nodes + bound pods that the
provisioner and deprovisioner consult.  Where the reference incrementally
maintains it from informer events, we rebuild the snapshot from the
KubeStore on demand (cheap at our scale) plus track in-flight NodeClaims
that have no Node yet — those still reserve capacity against scheduling.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.api import NodeClaim, Pod, Resources, Taint
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.state.kube import KubeStore, Node

# how long a nomination holds before the pod returns to the provisionable
# pool (reference karpenter-core state.Cluster nomination window)
NOMINATION_TTL = 20.0


@dataclass
class StateNode:
    """A node (or not-yet-registered claim) with its live usage."""

    name: str
    provider_id: str
    labels: Dict[str, str]
    taints: List[Taint]
    allocatable: Resources
    capacity: Resources = field(default_factory=Resources)
    pods: List[Pod] = field(default_factory=list)
    used: Resources = field(default_factory=Resources)
    node: Optional[Node] = None
    claim: Optional[NodeClaim] = None
    nominated: bool = False  # has in-flight pod reservations

    @property
    def registered(self) -> bool:
        return self.node is not None

    @property
    def initialized(self) -> bool:
        return self.claim is not None and self.claim.initialized or (
            self.claim is None and self.node is not None and self.node.ready
        )

    @property
    def pool_name(self) -> str:
        return self.labels.get(L.LABEL_NODEPOOL, "")

    @property
    def capacity_type(self) -> str:
        return self.labels.get(L.LABEL_CAPACITY_TYPE, L.CAPACITY_TYPE_ON_DEMAND)

    @property
    def zone(self) -> str:
        return self.labels.get(L.LABEL_ZONE, "")

    @property
    def instance_type_name(self) -> str:
        return self.labels.get(L.LABEL_INSTANCE_TYPE, "")

    def available(self) -> Resources:
        return (self.allocatable - self.used).clamp_nonnegative()

    def marked_for_deletion(self) -> bool:
        return (self.node is not None and self.node.deleted_at is not None) or (
            self.claim is not None and self.claim.deleted_at is not None
        )


class Cluster:
    """Snapshot builder + nomination ledger.

    Nominations (pods the provisioner has decided to place on an in-flight
    node) prevent double-provisioning between the launch and the kube
    scheduler binding the pod — the reference tracks these the same way in
    state.Cluster's podNominations.
    """

    def __init__(self, kube: KubeStore, clock=None):
        self.kube = kube
        self.clock = clock
        # pod key -> (node/claim name, nomination timestamp)
        self._nominations: Dict[str, Tuple[str, float]] = {}

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    def nominate(self, pod_key: str, node_name: str) -> None:
        self._nominations[pod_key] = (node_name, self._now())

    def clear_nomination(self, pod_key: str) -> None:
        self._nominations.pop(pod_key, None)

    def _live(self, pod_key: str) -> Optional[str]:
        entry = self._nominations.get(pod_key)
        if entry is None:
            return None
        node_name, ts = entry
        # nominations EXPIRE: if the scheduler hasn't bound the pod within
        # the window (taint added after nomination, kubelet wedged), the
        # pod must return to the provisionable pool and the node must stop
        # being charged for it — otherwise both deadlock forever (the
        # reference's state.Cluster nomination window is ~20s)
        if self.clock is not None and self._now() - ts > NOMINATION_TTL:
            self._nominations.pop(pod_key, None)
            return None
        return node_name

    def nominated_node(self, pod_key: str) -> Optional[str]:
        return self._live(pod_key)

    def nominations(self) -> List[tuple]:
        """Snapshot of live (pod key, target node/claim name) entries —
        the read API for consumers like the consistency checker."""
        return [
            (k, node)
            for k in list(self._nominations)
            if (node := self._live(k)) is not None
        ]

    def snapshot(self) -> List[StateNode]:
        nodes: Dict[str, StateNode] = {}
        claims_by_provider = {
            c.provider_id: c for c in self.kube.node_claims.values() if c.provider_id
        }
        for n in self.kube.nodes.values():
            claim = claims_by_provider.get(n.provider_id)
            nodes[n.name] = StateNode(
                name=n.name,
                provider_id=n.provider_id,
                labels=dict(n.labels),
                taints=list(n.taints),
                allocatable=n.allocatable,
                capacity=n.capacity,
                node=n,
                claim=claim,
            )
        # in-flight claims (launched, not yet registered as Nodes)
        registered_provider_ids = {n.provider_id for n in self.kube.nodes.values()}
        for c in self.kube.node_claims.values():
            if c.provider_id and c.provider_id in registered_provider_ids:
                continue
            nodes[c.name] = StateNode(
                name=c.name,
                provider_id=c.provider_id,
                labels=dict(c.labels),
                taints=list(c.taints),
                allocatable=c.allocatable,
                capacity=c.capacity,
                claim=c,
            )
        # charge bound pods
        for p in self.kube.pods.values():
            if p.node_name and p.node_name in nodes:
                sn = nodes[p.node_name]
                sn.pods.append(p)
                sn.used = sn.used + p.requests
        # charge nominated (in-flight) pods
        for pod_key in list(self._nominations):
            node_name = self._live(pod_key)  # drops expired entries
            if node_name is None:
                continue
            pod = self.kube.pods.get(pod_key)
            sn = nodes.get(node_name)
            if pod is None or pod.node_name or sn is None:
                # nomination resolved or stale; drop it
                self._nominations.pop(pod_key, None)
                continue
            sn.pods.append(pod)
            sn.used = sn.used + pod.requests
            sn.nominated = True
        return list(nodes.values())

    def pool_usage(self, pool_name: str) -> Resources:
        """Total capacity consumed by a pool (for NodePool.limits
        enforcement; reference designs/limits.md).  Uses node capacity
        uniformly regardless of how the node joined (claim or adoption)."""
        out = Resources()
        for sn in self.snapshot():
            if sn.pool_name == pool_name and not sn.marked_for_deletion():
                out = out + (sn.capacity if sn.capacity else sn.allocatable)
        return out
