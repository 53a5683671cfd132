"""In-memory kube-apiserver analogue.

The reference keeps all durable state in the kube-apiserver (CRDs:
NodePool/Provisioner, NodeClaim/Machine, EC2NodeClass) — SURVEY.md section 5
"checkpoint/resume: none needed".  We mirror that: this store is the single
source of durable truth; caches elsewhere are reconstructable from it.  Its
test role matches controller-runtime envtest in the reference suites
(pkg/cloudprovider/suite_test.go:64-78).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch.utils.locks import make_lock, note_access
from karpenter_tpu_torch.api import (
    NodeClaim,
    NodeClass,
    NodePool,
    PersistentVolumeClaim,
    Pod,
    Resources,
    StorageClass,
    Taint,
)
from karpenter_tpu_torch.api import labels as L


@dataclass
class PodDisruptionBudget:
    """v1.PodDisruptionBudget projection: the termination controller's
    evictions respect these (reference: core termination controller is
    PDB-aware, designs/termination.md)."""

    name: str
    label_selector: Dict[str, str] = field(default_factory=dict)
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    namespace: str = "default"

    def selects(self, pod: Pod) -> bool:
        if pod.namespace != self.namespace:
            return False
        return all(pod.labels.get(k) == v for k, v in self.label_selector.items())

    def disruptions_allowed(self, all_matching: List[Pod]) -> int:
        """How many matching pods may be evicted right now, given the FULL
        matching set (any phase).  Pods already unavailable — evicted and
        not yet rescheduled — consume the budget, exactly like the PDB
        status accounting in Kubernetes."""
        matching = [p for p in all_matching if self.selects(p)]
        healthy = sum(1 for p in matching if p.phase == "Running")
        unavailable = len(matching) - healthy
        if self.max_unavailable is not None:
            return max(0, self.max_unavailable - unavailable)
        if self.min_available is not None:
            return max(0, healthy - self.min_available)
        return healthy


@dataclass
class Node:
    """A registered cluster node (the v1.Node analogue)."""

    name: str
    provider_id: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    capacity: Resources = field(default_factory=Resources)
    allocatable: Resources = field(default_factory=Resources)
    ready: bool = False
    created_at: float = 0.0
    deleted_at: Optional[float] = None
    cordoned: bool = False


class KubeStore:
    """Typed object store with the handful of list/get/delete verbs the
    controllers need, plus simple event hooks for cache invalidation."""

    def __init__(self):
        self.pods: Dict[str, Pod] = {}  # key: ns/name
        self.nodes: Dict[str, Node] = {}
        self.node_claims: Dict[str, NodeClaim] = {}
        self.node_pools: Dict[str, NodePool] = {}
        self.node_classes: Dict[str, NodeClass] = {}
        self.pdbs: Dict[str, PodDisruptionBudget] = {}
        self.storage_classes: Dict[str, StorageClass] = {}
        self.pvcs: Dict[str, PersistentVolumeClaim] = {}  # key: ns/name
        self.events: List[tuple] = []  # (kind, reason, obj_name, message)
        self._watchers: List[Callable[[str, str, object], None]] = []
        self._seq = itertools.count(1)
        # coordination.k8s.io/v1 Leases (utils/leader.py): the only store
        # surface touched concurrently by competing replicas, so its
        # compare-and-swap runs under a lock
        self.leases: Dict[str, "Lease"] = {}
        self._lease_lock = make_lock("KubeStore._lease_lock")

    # -- watch hooks ---------------------------------------------------------
    def watch(self, fn: Callable[[str, str, object], None]) -> None:
        """fn(kind, verb, obj) on every mutation."""
        self._watchers.append(fn)

    def _notify(self, kind: str, verb: str, obj) -> None:
        for fn in self._watchers:
            fn(kind, verb, obj)

    # -- pods ----------------------------------------------------------------
    def put_pod(self, pod: Pod) -> Pod:
        self.pods[pod.key()] = pod
        self._notify("Pod", "put", pod)
        return pod

    def delete_pod(self, key: str) -> None:
        pod = self.pods.pop(key, None)
        if pod is not None:
            self._notify("Pod", "delete", pod)

    def pending_pods(self) -> List[Pod]:
        return [
            p for p in self.pods.values() if p.phase == "Pending" and not p.node_name
        ]

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return [p for p in self.pods.values() if p.node_name == node_name]

    def bind_pod(self, key: str, node_name: str) -> None:
        pod = self.pods[key]
        pod.node_name = node_name
        pod.phase = "Running"
        # the first consumer anchors WaitForFirstConsumer volumes: the
        # volume provisions in the bound node's zone, pinning every later
        # consumer of the claim there (scheduling.md:387-411)
        if pod.volume_claims:
            node = self.nodes.get(node_name)
            zone = node.labels.get(L.LABEL_ZONE, "") if node else ""
            if zone:
                for cname in pod.volume_claims:
                    pvc = self.pvcs.get(f"{pod.namespace}/{cname}")
                    if pvc is not None and not pvc.bound_zone:
                        pvc.bound_zone = zone
                        self._notify("PersistentVolumeClaim", "bind", pvc)
        self._notify("Pod", "bind", pod)

    def evict_pod(self, key: str) -> None:
        """Eviction semantics: a controller-owned pod re-pends (its
        controller recreates it); a bare pod is deleted — the Eviction API
        analogue the termination controller drains with."""
        pod = self.pods.get(key)
        if pod is None:
            return
        if pod.has_controller:
            pod.node_name = ""
            pod.phase = "Pending"
            self._notify("Pod", "evict", pod)
        else:
            self.delete_pod(key)

    # -- nodes ---------------------------------------------------------------
    def put_node(self, node: Node) -> Node:
        self.nodes[node.name] = node
        self._notify("Node", "put", node)
        return node

    def delete_node(self, name: str) -> None:
        node = self.nodes.pop(name, None)
        if node is not None:
            for p in self.pods_on_node(name):
                # pods on a deleted node go back to pending (controller-owned
                # pods are recreated by their controller in a real cluster);
                # each re-pend notifies so store replication (state/remote.py)
                # ships the cascade, not just the node deletion
                p.node_name = ""
                p.phase = "Pending"
                self._notify("Pod", "put", p)
            self._notify("Node", "delete", node)

    def node_by_provider_id(self, provider_id: str) -> Optional[Node]:
        for n in self.nodes.values():
            if n.provider_id == provider_id:
                return n
        return None

    # -- node claims ---------------------------------------------------------
    def put_node_claim(self, claim: NodeClaim) -> NodeClaim:
        self.node_claims[claim.name] = claim
        self._notify("NodeClaim", "put", claim)
        return claim

    def delete_node_claim(self, name: str) -> None:
        claim = self.node_claims.pop(name, None)
        if claim is not None:
            self._notify("NodeClaim", "delete", claim)

    def claim_by_provider_id(self, provider_id: str) -> Optional[NodeClaim]:
        for c in self.node_claims.values():
            if c.provider_id == provider_id:
                return c
        return None

    # -- pools / classes -----------------------------------------------------
    def put_node_pool(self, pool: NodePool) -> NodePool:
        """Admission: validation runs before the write (the webhook
        analogue, api/validation.py)."""
        from karpenter_tpu_torch.api.validation import validate_node_pool

        validate_node_pool(pool)
        self.node_pools[pool.name] = pool
        self._notify("NodePool", "put", pool)
        return pool

    def put_node_class(self, nc: NodeClass) -> NodeClass:
        from karpenter_tpu_torch.api.validation import validate_node_class

        validate_node_class(nc)
        self.node_classes[nc.name] = nc
        self._notify("NodeClass", "put", nc)
        return nc

    def get_node_class(self, name: str) -> Optional[NodeClass]:
        return self.node_classes.get(name)

    def put_storage_class(self, sc: StorageClass) -> StorageClass:
        from karpenter_tpu_torch.api.validation import validate_storage_class

        validate_storage_class(sc)
        self.storage_classes[sc.name] = sc
        self._notify("StorageClass", "put", sc)
        return sc

    def put_pvc(self, pvc: PersistentVolumeClaim) -> PersistentVolumeClaim:
        # Immediate-mode claims provision as soon as they exist — the fake
        # PV controller picks the storage class's first allowed zone
        sc = self.storage_classes.get(pvc.storage_class)
        if (
            not pvc.bound_zone
            and sc is not None
            and sc.binding_mode == "Immediate"
            and sc.zones
        ):
            pvc.bound_zone = sc.zones[0]
        self.pvcs[pvc.key()] = pvc
        self._notify("PersistentVolumeClaim", "put", pvc)
        return pvc

    def put_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        self.pdbs[pdb.name] = pdb
        self._notify("PodDisruptionBudget", "put", pdb)
        return pdb

    def daemonset_pods(self) -> List[Pod]:
        """Template daemonset pods (one per daemonset) used for per-node
        overhead during scheduling."""
        seen = {}
        for p in self.pods.values():
            if p.is_daemonset:
                seen.setdefault(p.constraint_signature(), p)
        return list(seen.values())

    # -- leases --------------------------------------------------------------
    def try_acquire_lease(
        self, name: str, holder: str, now: float, duration_s: float
    ) -> bool:
        """Atomic acquire-or-renew (the coordination/v1 Lease update the
        reference's controller-runtime election performs): succeeds when
        the lease is free, expired, or already held by ``holder``.
        Watcher callbacks fire AFTER the lock is released — the lock is
        non-reentrant and a competing replica's election must not stall
        on a slow watcher."""
        from karpenter_tpu_torch.utils.leader import Lease

        acquired = None
        with self._lease_lock:
            note_access("KubeStore.leases")  # lockset witness
            lease = self.leases.get(name)
            if (
                lease is not None
                and lease.holder
                and lease.holder != holder
                and now - lease.renewed_at <= lease.duration_s
            ):
                return False  # held by a live other replica
            if lease is None or lease.holder != holder:
                lease = Lease(
                    name=name,
                    holder=holder,
                    acquired_at=now,
                    duration_s=duration_s,
                )
                self.leases[name] = lease
                acquired = lease
            lease.renewed_at = now
            lease.duration_s = duration_s
        if acquired is not None:
            self._notify("Lease", "acquire", acquired)
        return True

    def renew_lease(self, name: str, holder: str, now: float) -> bool:
        """Renew-ONLY: succeeds only while ``holder`` still holds the
        lease.  The background renewal thread uses this so it can never
        re-acquire a lease the graceful shutdown path just released."""
        with self._lease_lock:
            lease = self.leases.get(name)
            if lease is None or lease.holder != holder:
                return False
            lease.renewed_at = now
            return True

    def release_lease(self, name: str, holder: str) -> None:
        """Graceful give-up: only the current holder may free the lease."""
        released = None
        with self._lease_lock:
            lease = self.leases.get(name)
            if lease is not None and lease.holder == holder:
                lease.holder = ""
                lease.renewed_at = 0.0
                released = lease
        if released is not None:
            self._notify("Lease", "release", released)

    # -- events --------------------------------------------------------------
    def record_event(self, kind: str, reason: str, obj_name: str, message: str = ""):
        self.events.append((kind, reason, obj_name, message))
