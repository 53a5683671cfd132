"""The scheduling view of a live node.

Trimmed port of ``karpenter_tpu/state/cluster.py``: only `StateNode`, with
the fields of the kube `Node` and the `NodeClaim` that the solve reads
(cordon, deletion, readiness).  The store and the `Cluster` snapshot builder
wait for the operator slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.api import Pod, Resources, Taint
from karpenter_tpu_torch.api import labels as L


@dataclass
class Node:
    """The fields of a registered kube Node the solve reads."""

    name: str
    ready: bool = True
    cordoned: bool = False
    deleted_at: Optional[float] = None


@dataclass
class NodeClaim:
    """The fields of an in-flight NodeClaim the solve reads."""

    name: str
    initialized: bool = False
    deleted_at: Optional[float] = None


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
