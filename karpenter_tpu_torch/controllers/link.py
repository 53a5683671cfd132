"""NodeClaim link controller (reference
pkg/controllers/nodeclaim/link/controller.go:66-144): adopt cloud
instances that carry our pool tags but have no NodeClaim — controller
restarts, migrations, or claims lost to a crashed write.  Creating the
linkage claim prevents the GC controller from reaping a healthy machine;
the two controllers share the recently-linked awareness through the claim
store itself (a linked instance has a claim by the time GC lists)."""

from __future__ import annotations

import logging

from karpenter_tpu_torch.api import NodeClaim, NodeClaimCondition
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.provider import CloudProvider
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.state.kube import KubeStore

log = logging.getLogger(__name__)


class LinkController:
    def __init__(
        self,
        kube: KubeStore,
        cloud_provider: CloudProvider,
        registry: Registry = REGISTRY,
    ):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.registry = registry

    def reconcile(self) -> None:
        claimed = {
            c.provider_id for c in self.kube.node_claims.values() if c.provider_id
        }
        for found in self.cloud_provider.list():
            if found.provider_id in claimed:
                continue
            if not found.pool_name:
                continue  # not launched for any pool; GC's problem
            if found.pool_name not in self.kube.node_pools:
                continue  # pool gone; GC reaps after grace
            self._adopt(found)
            claimed.add(found.provider_id)
        # re-hydrate adopted claims whose catalog lookup failed earlier
        for claim in self.kube.node_claims.values():
            if claim.provider_id and claim.capacity.is_zero():
                pool = self.kube.node_pools.get(claim.pool_name)
                if pool is not None:
                    self._hydrate(claim, pool)

    def _adopt(self, found: NodeClaim) -> None:
        log.info(
            "linking instance %s to pool %s", found.provider_id, found.pool_name
        )
        pool = self.kube.node_pools[found.pool_name]
        # Name tags are not unique across instances; the claim name must be.
        name = found.name
        existing = self.kube.node_claims.get(name)
        if existing is not None and existing.provider_id != found.provider_id:
            name = found.provider_id
        claim = NodeClaim(
            name=name,
            pool_name=found.pool_name,
            node_class_ref=pool.node_class_ref,
            provider_id=found.provider_id,
            instance_type_name=found.instance_type_name,
            zone=found.zone,
            capacity_type=found.capacity_type,
            image_id=found.image_id,
            labels=dict(found.labels),
            taints=list(pool.taints),
            created_at=found.created_at,
        )
        claim.set_condition(NodeClaimCondition.LAUNCHED)
        # hydrate capacity/allocatable from the catalog so scheduling and
        # consolidation see real numbers; a failed hydration still adopts
        # (so GC cannot reap a healthy machine) and retries next reconcile
        self._hydrate(claim, pool)
        self.kube.put_node_claim(claim)
        self.registry.inc(
            "karpenter_nodeclaims_linked", {"nodepool": found.pool_name}
        )

    def _hydrate(self, claim: NodeClaim, pool) -> None:
        try:
            for it in self.cloud_provider.get_instance_types(pool):
                if it.name == claim.instance_type_name:
                    claim.capacity = it.capacity
                    claim.allocatable = it.allocatable()
                    off = [
                        o
                        for o in it.offerings
                        if o.zone == claim.zone
                        and o.capacity_type == claim.capacity_type
                    ]
                    if off:
                        claim.price = off[0].price
                    return
        except Exception as exc:
            log.warning(
                "capacity hydration for linked claim %s failed (will retry): %s",
                claim.name, exc,
            )
