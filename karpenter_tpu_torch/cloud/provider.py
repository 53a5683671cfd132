"""CloudProvider facade: the plugin boundary between the scheduling core
and the cloud (reference pkg/cloudprovider/cloudprovider.go:68-231).

Stateless composition of the domain providers; all caching lives below
(SURVEY.md L3).  Implements the core-facing contract:
`create / delete / get / list / get_instance_types / is_drifted / name`,
plus the instance -> NodeClaim status projection (cloudprovider.go:348-383)
and drift reasons (drift.go:34-40).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.api import (
    InstanceType,
    NodeClaim,
    NodeClass,
    NodeClaimCondition,
    NodePool,
    Requirements,
    Resources,
)
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, FakeInstance
from karpenter_tpu_torch.errors import NodeClaimNotFoundError
from karpenter_tpu_torch.providers.image import ImageProvider
from karpenter_tpu_torch.providers.instance import InstanceProvider
from karpenter_tpu_torch.providers.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.state.kube import KubeStore

# drift reasons (reference drift.go:34-40)
DRIFT_IMAGE = "ImageDrift"
DRIFT_SUBNET = "SubnetDrift"
DRIFT_SECURITY_GROUP = "SecurityGroupDrift"
DRIFT_NODECLASS = "NodeClassDrift"


@dataclass
class ProviderBundle:
    """The domain providers the facade composes (wired by the operator)."""

    instance_types: InstanceTypeProvider
    instances: InstanceProvider
    images: ImageProvider
    subnets: SubnetProvider
    security_groups: SecurityGroupProvider


class CloudProvider:
    """The core-facing plugin (reference cloudprovider.go:70-91)."""

    def __init__(self, cloud: FakeCloud, kube: KubeStore, providers: ProviderBundle):
        self.cloud = cloud
        self.kube = kube
        self.p = providers

    def name(self) -> str:
        return "karpenter-tpu"

    # ------------------------------------------------------------------ create
    def create(self, claim: NodeClaim) -> NodeClaim:
        """Launch a machine for the claim and fill in its status
        (reference cloudprovider.go:94-120)."""
        node_class = self._node_class(claim.node_class_ref)
        types = self._resolve_instance_types(claim, node_class)
        instance = self.p.instances.create(claim, node_class, types)
        it = next((t for t in types if t.name == instance.instance_type), None)
        self._project(claim, instance, it, node_class)
        claim.set_condition(NodeClaimCondition.LAUNCHED)
        return claim

    def _resolve_instance_types(
        self, claim: NodeClaim, node_class: NodeClass
    ) -> List[InstanceType]:
        """Pre-filter: requirements-compatible ∧ any available offering ∧
        resources fit (reference cloudprovider.go:296-307)."""
        pool_stub = NodePool(name=claim.pool_name, kubelet_max_pods=claim.kubelet_max_pods)
        all_types = self.p.instance_types.list(pool_stub, node_class)
        out = []
        for it in all_types:
            if not it.requirements.compatible(claim.requirements, allow_undefined=True):
                continue
            if not it.offerings.available().compatible(claim.requirements):
                continue
            if not claim.requests.fits(it.allocatable()):
                continue
            out.append(it)
        return out

    def _project(
        self,
        claim: NodeClaim,
        instance: FakeInstance,
        it: Optional[InstanceType],
        node_class: NodeClass,
    ) -> None:
        """instance -> NodeClaim status (reference cloudprovider.go:348-383)."""
        claim.provider_id = instance.id
        claim.instance_type_name = instance.instance_type
        claim.zone = instance.zone
        claim.capacity_type = instance.capacity_type
        claim.image_id = instance.image_id
        claim.created_at = instance.launch_time
        if it is not None:
            claim.labels.update(it.requirements.labels())
            claim.capacity = it.capacity
            claim.allocatable = it.allocatable()
            off = [
                o
                for o in it.offerings
                if o.zone == instance.zone
                and o.capacity_type == instance.capacity_type
            ]
            if off:
                claim.price = off[0].price
        # the launched instance is authoritative for placement labels; it
        # must win over any type-requirement projection
        claim.labels.update(
            {
                L.LABEL_INSTANCE_TYPE: instance.instance_type,
                L.LABEL_ZONE: instance.zone,
                L.LABEL_CAPACITY_TYPE: instance.capacity_type,
                L.LABEL_NODEPOOL: claim.pool_name,
            }
        )
        claim.annotations[L.ANNOTATION_NODECLASS_HASH] = node_class.static_hash()

    # ----------------------------------------------------------- get/list/del
    def get(self, provider_id: str) -> NodeClaim:
        instance = self.p.instances.get(provider_id)
        return self._instance_to_claim(instance)

    def list(self) -> List[NodeClaim]:
        return [self._instance_to_claim(i) for i in self.p.instances.list()]

    def delete(self, claim: NodeClaim) -> None:
        """Terminate the backing machine (reference cloudprovider.go:193-203)."""
        if not claim.provider_id:
            raise NodeClaimNotFoundError(claim.name)
        self.p.instances.delete(claim.provider_id)

    def _instance_to_claim(self, instance: FakeInstance) -> NodeClaim:
        claim = NodeClaim(
            name=instance.tags.get("Name", instance.id),
            pool_name=instance.tags.get("karpenter.sh/nodepool", ""),
            provider_id=instance.id,
            instance_type_name=instance.instance_type,
            zone=instance.zone,
            capacity_type=instance.capacity_type,
            image_id=instance.image_id,
            created_at=instance.launch_time,
        )
        claim.labels = {
            L.LABEL_INSTANCE_TYPE: instance.instance_type,
            L.LABEL_ZONE: instance.zone,
            L.LABEL_CAPACITY_TYPE: instance.capacity_type,
        }
        if claim.pool_name:
            claim.labels[L.LABEL_NODEPOOL] = claim.pool_name
        return claim

    # -------------------------------------------------------- instance types
    def get_instance_types(self, pool: NodePool) -> List[InstanceType]:
        """The scheduler's inventory feed (reference
        cloudprovider.go:171-191)."""
        node_class = self._node_class(pool.node_class_ref)
        return self.p.instance_types.list(pool, node_class)

    # ----------------------------------------------------------------- drift
    def is_drifted(self, claim: NodeClaim) -> str:
        """Drift reason or "" (reference drift.go:42-67: static-hash check
        first, then live image/subnet/security-group comparison)."""
        if not claim.provider_id:
            return ""
        node_class = self.kube.get_node_class(claim.node_class_ref)
        if node_class is None:
            return ""
        stamped = claim.annotations.get(L.ANNOTATION_NODECLASS_HASH)
        if stamped is not None and stamped != node_class.static_hash():
            return DRIFT_NODECLASS
        if node_class.launch_template_name:
            # static-template nodes launch whatever the user's template says;
            # comparing against resolver-managed images/SGs would flag every
            # such node drifted forever (the reference skips live comparison
            # for spec.launchTemplateName node classes the same way)
            return ""
        try:
            instance = self.p.instances.get(claim.provider_id)
        except NodeClaimNotFoundError:
            return ""
        # image drift: instance image no longer among resolved candidates
        valid_images = {c.image.id for c in self.p.images.list(node_class)}
        if valid_images and instance.image_id and instance.image_id not in valid_images:
            return DRIFT_IMAGE
        # subnet drift
        valid_subnets = {s.id for s in self.p.subnets.list(node_class)}
        if valid_subnets and instance.subnet_id and instance.subnet_id not in valid_subnets:
            return DRIFT_SUBNET
        # security-group drift
        valid_sgs = {g.id for g in self.p.security_groups.list(node_class)}
        if valid_sgs and instance.security_group_ids and set(
            instance.security_group_ids
        ) != valid_sgs:
            return DRIFT_SECURITY_GROUP
        return ""

    # ------------------------------------------------------------- internals
    def _node_class(self, ref: str) -> NodeClass:
        nc = self.kube.get_node_class(ref)
        if nc is None:
            raise NodeClaimNotFoundError(f"nodeclass {ref}")
        return nc
