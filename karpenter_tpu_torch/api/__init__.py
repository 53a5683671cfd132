"""API data model: the CRD-equivalent objects, the requirements algebra and
the operator's Settings (port copy of ``karpenter_tpu/api``)."""

from karpenter_tpu_torch.api.labels import *  # noqa: F401,F403
from karpenter_tpu_torch.api.resources import Resources, parse_quantity  # noqa: F401
from karpenter_tpu_torch.api.requirements import Requirement, Requirements, Op  # noqa: F401
from karpenter_tpu_torch.api.objects import (  # noqa: F401
    Taint,
    Toleration,
    TopologySpreadConstraint,
    PodAffinityTerm,
    Pod,
    Offering,
    Offerings,
    Overhead,
    InstanceType,
    Disruption,
    NodePool,
    NodeClaim,
    NodeClaimCondition,
    NodeClass,
    PersistentVolumeClaim,
    StorageClass,
    reset_name_sequences,
)
from karpenter_tpu_torch.api.settings import Settings  # noqa: F401
