"""API data model: the CRD-equivalent objects and the requirements algebra
(port copy of ``karpenter_tpu/api``, without Settings and the operator's
objects)."""

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
    reset_name_sequences,
)
