"""Control loops of the port's operator: provisioning, lifecycle,
interruption, disruption, link, termination, garbage collection, node
class, tagging, metrics state and consistency."""

from karpenter_tpu_torch.controllers.consistency import ConsistencyController
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.controllers.garbagecollection import GarbageCollectionController
from karpenter_tpu_torch.controllers.interruption import InterruptionController
from karpenter_tpu_torch.controllers.lifecycle import LifecycleController
from karpenter_tpu_torch.controllers.metrics_state import MetricsStateController
from karpenter_tpu_torch.controllers.nodeclass import NodeClassController
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.controllers.tagging import TaggingController
from karpenter_tpu_torch.controllers.termination import TerminationController

__all__ = [
    "ConsistencyController",
    "DisruptionController",
    "GarbageCollectionController",
    "InterruptionController",
    "LifecycleController",
    "MetricsStateController",
    "NodeClassController",
    "Provisioner",
    "TaggingController",
    "TerminationController",
]
