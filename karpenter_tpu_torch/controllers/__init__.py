"""Control loops of the port's operator: provisioning, lifecycle, link,
termination, garbage collection, node class and tagging (the disruption,
interruption, metrics-state and consistency loops are not ported yet)."""

from karpenter_tpu_torch.controllers.garbagecollection import GarbageCollectionController
from karpenter_tpu_torch.controllers.lifecycle import LifecycleController
from karpenter_tpu_torch.controllers.nodeclass import NodeClassController
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.controllers.tagging import TaggingController
from karpenter_tpu_torch.controllers.termination import TerminationController

__all__ = [
    "GarbageCollectionController",
    "LifecycleController",
    "NodeClassController",
    "Provisioner",
    "TaggingController",
    "TerminationController",
]
