from karpenter_tpu_torch.scheduling.scheduler import Scheduler, SchedulingResult, VirtualNode  # noqa: F401
from karpenter_tpu_torch.scheduling.solver import TorchScheduler  # noqa: F401
