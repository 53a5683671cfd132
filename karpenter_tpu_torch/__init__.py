"""karpenter_tpu_torch: the provisioning solve on PyTorch and CUDA.

The port of ``karpenter_tpu`` (JAX on a TPU) to one NVIDIA H100.  It
imports torch and numpy and nothing of the JAX package: the host modules it
needs are copies kept under the same names (api, ops/tensorize,
scheduling/scheduler, scheduling/topology).  The device half of the solve is
a hand-written CUDA kernel (csrc/ffd_pack.cu) with a plain PyTorch twin
(ops/packer.py:pack_reference) that runs for CPU tensors.

`TorchScheduler` loads on first access (PEP 562), so importing a module of
the package imports only what that module needs: the runtime lock
sanitizer (``analysis/sanitizer.py``) can be enabled before any module
that builds a lock at import time is loaded.
"""


def __getattr__(name: str):
    if name == "TorchScheduler":
        from karpenter_tpu_torch.scheduling.solver import TorchScheduler

        return TorchScheduler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
