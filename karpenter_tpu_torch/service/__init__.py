"""Solver sidecar: the distributed boundary between the controller half
and the accelerator half (SURVEY.md §5 north-star).  With
``multi_tenant`` on, the same process is the fleet-serving SolverService
(docs/designs/solver-service.md).  Port of ``karpenter_tpu/service/``:
the solver service, and the shared cluster store's server
(``store_server.py``: `StoreServer`, `VersionedStore`, the
``store-server`` subcommand), its shard router (``shardrouter.py``) and
its watch client (``watchclient.py``); the store's client is
``state/remote.py``'s `RemoteKubeStore`."""

from karpenter_tpu_torch.service.client import (
    RemoteSolver,
    SolverBusyError,
    SolverUnavailableError,
)
from karpenter_tpu_torch.service.server import SolverServer, SolverService

__all__ = [
    "RemoteSolver",
    "SolverBusyError",
    "SolverServer",
    "SolverService",
    "SolverUnavailableError",
]
