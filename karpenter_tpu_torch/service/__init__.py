"""Solver sidecar: the distributed boundary between the controller half
and the accelerator half (SURVEY.md §5 north-star).  With
``multi_tenant`` on, the same process is the fleet-serving SolverService
(docs/designs/solver-service.md).  Port of ``karpenter_tpu/service/``:
the solver service, and the shared cluster store's server
(``store_server.py``: `StoreServer`, `VersionedStore`, the
``store-server`` subcommand), its shard router (``shardrouter.py``) and
its watch client (``watchclient.py``); the store's client is
``state/remote.py``'s `RemoteKubeStore`."""

import importlib

# loaded on first use: the store server (``store_server.py``) is a process
# of its own that needs neither the solver nor torch
_EXPORTS = {
    "RemoteSolver": "client",
    "SolverBusyError": "client",
    "SolverUnavailableError": "client",
    "SolverServer": "server",
    "SolverService": "server",
}


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "RemoteSolver",
    "SolverBusyError",
    "SolverServer",
    "SolverService",
    "SolverUnavailableError",
]
