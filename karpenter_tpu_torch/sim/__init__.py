"""Deterministic cluster simulator: scenario engine, trace record/replay,
invariants, SLO reports (docs/designs/simulation.md).

Drives the REAL Operator — every controller, the programmable fake cloud
with its chaos engine, the injected clock — through declarative,
time-compressed scenarios, so "as many scenarios as you can imagine" is a
registry entry and a seed instead of a bespoke soak loop.

Import surface is kept lazy-friendly: the heavy pieces (runner pulls in
the operator, which pulls in the solver and PyTorch) import on first use.
The runner takes the device the operator runs on (the card unless the
caller asks for the CPU), and so does the fleet runner (``sim/fleet.py``:
several real operators against one store server, four durable store
shards or one multi-tenant solver service), imported on its own.
"""

from karpenter_tpu_torch.sim.workload import (  # noqa: F401 (re-exports)
    BatchWaves,
    Churn,
    Diurnal,
    FlashCrowd,
    InstanceKiller,
    InterruptionStorm,
    Script,
    SimEvent,
    SoakChurn,
    Steady,
    Workload,
)

__all__ = [
    "BatchWaves",
    "Churn",
    "Diurnal",
    "FlashCrowd",
    "InstanceKiller",
    "InterruptionStorm",
    "Script",
    "SimEvent",
    "SoakChurn",
    "Steady",
    "Workload",
]
