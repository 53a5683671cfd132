"""The Lease object of lease-based leader election.

Port copy of the `Lease` type of ``karpenter_tpu/utils/leader.py``, the one
piece the cluster store holds.  The elector (`LeaderElector`) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

# controller-runtime defaults (leaderelection.go)
LEASE_DURATION_S = 15.0
LEASE_NAME = "karpenter-tpu-leader-election"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease projection."""

    name: str
    holder: str = ""
    acquired_at: float = 0.0
    renewed_at: float = 0.0
    duration_s: float = LEASE_DURATION_S
