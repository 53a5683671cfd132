"""Lease-based leader election.

The reference runs two controller replicas behind controller-runtime's
leader election (core operator wires it; charts/karpenter/templates/
deployment.yaml ships ``replicas: 2`` + a PodDisruptionBudget, and the
election uses a coordination.k8s.io/v1 Lease).  Here the Lease lives in
the shared cluster store — in-process `KubeStore` for a single replica,
`RemoteKubeStore` over a `StoreServer` (service/store_server.py) when
replicas actually share state — and the elector runs the client-go loop:
acquire when the lease is free or expired, renew while held, retry every
``RETRY_PERIOD`` otherwise.  Non-leaders keep their caches warm by
watching the store but skip every reconcile (operator.py:reconcile_once).

Timings mirror controller-runtime's defaults (LeaseDuration 15s,
RetryPeriod 2s): a crashed leader stops renewing and the standby takes
over within one lease duration.  All durations are measured on the SAME
injected Clock that stamps the lease timestamps — under an accelerated
simulated clock the renewal cadence accelerates with it, so the 15s
lease cannot expire between renewals that a wall-clock pacer would have
spaced 2 real seconds apart.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from karpenter_tpu_torch.analysis.sanitizer import make_lock

log = logging.getLogger(__name__)

# controller-runtime defaults (leaderelection.go)
LEASE_DURATION_S = 15.0
RETRY_PERIOD_S = 2.0
LEASE_NAME = "karpenter-tpu-leader-election"

# real-time poll while waiting out a (possibly simulated) retry period;
# the renewal thread wakes this often to check the injected clock
_POLL_S = 0.05


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease projection."""

    name: str
    holder: str = ""
    acquired_at: float = 0.0
    renewed_at: float = 0.0
    duration_s: float = LEASE_DURATION_S


class LeaderElector:
    """One replica's view of the election.

    ``acquire_or_renew`` is the per-tick gate: True while this identity
    holds (or just took) the lease.  Transitions are observable through
    ``leading`` and the ``karpenter_leader_election_leading`` gauge the
    operator exports.

    Thread model: ``leading`` is written by the reconcile thread
    (acquire_or_renew/release) and by the background renewal thread, and
    read by both — writes go through the property setter under ``_lock``;
    reads are a single attribute load (atomic under the GIL).  A reader
    may observe a stale True for at most one transition, which is why the
    operator's mid-tick gate uses ``still_leading()``: it cross-checks
    the last successful renewal against the lease duration on the shared
    clock, so even a WEDGED renewal thread (lost, not just failing)
    cannot leave a deposed leader mutating past expiry — the reference
    gets the same fencing from controller-runtime's RenewDeadline.
    """

    def __init__(
        self,
        kube,
        clock,
        identity: str,
        lease_name: str = LEASE_NAME,
        lease_duration_s: float = LEASE_DURATION_S,
    ):
        self.kube = kube
        self.clock = clock
        self.identity = identity
        self.lease_name = lease_name
        self.lease_duration_s = lease_duration_s
        self._lock = make_lock("LeaderElector._lock")
        self._leading = False
        # clock timestamp of the last successful acquire/renew; the
        # still_leading() fence compares it against the lease duration
        self.renewed_at = 0.0

    @property
    def leading(self) -> bool:
        return self._leading

    @leading.setter
    def leading(self, value: bool) -> None:
        with self._lock:
            self._leading = bool(value)

    def _mark(self, ok: bool) -> None:
        with self._lock:
            self._leading = ok
            if ok:
                self.renewed_at = self.clock.now()

    def still_leading(self) -> bool:
        """Mid-tick gate: leading AND the last successful renewal is
        younger than the lease duration.  A leader whose renewal thread
        died keeps ``leading`` True but fails this check the moment the
        lease could have expired under it — it abdicates before the next
        controller mutates anything, so a standby that legitimately took
        the expired lease is the single writer."""
        return self._leading and (
            self.clock.now() - self.renewed_at < self.lease_duration_s
        )

    def acquire_or_renew(self) -> bool:
        """Try to take or keep the lease; updates ``leading``."""
        now = self.clock.now()
        was = self._leading
        ok = self.kube.try_acquire_lease(
            self.lease_name, self.identity, now, self.lease_duration_s
        )
        self._mark(ok)
        if ok and not was:
            self.kube.record_event(
                "Lease", "LeaderElected", self.lease_name, self.identity
            )
        return ok

    def release(self) -> None:
        """Graceful handoff: free the lease so the standby can take it
        immediately instead of waiting out the expiry."""
        if self._leading:
            self.kube.release_lease(self.lease_name, self.identity)
            self.leading = False

    def start_background_renewal(self, stop) -> None:
        """Renew every RETRY_PERIOD (on the injected clock) while leading,
        on a daemon thread, so a reconcile tick longer than the lease
        duration does not silently expire the lease under a healthy
        leader (controller-runtime renews on the same cadence).  On a
        failed renewal — the lease was lost — ``leading`` flips False,
        and the operator abdicates at its next between-controller check
        (operator.reconcile_once).  A WEDGED leader (renewal thread lost
        entirely) is fenced twice: by lease expiry for the standby, and
        by ``still_leading()``'s renewal-age check for itself."""

        def renew() -> None:
            next_at = self.clock.now() + RETRY_PERIOD_S
            # poll real time, pace on the injected clock: a simulated
            # clock may jump an hour between 50ms polls and the cadence
            # must follow it (wall-clock pacing would let the lease
            # expire between renewals under an accelerated clock)
            while not stop.wait(_POLL_S):
                now = self.clock.now()
                if now < next_at:
                    continue
                next_at = now + RETRY_PERIOD_S
                if self._leading:
                    # renew-ONLY (never acquire): a release() racing this
                    # thread must not see the freed lease re-taken by the
                    # exiting process
                    try:
                        self._mark(
                            self.kube.renew_lease(
                                self.lease_name, self.identity, self.clock.now()
                            )
                        )
                    except Exception:
                        # an unexpected error (e.g. a remote store's flush
                        # tripping over a concurrent in-place mutation)
                        # must not KILL the renewal thread — a dead
                        # renewer silently expires the lease under a
                        # healthy leader.  Leave `leading` as-is and retry
                        # next period; still_leading() bounds how long a
                        # persistently-failing renewal can stay leader
                        log.exception("lease renewal attempt failed; retrying")

        threading.Thread(target=renew, daemon=True).start()
