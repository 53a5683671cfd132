"""Provisioning controller: pending pods -> NodeClaims -> launched machines.

Re-derivation of karpenter-core's provisioner (reference SURVEY.md §3.2):

- **pod batching window**: a batch opens when the first pending pod
  appears and closes after `provision_batch_idle_s` (1s) of quiet or
  `provision_batch_max_s` (10s) total (website v0.31 settings.md:43-47)
  — the same CoalesceWindow arithmetic the CreateFleet batcher uses
  (batcher/core.py), on the injected clock.
- **solve**: one scheduling pass over the batch via the tensor solver
  (`TorchScheduler`: the FFD kernels on the card, oracle fallback inside),
  against existing + in-flight nodes, daemonset overhead, and the per-pool
  instance-type inventory from the CloudProvider.
- **launch**: each new virtual node becomes a NodeClaim; pool limits are
  enforced before launch (reference designs/limits.md); claims launch
  concurrently so the CreateFleet batcher can coalesce them; pods are
  nominated onto their node so the next solve doesn't double-provision
  (state.Cluster podNominations).
- **capacity-error feedback**: a claim that fails with insufficient
  capacity is discarded — the ICE cache already masks the failed pools, so
  the pods re-enter the next batch and resolve onto different offerings.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.api import (
    NodeClaim,
    NodePool,
    Pod,
    Requirements,
    Resources,
    Settings,
)
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.batcher.core import CoalesceWindow
from karpenter_tpu_torch.cloud.provider import CloudProvider
from karpenter_tpu_torch.errors import is_insufficient_capacity
from karpenter_tpu_torch.pipeline import run_concurrently
from karpenter_tpu_torch.metrics.registry import (
    REGISTRY,
    Registry,
    export_compile_cache_counters,
    export_resident_counters,
)
from karpenter_tpu_torch.scheduling import fastpath
from karpenter_tpu_torch.scheduling.scheduler import SchedulingResult, VirtualNode
from karpenter_tpu_torch.scheduling.solver import TorchScheduler
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)


class PodBatcher:
    """The 1s-idle / 10s-max pending-pod window (settings.md:43-47),
    built on the same :class:`CoalesceWindow` deadline arithmetic the
    CreateFleet batcher's buckets use — one implementation of the
    reference's batching discipline for both layers — driven by the
    injected Clock so the window is deterministic under the simulator."""

    def __init__(self, clock: Clock, idle_s: float, max_s: float):
        self.clock = clock
        self._window = CoalesceWindow(idle_s, max_s)
        self._seen: set = set()

    def observe(self, pods: Sequence[Pod]) -> None:
        if not pods:
            return
        now = self.clock.now()
        new = {p.key() for p in pods} - self._seen
        # re-observing the same pending pods next tick is not an arrival:
        # only FRESH pods push the idle deadline out
        self._window.observe(now, fresh=bool(new) or not self._seen)
        self._seen |= {p.key() for p in pods}

    def ready(self) -> bool:
        return self._window.ready(self.clock.now())

    def reset(self) -> None:
        self._window.reset()
        self._seen = set()


class Provisioner:
    def __init__(
        self,
        kube: KubeStore,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        clock: Clock,
        settings: Optional[Settings] = None,
        registry: Registry = REGISTRY,
        device=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.settings = settings or Settings()
        self.registry = registry
        self.batcher = PodBatcher(
            clock,
            self.settings.provision_batch_idle_s,
            self.settings.provision_batch_max_s,
        )
        # long-lived scheduler: its compiled-catalog cache hits whenever the
        # instance-type provider serves the same cached inventory lists;
        # its pack runs on ``device`` (the card unless the caller asks for
        # the CPU)
        self.scheduler = TorchScheduler([], {}, device=device)
        # launch fan-out; 1 serializes launches in submission order — the
        # simulator's determinism contract (sim/runner.py) requires the
        # cloud-call stream to be reproducible, which thread scheduling is
        # not.  None/absent keeps the production concurrent path.
        self.launch_concurrency: Optional[int] = None
        # pod key -> clock time first observed pending, feeding the
        # karpenter_pods_time_to_schedule_seconds histogram (first-seen ->
        # nominated); the sim's SLO report reads its samples
        self._first_seen: Dict[str, float] = {}
        # compile-cache counter values already exported to the registry
        # (the scheduler counts monotonically; the registry counter gets
        # the per-reconcile delta)
        self._cc_exported = (0, 0)
        self._res_exported = (0, 0)  # resident hit/rebuild, same contract

    # -------------------------------------------------------------- reconcile
    def reconcile(self) -> List[NodeClaim]:
        """One controller tick: observe pending pods, provision when the
        batch window closes.  Returns the claims launched this tick."""
        pending = self._provisionable_pods()
        now = self.clock.now()
        for p in pending:
            self._first_seen.setdefault(p.key(), now)
        # prune first-seen entries for pods that vanished unscheduled
        # (deleted mid-wait) so the map cannot grow unboundedly
        if self._first_seen:
            live = self.kube.pods
            for key in [k for k in self._first_seen if k not in live]:
                del self._first_seen[key]
        # age of the OLDEST still-unnominated pending pod, on the injected
        # clock — the SLO engine's pending-pod-age signal (obs/slo.py);
        # deterministic, so a sim scenario can page on it
        self.registry.set(
            "karpenter_pods_pending_age_seconds",
            max((now - t0 for t0 in self._first_seen.values()), default=0.0),
        )
        # FRESH pods (never observed by the batcher) are the admission
        # fast path's input: computed BEFORE observe() marks them seen
        fresh = [p for p in pending if p.key() not in self.batcher._seen]
        self.batcher.observe(pending)
        if not pending:
            return []
        if (
            fresh
            and len(fresh) == len(pending)
            and self.settings.enable_admission_fastpath
        ):
            # single-pod / tiny-burst arrival with nothing else waiting:
            # try the sub-millisecond path (scatter + one admit dispatch
            # + oracle cross-check + nominate) before any batch window
            # opens.  Stale pending pods disqualify the tick — the admit
            # score equals the full solve only when the arriving class
            # is the sole work (docs/designs/admission-fastpath.md).
            claims = self._admit_fastpath(pending)
            if claims is not None:
                return claims
        if not self.batcher.ready():
            if (
                self.settings.provision_fastpath_bypass
                and len(pending) == 1
                and fresh
            ):
                # singleton-bypass bug fix: a lone pending pod with no
                # batch-mates used to wait the FULL idle window before
                # any solve — there is nothing to coalesce with, so when
                # the fast path declines (or is off), release it to the
                # batched solve immediately
                self.batcher.reset()
                return self.provision(pending)
            return []
        self.batcher.reset()
        return self.provision(pending)

    def _admit_fastpath(self, pods: Sequence[Pod]) -> Optional[List[NodeClaim]]:
        """One fast-path admission attempt.  Returns the tick's claim
        list ([] — nominations never launch nodes) when the pods were
        nominated, or None when the batched solve must run (fallback or
        mismatch, both counted with their reason)."""
        scheduler = self._sync_scheduler(pods)
        if scheduler is None:
            self.registry.inc(
                "karpenter_admission_fastpath_total", {"outcome": "fallback"}
            )
            self.registry.inc(
                "karpenter_admission_fastpath_fallback_total",
                {"reason": fastpath.REASON_NO_POOLS},
            )
            return None
        res = fastpath.try_admit(scheduler, pods)
        self.registry.inc(
            "karpenter_admission_fastpath_total", {"outcome": res.outcome}
        )
        if res.outcome == "mismatch":
            # convergence-contract violation: the device score disagreed
            # with the sequential host oracle.  Never trust the device
            # half of a disagreement — the batched solve decides.
            self.registry.inc("karpenter_admission_fastpath_mismatch_total")
            return None
        if res.outcome != "nominated":
            self.registry.inc(
                "karpenter_admission_fastpath_fallback_total",
                {"reason": res.reason},
            )
            return None
        for pod_key, node_name in res.placements.items():
            self.cluster.nominate(pod_key, node_name)
            self.registry.event(
                "PodNominated", pod=pod_key, node=node_name,
                placement="existing",
            )
            self._observe_scheduled(pod_key, path="fast")
        self.batcher.reset()
        return []

    def _provisionable_pods(self) -> List[Pod]:
        """Pending pods not already nominated onto an in-flight node."""
        out = []
        for p in self.kube.pending_pods():
            if p.is_daemonset:
                continue
            if self.cluster.nominated_node(p.key()) is not None:
                continue
            out.append(p)
        return out

    # -------------------------------------------------------------- provision
    def _sync_scheduler(self, pods: Sequence[Pod]) -> Optional[TorchScheduler]:
        """Sync the long-lived scheduler against the live snapshot: pool
        filter, volume-requirement resolution, inventory fetch, limits
        headroom, and the ONE sanctioned `scheduler.update` call for the
        provisioning layer (lint rule 4's allowlist points here) —
        shared by the batched solve and the admission fast path so both
        score against identical state.  Returns None when there is
        nothing to schedule against."""
        pools = [p for p in self.kube.node_pools.values() if not p.deleted]
        if not pools or not pods:
            return None
        for p in pods:
            resolve_volume_requirements(p, self.kube)
        inventory: Dict[str, list] = {}
        for pool in pools:
            try:
                inventory[pool.name] = self.cloud_provider.get_instance_types(pool)
            except Exception as exc:
                log.warning("inventory for pool %s failed: %s", pool.name, exc)
                inventory[pool.name] = []
        snapshot = self.cluster.snapshot()
        # limits-aware participation (reference designs/limits.md: a
        # provisioner at its limits stops launching): a limited pool only
        # offers the solve instance types that still FIT its remaining
        # headroom — otherwise the launch admission rejects every claim
        # and the batch's pods ping-pong on the full pool forever instead
        # of SPILLING to the next pool by weight.  The solve ALWAYS runs
        # (existing-node placement must work even with every pool limited
        # out); launch admission still bounds the batch's cumulative
        # overshoot, and convergence is across provisioning loops, like
        # the reference.
        usage_by_pool: Dict[str, Resources] = {}
        for sn in snapshot:
            if sn.pool_name and not sn.marked_for_deletion():
                cap = sn.capacity if sn.capacity else sn.allocatable
                usage_by_pool[sn.pool_name] = (
                    usage_by_pool.get(sn.pool_name, Resources()) + cap
                )
        for pool in pools:
            inventory[pool.name] = self._headroom_types(
                pool, inventory[pool.name],
                usage_by_pool.get(pool.name, Resources()),
            )
        ts = self.scheduler.update(
            pools,
            inventory,
            existing=snapshot,
            daemonsets=self.kube.daemonset_pods(),
        )
        if ts is not None:
            # open the resident cache's tick trust window over the fresh
            # snapshot: every refresh this tick (each fast-path admission,
            # the batched solve's delta) reuses one O(cluster) invariant
            # scan instead of paying it per call.  Nothing mutates
            # `existing` between here and those refreshes — the next
            # reconcile re-syncs and re-opens the window.
            ts._resident.note_sync(ts)
        return ts

    def provision(self, pods: Sequence[Pod]) -> List[NodeClaim]:
        """One scheduling solve + launches for a closed pod batch."""
        scheduler = self._sync_scheduler(pods)
        if scheduler is None:
            return []
        with self.registry.time("karpenter_provisioner_scheduling_duration_seconds"):
            result = scheduler.solve(pods)
        self.registry.inc(
            "karpenter_provisioner_scheduling_simulation_count",
            {"path": scheduler.last_path},
        )
        # solve latency anatomy: one histogram series per phase (disjoint
        # self-times summing to the solve's wall clock — see
        # TensorScheduler.solve / docs "solve latency anatomy")
        for phase_name, seconds in scheduler.last_phases.items():
            self.registry.observe(
                "karpenter_solver_phase_seconds",
                seconds,
                {"phase": phase_name},
            )
        self._cc_exported = export_compile_cache_counters(
            self.registry, scheduler, "provisioner", self._cc_exported
        )
        self._res_exported = export_resident_counters(
            self.registry, scheduler, "provisioner", self._res_exported
        )
        if scheduler.last_delta_rows >= 0:
            # delta size of a resident warm tick (scattered class rows +
            # live columns + usage rows; 0 = pure no-change hit) — the
            # sim report's solver.resident section reads its samples
            self.registry.observe(
                "karpenter_solver_resident_delta_rows",
                float(scheduler.last_delta_rows),
            )
        for pod_key, reason in result.unschedulable.items():
            self.kube.record_event("Pod", "FailedScheduling", pod_key, reason)
        # nominate pods placed on existing nodes (the kube-scheduler binds)
        for pod_key, node_name in result.existing_placements.items():
            self.cluster.nominate(pod_key, node_name)
            self.registry.event(
                "PodNominated", pod=pod_key, node=node_name, placement="existing"
            )
            self._observe_scheduled(pod_key)
        return self._launch(result)

    def _observe_scheduled(self, pod_key: str, path: str = "batch") -> None:
        """Pod first-seen-pending -> nominated latency (the scheduling SLO
        the sim report aggregates into p50/p95/p99), attributed to the
        admission path that nominated it (fast vs batch) on the split
        histogram; the legacy unsplit series keeps its full stream."""
        t0 = self._first_seen.pop(pod_key, None)
        if t0 is not None:
            dt = max(self.clock.now() - t0, 0.0)
            self.registry.observe(
                "karpenter_pods_time_to_schedule_seconds", dt
            )
            self.registry.observe(
                "karpenter_admission_latency_seconds", dt, {"path": path}
            )

    def _headroom_types(self, pool, types, usage: Resources) -> list:
        """The pool's instance types that still fit inside its remaining
        limit headroom on every limited axis.  Returns the ORIGINAL list
        object when nothing is filtered, preserving the identity-keyed
        catalog cache upstream."""
        if pool.limits.is_empty():
            return types
        remaining = {
            axis: limit - usage.get(axis)
            for axis, limit in pool.limits.items()
        }
        out = [
            it
            for it in types
            if all(
                it.capacity.get(axis) <= room + 1e-9
                for axis, room in remaining.items()
            )
        ]
        return types if len(out) == len(types) else out

    def _launch(self, result: SchedulingResult) -> List[NodeClaim]:
        claims: List[tuple] = []  # (claim, vnode)
        usage: Dict[str, Resources] = {}
        for vn in result.new_nodes:
            pool = vn.pool
            claim = self._claim_from_vnode(vn)
            # pool limits (reference designs/limits.md): projected usage
            # including in-flight claims must stay inside pool.limits
            if not pool.limits.is_empty():
                current = usage.get(pool.name)
                if current is None:
                    current = self.cluster.pool_usage(pool.name)
                projected = current + self._claim_capacity_estimate(vn)
                if projected.exceeds(pool.limits):
                    self.kube.record_event(
                        "NodePool", "LimitExceeded", pool.name,
                        f"cannot launch {claim.name}",
                    )
                    continue
                usage[pool.name] = projected
            claims.append((claim, vn))

        launched: List[NodeClaim] = []
        if not claims:
            return launched
        # fan the creates out through the sanctioned pipeline seam: the
        # validated launch_max_concurrency setting bounds the flush (the
        # chart can tune it), launch_concurrency=1 stays the simulator's
        # determinism knob (serial, claim order — pipeline.run_concurrently
        # degrades to the calling thread), and the in-flight gauge makes
        # a stuck CreateFleet visible while it is stuck
        workers = self.launch_concurrency or min(
            self.settings.launch_max_concurrency, len(claims)
        )
        self.registry.set("karpenter_launch_inflight", float(len(claims)))
        try:
            excs = run_concurrently(
                [
                    (lambda c=claim: self.cloud_provider.create(c))
                    for claim, _vn in claims
                ],
                max_workers=workers,
            )
        finally:
            self.registry.set("karpenter_launch_inflight", 0.0)
        outcomes = [
            (claim, vn, exc) for (claim, vn), exc in zip(claims, excs)
        ]
        for claim, vn, exc in outcomes:
            if exc is not None:
                if is_insufficient_capacity(exc):
                    # ICE cache already masks the pools; pods retry next
                    # batch (reference cloudprovider.go:101 semantics)
                    self.registry.inc("karpenter_nodeclaims_launch_failed",
                                      {"reason": "insufficient_capacity"})
                    self.kube.record_event(
                        "NodeClaim", "InsufficientCapacity", claim.name,
                        str(exc),
                    )
                else:
                    # per-claim isolation: one flaky cloud error must not
                    # kill the reconcile loop or strand the other claims'
                    # nominations (the reference logs-and-continues per
                    # machine); the pods re-enter the next batch
                    log.error("launch of %s failed", claim.name, exc_info=exc)
                    self.registry.inc("karpenter_nodeclaims_launch_failed",
                                      {"reason": "error"})
                    self.kube.record_event(
                        "NodeClaim", "LaunchFailed", claim.name, str(exc)
                    )
                continue
            self.kube.put_node_claim(claim)
            self.registry.inc(
                "karpenter_nodeclaims_launched", {"nodepool": claim.pool_name}
            )
            self.registry.event(
                "NodeLaunched",
                claim=claim.name,
                pool=claim.pool_name,
                pods=len(vn.pods),
            )
            for pod in vn.pods:
                self.cluster.nominate(pod.key(), claim.name)
                self.registry.event(
                    "PodNominated", pod=pod.key(), node=claim.name,
                    placement="new",
                )
                self._observe_scheduled(pod.key())
            launched.append(claim)
        return launched

    # ------------------------------------------------------------- claim gen
    def _claim_from_vnode(self, vn: VirtualNode) -> NodeClaim:
        return claim_from_vnode(vn)

    @staticmethod
    def _claim_capacity_estimate(vn: VirtualNode) -> Resources:
        it = next(iter(vn.final_instance_types()), None)
        return it.capacity if it is not None else vn.used


def volume_zone_requirements(pod: Pod, kube):
    """The pod's CURRENT volume-derived zone requirements, recomputed from
    the PVC/StorageClass state: bound claims pin the volume's zone, unbound
    WaitForFirstConsumer claims admit the storage class's allowed
    topologies (reference website v0.31 concepts/scheduling.md:387-411).

    Returns None for pods without volume claims (nothing to resolve), else
    the fresh requirement list — the caller decides whether/where to store
    it (the provisioner writes it onto its own pending pods; consolidation
    simulations resolve onto COPIES so shared live pods stay untouched)."""
    from karpenter_tpu_torch.api.requirements import Op, Requirement

    if not pod.volume_claims:
        return None
    zones = None
    for cname in pod.volume_claims:
        pvc = kube.pvcs.get(f"{pod.namespace}/{cname}")
        if pvc is None:
            continue  # claim not created yet: kubelet would block, not us
        if pvc.bound_zone:
            z = {pvc.bound_zone}
        else:
            sc = kube.storage_classes.get(pvc.storage_class)
            if sc is None or not sc.zones:
                continue  # topology-unconstrained storage
            z = set(sc.zones)
        zones = z if zones is None else zones & z
    if zones is None:
        return []
    # an empty intersection compiles to an unsatisfiable requirement,
    # surfacing the conflict as an unschedulable pod with a reason
    return [Requirement(L.LABEL_ZONE, Op.IN, sorted(zones))]


def resolve_volume_requirements(pod: Pod, kube) -> None:
    """Refresh a pod's volume-derived zone requirements before a solve.

    Idempotent — the field is REPLACED each pass, so a claim that bound
    since the last solve tightens the requirement instead of stacking; a
    no-op recomputation skips the write entirely so the pod's mutation
    epoch (and with it every identity-keyed compile cache) stays put."""
    new = volume_zone_requirements(pod, kube)
    if new is not None and new != pod.volume_requirements:
        pod.volume_requirements = new


def claim_from_vnode(vn: VirtualNode) -> NodeClaim:
    """Virtual node -> NodeClaim handshake object (the launch request the
    CloudProvider consumes; reference cloudprovider.go:94-120).  Used by the
    provisioner and by consolidation's replacement pre-spin."""
    from karpenter_tpu_torch.api.requirements import Op, Requirement

    pool = vn.pool
    reqs = Requirements(iter(vn.requirements))
    # constrain to the vnode's feasible types, price-ascending; top-60
    # truncation happens in the instance provider
    type_names = [t.name for t in vn.final_instance_types()]
    if type_names:
        reqs.add(Requirement(L.LABEL_INSTANCE_TYPE, Op.IN, type_names))
    return NodeClaim(
        pool_name=pool.name,
        node_class_ref=pool.node_class_ref,
        requirements=reqs,
        requests=vn.used,
        taints=list(pool.taints),
        startup_taints=list(pool.startup_taints),
        labels={**pool.labels, L.LABEL_NODEPOOL: pool.name},
        annotations=dict(pool.annotations),
        kubelet_max_pods=pool.kubelet_max_pods,
    )
