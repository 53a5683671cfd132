"""Cluster-state metrics exporters (reference karpenter-core's metrics
controllers: the node/pod state gauges and provisioner usage series
published at website v0.31 concepts/metrics.md).

Per reconcile it republishes:

- karpenter_nodes_allocatable / karpenter_nodes_total_pod_requests /
  karpenter_nodes_total_daemon_requests / karpenter_nodes_system_overhead
  {node_name, nodepool, resource_type}
- karpenter_pods_state{phase}
- karpenter_pods_startup_time_seconds — histogram of pod-seen-pending ->
  bound latency (the reference measures created->running; the store keeps
  no creation timestamps, so first-seen is the anchor)
- karpenter_provisioner_usage / _limit / _usage_pct
  {nodepool, resource_type}
- karpenter_nodes_created{nodepool} — counter of nodes first observed

Gauge families are fully re-emitted each pass (stale series for vanished
nodes/pools are dropped), mirroring how the reference's collectors rebuild
their metric sets per reconcile.
"""

from __future__ import annotations

from typing import Dict, Set

from karpenter_tpu_torch.api import Resources
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock


class MetricsStateController:
    def __init__(
        self,
        kube: KubeStore,
        cluster: Cluster,
        clock: Clock,
        registry: Registry = REGISTRY,
    ):
        self.kube = kube
        self.cluster = cluster
        self.clock = clock
        self.registry = registry
        self._pending_since: Dict[str, float] = {}
        self._seen_nodes: Set[str] = set()

    def reconcile(self) -> None:
        snapshot = self.cluster.snapshot()
        self._pod_metrics()
        self._node_metrics(snapshot)
        self._pool_metrics(snapshot)

    # ------------------------------------------------------------------ pods
    def _pod_metrics(self) -> None:
        reg = self.registry
        now = self.clock.now()
        phases: Dict[str, int] = {}
        for key, pod in self.kube.pods.items():
            phase = pod.phase if not pod.node_name else "Bound"
            phases[phase] = phases.get(phase, 0) + 1
            if pod.node_name:
                since = self._pending_since.pop(key, None)
                if since is not None:
                    reg.observe(
                        "karpenter_pods_startup_time_seconds", now - since
                    )
            elif key not in self._pending_since:
                self._pending_since[key] = now
        # drop deleted pods from the pending ledger
        for key in list(self._pending_since):
            if key not in self.kube.pods:
                del self._pending_since[key]
        reg.reset_gauge("karpenter_pods_state")
        for phase, count in phases.items():
            reg.set("karpenter_pods_state", count, {"phase": phase})

    # ----------------------------------------------------------------- nodes
    def _node_metrics(self, snapshot) -> None:
        reg = self.registry
        for name in (
            "karpenter_nodes_allocatable",
            "karpenter_nodes_total_pod_requests",
            "karpenter_nodes_total_daemon_requests",
            "karpenter_nodes_system_overhead",
        ):
            reg.reset_gauge(name)
        for sn in snapshot:
            if sn.node is None:
                continue
            if sn.name not in self._seen_nodes:
                self._seen_nodes.add(sn.name)
                reg.inc("karpenter_nodes_created", {"nodepool": sn.pool_name})
            base = {"node_name": sn.name, "nodepool": sn.pool_name}
            pod_req = Resources()
            daemon_req = Resources()
            for p in sn.pods:
                if p.is_daemonset:
                    daemon_req = daemon_req + p.requests
                else:
                    pod_req = pod_req + p.requests
            overhead = (sn.capacity - sn.allocatable).clamp_nonnegative()
            for metric, res in (
                ("karpenter_nodes_allocatable", sn.allocatable),
                ("karpenter_nodes_total_pod_requests", pod_req),
                ("karpenter_nodes_total_daemon_requests", daemon_req),
                ("karpenter_nodes_system_overhead", overhead),
            ):
                for rtype, value in res.items():
                    reg.set(metric, value, {**base, "resource_type": rtype})

    # ----------------------------------------------------------------- pools
    def _pool_metrics(self, snapshot) -> None:
        reg = self.registry
        for name in (
            "karpenter_provisioner_usage",
            "karpenter_provisioner_limit",
            "karpenter_provisioner_usage_pct",
        ):
            reg.reset_gauge(name)
        # per-pool usage aggregated from the ONE snapshot this pass took
        # (Cluster.pool_usage would rebuild a snapshot per pool)
        usage_by_pool: Dict[str, Resources] = {}
        for sn in snapshot:
            if sn.pool_name and not sn.marked_for_deletion():
                cap = sn.capacity if sn.capacity else sn.allocatable
                usage_by_pool[sn.pool_name] = (
                    usage_by_pool.get(sn.pool_name, Resources()) + cap
                )
        for name, pool in self.kube.node_pools.items():
            if pool.deleted:
                continue
            usage = usage_by_pool.get(name, Resources())
            for rtype, value in usage.items():
                reg.set(
                    "karpenter_provisioner_usage",
                    value,
                    {"nodepool": name, "resource_type": rtype},
                )
            for rtype, limit in pool.limits.items():
                reg.set(
                    "karpenter_provisioner_limit",
                    limit,
                    {"nodepool": name, "resource_type": rtype},
                )
                if limit > 0:
                    reg.set(
                        "karpenter_provisioner_usage_pct",
                        usage.get(rtype) / limit,
                        {"nodepool": name, "resource_type": rtype},
                    )
