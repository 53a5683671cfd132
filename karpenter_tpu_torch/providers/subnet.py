"""Subnet provider (reference pkg/providers/subnet/subnet.go).

Selector-terms -> subnets with a TTL cache; `zonal_subnets_for_launch`
picks the per-zone subnet with the most available IPs while tracking IPs
"spent" on launches still in flight (subnet.go:110-146), and
`update_inflight_ips` refunds the unchosen subnets once the launch returns
(subnet.go:149-207) — so concurrent launches don't over-subscribe a subnet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.api import NodeClass
from karpenter_tpu_torch.cache.ttl import DEFAULT_TTL, TTLCache
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, FakeSubnet
from karpenter_tpu_torch.providers.stale import StaleGuard
from karpenter_tpu_torch.utils.clock import Clock


class SubnetProvider:
    def __init__(self, cloud: FakeCloud, clock: Clock, registry=None):
        self.cloud = cloud
        self._cache = TTLCache(clock, DEFAULT_TTL)
        self._stale = StaleGuard("subnet", clock, registry)
        # subnet id -> IPs reserved by launches not yet confirmed
        self._inflight: Dict[str, int] = {}

    def list(self, node_class: NodeClass) -> List[FakeSubnet]:
        key = tuple(node_class.subnet_selector_terms)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        subnets, fresh = self._stale.fetch(
            key,
            lambda: self.cloud.describe_subnets(node_class.subnet_selector_terms),
        )
        if fresh:
            self._cache.set(key, subnets)
        return subnets

    def zonal_subnets_for_launch(
        self, node_class: NodeClass, zones: Optional[Sequence[str]] = None
    ) -> Dict[str, FakeSubnet]:
        """Best subnet per zone (most available IPs, minus in-flight
        reservations), charging one in-flight IP per returned zone."""
        best: Dict[str, FakeSubnet] = {}
        for s in self.list(node_class):
            if zones is not None and s.zone not in zones:
                continue
            avail = s.available_ips - self._inflight.get(s.id, 0)
            if avail <= 0:
                continue
            cur = best.get(s.zone)
            if cur is None or avail > (
                cur.available_ips - self._inflight.get(cur.id, 0)
            ):
                best[s.zone] = s
        for s in best.values():
            self._inflight[s.id] = self._inflight.get(s.id, 0) + 1
        return best

    def update_inflight_ips(
        self, chosen: Dict[str, FakeSubnet], launched_subnet_ids: Sequence[str]
    ) -> None:
        """After the launch returns, release every reservation taken by
        `zonal_subnets_for_launch`: subnets actually used now have the spend
        reflected in the cloud's own available_ips accounting, and unchosen
        subnets never consumed an IP.  Also refresh the cached view so the
        next launch sees up-to-date counts for the used subnets."""
        for s in chosen.values():
            n = self._inflight.get(s.id, 0)
            if n <= 0:
                continue
            self._inflight[s.id] = n - 1
            if self._inflight[s.id] == 0:
                del self._inflight[s.id]
        if launched_subnet_ids:
            self._cache.flush()

    def invalidate(self) -> None:
        self._cache.flush()
