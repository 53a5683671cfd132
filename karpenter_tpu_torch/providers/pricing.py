"""Pricing provider (reference pkg/providers/pricing/pricing.go:50-143).

Seeds on-demand prices from the cloud catalog at construction (the analogue
of the compiled-in zz_generated price tables), then refreshes on demand /
via the pricing controller: on-demand from the pricing API (GetProducts),
spot per-zone from spot price history, with the on-demand default-price
fallback until the first spot update (pricing.go:130-143).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

from karpenter_tpu_torch.cloud.fake.backend import CloudAPIError, FakeCloud
from karpenter_tpu_torch.providers.stale import STALENESS_METRIC

log = logging.getLogger(__name__)

PRICING_UPDATE_PERIOD = 12 * 3600.0  # reference pricing/controller.go:39-41
# a FAILED refresh is re-attempted on this cadence instead of waiting out
# the full 12h window — a one-minute API blip must not mean 12h-stale prices
PRICING_RETRY_PERIOD = 60.0


class PricingProvider:
    def __init__(self, cloud: FakeCloud, registry=None):
        if registry is None:
            from karpenter_tpu_torch.metrics.registry import REGISTRY as registry
        self.cloud = cloud
        self.registry = registry
        # static seed (compiled-in table analogue)
        self._od: Dict[str, float] = {
            s.name: s.od_price for s in cloud.shapes.values()
        }
        self._spot: Dict[Tuple[str, str], float] = {}
        self._spot_updated = False
        self.last_update: float = 0.0
        self._seeded_at = cloud.clock.now()

    def on_demand_price(self, instance_type: str) -> Optional[float]:
        return self._od.get(instance_type)

    def spot_price(self, instance_type: str, zone: str) -> Optional[float]:
        """Per-zone spot price; falls back to the on-demand price until the
        first spot refresh lands (reference pricing.go:130-143)."""
        if self._spot_updated:
            p = self._spot.get((instance_type, zone))
            if p is not None:
                return p
        return self._od.get(instance_type)

    def update_on_demand(self) -> bool:
        """Refresh on-demand prices; a failed API serves last-good prices
        (always populated — the catalog seed) with a staleness gauge
        instead of erroring, so a pricing outage can never kill a tick.
        Returns whether the refresh landed."""
        try:
            products = self.cloud.get_products()
        except CloudAPIError as exc:
            self._degrade("on-demand", exc)
            return False
        self._od.update(products)
        self._fresh()
        return True

    def update_spot(self) -> bool:
        try:
            history = self.cloud.describe_spot_price_history()
        except CloudAPIError as exc:
            self._degrade("spot", exc)
            return False
        self._spot.update(history)
        self._spot_updated = True
        self._fresh()
        return True

    def _fresh(self) -> None:
        self.last_update = self.cloud.clock.now()
        self.registry.set(STALENESS_METRIC, 0.0, {"provider": "pricing"})

    def _degrade(self, what: str, exc: Exception) -> None:
        age = max(
            self.cloud.clock.now() - (self.last_update or self._seeded_at), 0.0
        )
        log.warning(
            "pricing %s refresh failed (%s); serving %.0fs-stale prices",
            what, exc, age,
        )
        self.registry.set(STALENESS_METRIC, age, {"provider": "pricing"})

    def instance_types(self):
        return list(self._od)
