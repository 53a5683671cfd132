"""Serve-last-good degradation for provider caches.

When a provider's TTL cache misses and the refresh API call fails (a
throttle that outlived its retries, a blackout, an open circuit breaker —
all surfaced as `CloudAPIError`), the provider serves the last
successfully-fetched value for that key instead of erroring, and exports
how stale that data is via `karpenter_provider_cache_stale_seconds
{provider}` (0 while fresh).  Stale values are deliberately NOT written
back into the TTL cache: every subsequent miss re-probes the API — cheap
while the circuit is open — so recovery is immediate once the cloud heals.

A key with no last-good value (first fetch ever) still raises: inventing
data would be worse than failing.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Tuple

from karpenter_tpu_torch.cloud.fake.backend import CloudAPIError
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

STALENESS_METRIC = "karpenter_provider_cache_stale_seconds"


class StaleGuard:
    def __init__(self, provider: str, clock: Clock, registry=None):
        if registry is None:
            from karpenter_tpu_torch.metrics.registry import REGISTRY as registry
        self.provider = provider
        self.clock = clock
        self.registry = registry
        self._last_good: Dict[Any, Tuple[float, Any]] = {}
        # keys currently being served stale; the exported gauge is the MAX
        # age across them, so one key's recovery cannot hide another key's
        # ongoing degradation
        self._degraded: set = set()

    def _export(self) -> None:
        now = self.clock.now()
        age = max(
            (
                now - self._last_good[k][0]
                for k in self._degraded
                if k in self._last_good
            ),
            default=0.0,
        )
        self.registry.set(
            STALENESS_METRIC, max(age, 0.0), {"provider": self.provider}
        )

    def fetch(self, key, fetcher: Callable[[], Any]) -> Tuple[Any, bool]:
        """Run `fetcher()`; on `CloudAPIError` fall back to the last good
        value for `key` (raising only when none exists).  Returns
        (value, fresh) — callers only TTL-cache fresh values."""
        try:
            value = fetcher()
        except CloudAPIError as exc:
            hit = self._last_good.get(key)
            if hit is None:
                raise
            fetched_at, value = hit
            self._degraded.add(key)
            self._export()
            self.registry.event(
                "StaleServed",
                provider=self.provider,
                key=str(key),
                age_s=f"{max(self.clock.now() - fetched_at, 0.0):.3f}",
            )
            log.warning(
                "%s provider refresh failed (%s); serving %.0fs-stale data",
                self.provider, exc, max(self.clock.now() - fetched_at, 0.0),
            )
            return value, False
        self._last_good[key] = (self.clock.now(), value)
        self._degraded.discard(key)
        self._export()
        return value, True
