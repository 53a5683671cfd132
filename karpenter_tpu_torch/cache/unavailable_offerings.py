"""Insufficient-capacity (ICE) memory: offerings recently seen unavailable.

Reference pkg/cache/unavailableofferings.go:31-80: keyed by
capacityType:instanceType:zone with a 3-minute TTL, and a sequence number
bumped on every change so downstream caches (instance-type provider) can key
on it and invalidate when availability flips.  Fed by CreateFleet errors
(instance.go:365-371) and spot-interruption events (interruption
controller.go:228-235); consumed when constructing offerings
(instancetype.go:130-158).
"""

from __future__ import annotations

import threading

from karpenter_tpu_torch.cache.ttl import TTLCache, UNAVAILABLE_OFFERINGS_TTL
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.locks import make_lock


class UnavailableOfferings:
    def __init__(self, clock: Clock, ttl: float = UNAVAILABLE_OFFERINGS_TTL):
        self._cache = TTLCache(clock, ttl)
        self.seq_num = 0
        # marks arrive concurrently from the interruption worker pool; an
        # unsynchronized += can lose updates (or regress the counter),
        # silently skipping the seqnum-keyed instance-type cache
        # invalidation downstream
        self._seq_lock = make_lock("UnavailableOfferings._seq_lock")

    @staticmethod
    def _key(capacity_type: str, instance_type: str, zone: str) -> str:
        return f"{capacity_type}:{instance_type}:{zone}"

    def is_unavailable(self, capacity_type: str, instance_type: str, zone: str) -> bool:
        return self._cache.get(self._key(capacity_type, instance_type, zone)) is not None

    def mark_unavailable(
        self, capacity_type: str, instance_type: str, zone: str, reason: str = ""
    ) -> None:
        self._cache.set(self._key(capacity_type, instance_type, zone), reason or True)
        with self._seq_lock:
            self.seq_num += 1

    def flush(self) -> None:
        self._cache.flush()
        with self._seq_lock:
            self.seq_num += 1
