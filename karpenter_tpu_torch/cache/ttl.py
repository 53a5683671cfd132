"""TTL cache (reference pkg/cache/cache.go:20-33 — patrickmn/go-cache usage).

Default TTLs mirror the reference constants: 1m default, 5m instance
types/zones, 3m unavailable offerings, 15m instance profiles.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.locks import make_lock

DEFAULT_TTL = 60.0
INSTANCE_TYPES_ZONES_TTL = 300.0
UNAVAILABLE_OFFERINGS_TTL = 180.0
INSTANCE_PROFILE_TTL = 900.0


class TTLCache:
    def __init__(
        self,
        clock: Clock,
        ttl: float = DEFAULT_TTL,
        on_evict: Optional[Callable[[Any, Any], None]] = None,
    ):
        self.clock = clock
        self.ttl = ttl
        # eviction hook (go-cache OnEvicted analogue — the launch-template
        # provider deletes the remote template when its cache entry expires,
        # reference launchtemplate.go:340-357)
        self.on_evict = on_evict
        self._items: Dict[Any, Tuple[float, Any]] = {}
        # launches fan out over a thread pool (provisioning.py _launch), so
        # every provider cache on that path sees concurrent access
        self._lock = make_lock("TTLCache._lock")

    def get(self, key) -> Optional[Any]:
        with self._lock:
            item = self._items.get(key)
            if item is None:
                return None
            expires, value = item
            if self.clock.now() >= expires:
                del self._items[key]
            else:
                return value
        if self.on_evict is not None:
            self.on_evict(key, value)
        return None

    def touch(self, key) -> None:
        """Refresh an entry's TTL (go-cache keeps hot entries alive the
        same way; without this, actively-used launch templates would be
        remote-deleted and recreated every TTL period)."""
        with self._lock:
            item = self._items.get(key)
            if item is not None:
                self._items[key] = (self.clock.now() + self.ttl, item[1])

    def purge_expired(self) -> None:
        """Evict every expired entry now (firing on_evict for each)."""
        evicted = []
        with self._lock:
            now = self.clock.now()
            for key in [k for k, (exp, _) in self._items.items() if now >= exp]:
                _, value = self._items.pop(key)
                evicted.append((key, value))
        if self.on_evict is not None:
            for key, value in evicted:
                self.on_evict(key, value)

    def set(self, key, value, ttl: Optional[float] = None) -> None:
        with self._lock:
            self._items[key] = (self.clock.now() + (ttl or self.ttl), value)

    def delete(self, key) -> None:
        with self._lock:
            self._items.pop(key, None)

    def flush(self) -> None:
        with self._lock:
            self._items.clear()

    def keys(self):
        with self._lock:
            now = self.clock.now()
            return [k for k, (exp, _) in self._items.items() if exp > now]

    def __len__(self) -> int:
        return len(self.keys())
