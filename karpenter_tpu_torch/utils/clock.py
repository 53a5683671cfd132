"""Clock abstraction: real and fake (reference uses k8s.io/utils/clock's
FakeClock in every suite, e.g. pkg/cloudprovider/suite_test.go:71, to control
TTL/expiry; we keep the same test shape)."""

from __future__ import annotations

import threading
import time as _time
from karpenter_tpu_torch.utils.locks import make_lock


class Clock:
    def now(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)


class FakeClock(Clock):
    """Manually-stepped clock.  `sleep` advances time instead of blocking so
    controller loops run instantly under test.  Advancing is locked: the
    retry layer and chaos latency sleep on this clock from batcher/worker
    threads, and an unsynchronized `+=` would lose updates."""

    def __init__(self, start: float = 1_700_000_000.0):
        self._now = start
        self._lock = make_lock("FakeClock._lock")

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def step(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def advance_to(self, t: float) -> float:
        """Advance to an absolute time (no-op when already past it).

        The scenario runner (sim/runner.py) pins tick boundaries at
        ``t0 + k * tick_s`` with this, so injected chaos latency (which
        advances the clock mid-tick via `sleep`) compresses the remainder
        of the tick instead of skewing every later tick boundary."""
        with self._lock:
            self._now = max(self._now, t)
            return self._now
