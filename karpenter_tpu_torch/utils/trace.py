"""Span tracing and per-solve phase accounting.

A small port of ``karpenter_tpu/utils/trace.py``: the same `phase` /
`phase_collect` self-time collector, so a solve's ``last_phases`` (delta /
partition / compile / pad / dispatch / device_block / oracle / decode /
other) still sums to its wall time, and a `Tracer` whose `span` records
count / total / max per dotted path when enabled.  Trace-context stamping and the lock
sanitizer stay with the operator slice.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List


@dataclass
class SpanStat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def observe(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt


class Tracer:
    """Process-local span aggregates.  Disabled by default: `span()` costs a
    single attribute read when off."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stats: Dict[str, SpanStat] = {}
        self._local = threading.local()

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **meta) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        stack = self._stack()
        path = ".".join(stack + [name]) if stack else name
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                stat = self._stats.get(path)
                if stat is None:
                    stat = self._stats[path] = SpanStat()
                stat.observe(dt)

    def stats(self) -> Dict[str, SpanStat]:
        with self._lock:
            return {k: SpanStat(v.count, v.total_s, v.max_s)
                    for k, v in self._stats.items()}


# the default process tracer; tests may build their own
TRACER = Tracer()


_PHASE_LOCAL = threading.local()


@contextlib.contextmanager
def phase_collect(sink: Dict[str, float]) -> Iterator[Dict[str, float]]:
    """Install `sink` as this thread's phase accumulator for the block."""
    prev_sink = getattr(_PHASE_LOCAL, "sink", None)
    prev_stack = getattr(_PHASE_LOCAL, "stack", None)
    _PHASE_LOCAL.sink = sink
    _PHASE_LOCAL.stack = []
    try:
        yield sink
    finally:
        _PHASE_LOCAL.sink = prev_sink
        _PHASE_LOCAL.stack = prev_stack


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Accumulate the block's SELF time (exclusive of nested phases) into
    the installed sink under `name`.  No-op without a sink."""
    sink = getattr(_PHASE_LOCAL, "sink", None)
    if sink is None:
        yield
        return
    stack = _PHASE_LOCAL.stack
    child_time = [0.0]
    stack.append(child_time)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        if stack:
            stack[-1][0] += dt
        sink[name] = sink.get(name, 0.0) + dt - child_time[0]
