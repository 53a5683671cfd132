"""Span tracing and per-solve phase accounting.

A port of ``karpenter_tpu/utils/trace.py``: the same `phase` /
`phase_collect` self-time collector, so a solve's ``last_phases`` (delta /
partition / compile / pad / dispatch / device_block / oracle / decode /
other) still sums to its wall time, and a `Tracer` whose `span` records,
when enabled, each span into a bounded ring (`Span`: dotted path, start,
duration, meta and the tick's trace ID from ``obs/context.py``, read back
by `Tracer.recent` for the flight recorder) and count / total / max per
dotted path.  The span dump and the device trace under ``profile_dir``
are not ported (ROADMAP A8).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

from karpenter_tpu_torch.obs.context import current_trace_id
from karpenter_tpu_torch.utils.locks import make_lock

# bounded history: enough for several reconcile ticks of every controller
RING_SIZE = 4096


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


@dataclass
class Span:
    path: str  # dotted: "controller.disruption.simulate"
    start_s: float
    duration_s: float
    meta: Dict[str, str] = field(default_factory=dict)
    # the reconcile tick this span acted for, stamped from obs/context.py
    # at record time, so one trace ID joins controller spans and solver
    # phases into a single timeline
    trace_id: str = ""


class Tracer:
    """Process-local span recorder.  Disabled by default: `span()` costs a
    single attribute read when off."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = make_lock("Tracer._lock")
        self._ring: deque = deque(maxlen=RING_SIZE)
        self._stats: Dict[str, SpanStat] = {}
        self._local = threading.local()

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **meta: str) -> Iterator[None]:
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
                self._ring.append(
                    Span(path=path, start_s=t0, duration_s=dt,
                         meta={k: str(v) for k, v in meta.items()},
                         trace_id=current_trace_id())
                )
                stat = self._stats.get(path)
                if stat is None:
                    stat = self._stats[path] = SpanStat()
                stat.observe(dt)

    def stats(self) -> Dict[str, SpanStat]:
        with self._lock:
            return {k: SpanStat(v.count, v.total_s, v.max_s)
                    for k, v in self._stats.items()}

    def recent(self, limit: int = 100) -> List[Span]:
        with self._lock:
            return list(self._ring)[-limit:]

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._stats.clear()


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
