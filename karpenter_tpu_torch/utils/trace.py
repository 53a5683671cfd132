"""Span tracing and per-solve phase accounting.

A port of ``karpenter_tpu/utils/trace.py``: the same `phase` /
`phase_collect` self-time collector, so a solve's ``last_phases`` (delta /
partition / compile / pad / dispatch / device_block / oracle / decode /
other) still sums to its wall time, and a `Tracer` whose `span` records,
when enabled, each span into a bounded ring (`Span`: dotted path, start,
duration, meta and the tick's trace ID from ``obs/context.py``, read back
by `Tracer.recent` for the flight recorder) and count / total / max per
dotted path, printed by `Tracer.report` and written by `Tracer.dump`.

`device_trace` is the counterpart of the reference's
``jax.profiler.trace`` around the solver's hot path: when the tracer is
enabled and a directory is set (``log_dir`` or ``Tracer.profile_dir``) it
runs the block under ``torch.profiler`` (CPU activity, and CUDA activity
when a card is present) and writes one Chrome trace a block into the
directory, named by wall-clock time, process and a per-process sequence
number so that files never collide.  Otherwise it costs nothing.  One
profiler runs in a process at a time: a block entered while another
block's profiler runs goes untraced.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

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

    def __init__(self, enabled: bool = False, profile_dir: str = ""):
        self.enabled = enabled
        # when set (and enabled), device_trace also writes the profiler's
        # timeline of each wrapped solve into this directory
        self.profile_dir = profile_dir
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

    def report(self) -> str:
        """Human-readable hot-path table, total-time descending — the
        text-mode `pprof -top` analogue."""
        rows = sorted(
            self.stats().items(), key=lambda kv: -kv[1].total_s
        )
        out = [f"{'span':48s} {'count':>8s} {'total_ms':>10s} {'avg_ms':>8s} {'max_ms':>8s}"]
        for path, st in rows:
            avg = st.total_s / st.count if st.count else 0.0
            out.append(
                f"{path:48s} {st.count:8d} {st.total_s * 1000:10.1f} "
                f"{avg * 1000:8.2f} {st.max_s * 1000:8.2f}"
            )
        return "\n".join(out)

    def dump(self, path: str) -> None:
        """JSON snapshot (aggregates + recent spans) for offline tooling."""
        payload = {
            "stats": {
                k: {"count": v.count, "total_s": v.total_s, "max_s": v.max_s}
                for k, v in self.stats().items()
            },
            "recent": [
                {
                    "path": s.path,
                    "start_s": s.start_s,
                    "duration_s": s.duration_s,
                    "trace_id": s.trace_id,
                    "meta": s.meta,
                }
                for s in self.recent(500)
            ],
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

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


# torch.profiler is process-wide: one device trace at a time
_DEVICE_TRACE_LOCK = threading.Lock()
_DEVICE_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def device_trace(
    tracer: Tracer, log_dir: Optional[str] = None
) -> Iterator[None]:
    """The profiler's timeline of the block: when the tracer is enabled AND
    a directory is set (argument or ``tracer.profile_dir``), the block runs
    under ``torch.profiler`` and its Chrome trace lands in the directory;
    otherwise a free no-op."""
    log_dir = log_dir or tracer.profile_dir
    if not tracer.enabled or not log_dir:
        yield
        return
    if not _DEVICE_TRACE_LOCK.acquire(blocking=False):
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            log_dir,
            f"solve-{time.time_ns()}-{os.getpid()}-{next(_DEVICE_TRACE_SEQ)}"
            ".pt.trace.json",
        ))
    finally:
        _DEVICE_TRACE_LOCK.release()
