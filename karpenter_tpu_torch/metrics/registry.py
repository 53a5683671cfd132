"""In-process metrics registry (reference: controller-runtime Prometheus
registry; metric names mirror website v0.31 concepts/metrics.md).

Counters, gauges, and histograms keyed by (name, sorted labels).  The
registry is inspectable in tests and exportable as a Prometheus-style text
dump — the reference's ~50 published metrics map onto these names, e.g.
`karpenter_provisioner_scheduling_duration_seconds`,
`karpenter_nodeclaims_launched`, `karpenter_interruption_received_messages`,
`karpenter_cloudprovider_duration_seconds`, batcher batch size/time.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Mapping, Optional, Tuple
from karpenter_tpu_torch.utils.locks import make_lock

# per-series sample window kept for test/debug inspection; count/sum run
# unbounded so dump() stays exact while memory stays O(1) per series
_HIST_WINDOW = 1024

# fixed cumulative bucket bounds (seconds for latency series, plain
# counts for size series), Prometheus-style with an implicit +Inf: wide
# enough to span sub-ms solver phases and multi-minute time-to-schedule.
# Buckets are the UNBOUNDED percentile source: the sample window above
# only holds the last 1024 observations, so past that point window
# percentiles describe the tail of the run, not the run — `quantile`
# switches to bucket interpolation exactly there.
BUCKET_BOUNDS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
)


def _nearest_rank(ordered: List[float], q: float) -> float:
    """The sim report's percentile formula (sim/report.py), shared so the
    exact path of `_Hist.quantile` reproduces it bit-for-bit."""
    if not ordered:
        return 0.0
    rank = max(0, min(len(ordered) - 1, int(round(q * (len(ordered) - 1)))))
    return ordered[rank]


class _Hist:
    __slots__ = ("count", "total", "samples", "buckets", "vmax")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.samples: deque = deque(maxlen=_HIST_WINDOW)
        # per-bound observation counts + one overflow slot (+Inf);
        # rendered CUMULATIVE by the exposition
        self.buckets: List[int] = [0] * (len(BUCKET_BOUNDS) + 1)
        self.vmax = 0.0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.samples.append(value)
        self.buckets[bisect.bisect_left(BUCKET_BOUNDS, value)] += 1
        if value > self.vmax:
            self.vmax = value

    def quantile(self, q: float) -> float:
        """Percentile that stays honest past the sample window: exact
        nearest-rank while the window still holds every observation,
        bucket interpolation (deterministic, monotone) once it doesn't.
        The exact path reuses the sim report's formula so small runs are
        unchanged by the bucket machinery."""
        if self.count == 0:
            return 0.0
        if self.count <= len(self.samples):
            return _nearest_rank(sorted(self.samples), q)
        target = q * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            if cum + n >= target:
                if i >= len(BUCKET_BOUNDS):
                    return self.vmax  # +Inf bucket: the tracked max
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                hi = BUCKET_BOUNDS[i]
                return lo + (hi - lo) * max(0.0, target - cum) / n
            cum += n
        return self.vmax


def _key(labels: Optional[Mapping[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Registry:
    def __init__(self):
        self._lock = make_lock("Registry._lock")
        self.counters: Dict[str, Dict[Tuple, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        self.gauges: Dict[str, Dict[Tuple, float]] = defaultdict(dict)
        self.histograms: Dict[str, Dict[Tuple, _Hist]] = defaultdict(
            lambda: defaultdict(_Hist)
        )
        # optional cluster event ledger (obs/events.py): the operator
        # attaches its per-process ledger here so every layer that
        # already holds a registry can emit decision events without new
        # constructor plumbing; None = events are dropped (bare tests)
        self.ledger = None
        # streaming sketch taps (load/sketch.py): histogram families a
        # consumer wants summarized over the WHOLE stream, not the
        # _Hist sample window — the sim runner attaches one for
        # time-to-schedule so the fleet report's p99.9 stays exact-ish
        # at millions of observations
        self._sketches: Dict[str, List[object]] = {}

    # ------------------------------------------------------------- recording
    def inc(self, name: str, labels: Optional[Mapping[str, str]] = None, by: float = 1.0):
        with self._lock:
            self.counters[name][_key(labels)] += by

    def set(self, name: str, value: float, labels: Optional[Mapping[str, str]] = None):
        with self._lock:
            self.gauges[name][_key(labels)] = value

    def observe(self, name: str, value: float, labels: Optional[Mapping[str, str]] = None):
        with self._lock:
            self.histograms[name][_key(labels)].observe(value)
            for sketch in self._sketches.get(name, ()):
                sketch.observe(value)

    def attach_sketch(self, name: str, sketch) -> None:
        """Feed every observation of histogram family `name` (all label
        sets) into `sketch` as well (anything with an ``observe(float)``
        method, e.g. load/sketch.py's QuantileSketch)."""
        with self._lock:
            self._sketches.setdefault(name, []).append(sketch)

    def event(self, type_: str, **attrs) -> None:
        """Emit a cluster event through the attached ledger (no-op when
        none is attached).  The ledger stamps the injected clock + the
        current trace ID and bumps ``karpenter_events_total{type}``."""
        led = self.ledger
        if led is not None:
            led.emit(type_, **attrs)

    def reset_gauge(self, name: str):
        """Drop every series of a gauge family — used by collectors that
        re-emit their full set each reconcile so vanished nodes/pools do
        not leave stale series behind."""
        with self._lock:
            self.gauges.pop(name, None)

    def unset(self, name: str, labels: Optional[Mapping[str, str]] = None):
        """Drop ONE gauge series (collectors that prune their own emitted
        key set instead of resetting the whole family)."""
        with self._lock:
            series = self.gauges.get(name)
            if series is not None:
                series.pop(_key(labels), None)

    class _Timer:
        def __init__(self, registry: "Registry", name: str, labels):
            self.registry, self.name, self.labels = registry, name, labels

        def __enter__(self):
            import time

            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            import time

            self.registry.observe(
                self.name, time.perf_counter() - self._t0, self.labels
            )
            return False

    def time(
        self, name: str, labels: Optional[Mapping[str, str]] = None
    ) -> "Registry._Timer":
        return Registry._Timer(self, name, labels)

    # ------------------------------------------------------------- reading
    def counter(self, name: str, labels: Optional[Mapping[str, str]] = None) -> float:
        return self.counters.get(name, {}).get(_key(labels), 0.0)

    def gauge(self, name: str, labels: Optional[Mapping[str, str]] = None) -> Optional[float]:
        return self.gauges.get(name, {}).get(_key(labels))

    def histogram(self, name: str, labels: Optional[Mapping[str, str]] = None) -> List[float]:
        """Recent samples of a series (bounded window; see _HIST_WINDOW)."""
        h = self.histograms.get(name, {}).get(_key(labels))
        return list(h.samples) if h is not None else []

    def quantile(
        self, name: str, q: float, labels: Optional[Mapping[str, str]] = None
    ) -> float:
        """Window-exact / bucket-estimated percentile of a histogram
        series — unlike ``percentile(registry.histogram(...))`` this does
        NOT silently degrade to the last-1024-samples tail once a series
        outgrows its window (tests/test_obs.py pins the regression)."""
        h = self.histograms.get(name, {}).get(_key(labels))
        return h.quantile(q) if h is not None else 0.0

    def dump(self) -> str:
        """Prometheus-text-style dump (for the /metrics analogue)."""
        lines: List[str] = []
        with self._lock:
            for name, series in sorted(self.counters.items()):
                for labels, v in sorted(series.items()):
                    lines.append(f"{name}{_fmt(labels)} {v:g}")
            for name, series in sorted(self.gauges.items()):
                for labels, v in sorted(series.items()):
                    lines.append(f"{name}{_fmt(labels)} {v:g}")
            for name, series in sorted(self.histograms.items()):
                for labels, h in sorted(series.items()):
                    lines.append(f"{name}_count{_fmt(labels)} {h.count}")
                    lines.append(f"{name}_sum{_fmt(labels)} {h.total:g}")
        return "\n".join(lines)


def _fmt(labels: Tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


# --------------------------------------------------------------- exposition
def _num(v: float) -> str:
    """Full-precision exposition value: %g truncates to 6 significant
    digits, which corrupts large counters on the wire (1_234_567 ->
    1.23457e+06); round-trip formatting keeps every digit while still
    rendering integral floats as '1'."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape(value: str) -> str:
    """Prometheus label-value escaping (exposition format spec)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt_esc(labels: Tuple, extra: Tuple = ()) -> str:
    pairs = tuple(labels) + tuple(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def exposition(registry: "Registry") -> str:
    """REAL Prometheus text exposition (format 0.0.4): HELP/TYPE headers
    from the shared metric catalog (metrics/catalog.py — the same source
    docs/metrics.md renders from) and cumulative ``_bucket{le=}`` series
    for histograms, so an actual Prometheus server can scrape the
    telemetry endpoint (obs/http.py) and ``histogram_quantile`` works.

    Unlike ``dump()`` (the in-repo test/debug surface, shape-stable on
    purpose), this is the wire format: one family header per name, then
    every series of that family."""
    from karpenter_tpu_torch.metrics.catalog import METRIC_DETAILS

    def header(name: str, kind: str) -> List[str]:
        detail = METRIC_DETAILS.get(name)
        help_text = detail[2] if detail is not None else name
        return [
            f"# HELP {name} {_escape(help_text)}",
            f"# TYPE {name} {kind}",
        ]

    lines: List[str] = []
    with registry._lock:
        for name, series in sorted(registry.counters.items()):
            lines += header(name, "counter")
            for labels, v in sorted(series.items()):
                lines.append(f"{name}{_fmt_esc(labels)} {_num(v)}")
        for name, series in sorted(registry.gauges.items()):
            lines += header(name, "gauge")
            for labels, v in sorted(series.items()):
                lines.append(f"{name}{_fmt_esc(labels)} {_num(v)}")
        for name, series in sorted(registry.histograms.items()):
            lines += header(name, "histogram")
            for labels, h in sorted(series.items()):
                cum = 0
                for bound, n in zip(BUCKET_BOUNDS, h.buckets):
                    cum += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_esc(labels, (('le', f'{bound:g}'),))} {cum}"
                    )
                lines.append(
                    f"{name}_bucket{_fmt_esc(labels, (('le', '+Inf'),))} "
                    f"{h.count}"
                )
                lines.append(f"{name}_sum{_fmt_esc(labels)} {_num(h.total)}")
                lines.append(f"{name}_count{_fmt_esc(labels)} {h.count}")
    return "\n".join(lines) + "\n"


def export_compile_cache_counters(
    registry: "Registry", scheduler, consumer: str, exported: Tuple[int, int]
) -> Tuple[int, int]:
    """Mirror a TensorScheduler's monotonic compile-cache hit/miss counts
    into `karpenter_solver_compile_cache_{hits,misses}_total{consumer=}`.

    The scheduler counts across its whole lifetime; each caller keeps the
    pair it last exported and this bumps the registry by the delta, so the
    registry counter stays a well-formed monotonic _total series even with
    two consumers (provisioner, disruption) exporting independently.
    Returns the new exported pair."""
    hits, misses = scheduler.compile_cache_hits, scheduler.compile_cache_misses
    prev_h, prev_m = exported
    if hits > prev_h:
        registry.inc(
            "karpenter_solver_compile_cache_hits_total",
            {"consumer": consumer},
            by=hits - prev_h,
        )
    if misses > prev_m:
        registry.inc(
            "karpenter_solver_compile_cache_misses_total",
            {"consumer": consumer},
            by=misses - prev_m,
        )
    return (hits, misses)


def export_resident_counters(
    registry: "Registry", scheduler, consumer: str, exported: Tuple[int, int]
) -> Tuple[int, int]:
    """Mirror a TensorScheduler's monotonic resident-tensor hit/rebuild
    counts into ``karpenter_solver_resident_{hits,rebuilds}_total
    {consumer=}`` — the same delta-export contract as
    :func:`export_compile_cache_counters` (two consumers, one scheduler
    counter each, registry bumps by the delta)."""
    hits, rebuilds = scheduler.resident_hits, scheduler.resident_rebuilds
    prev_h, prev_r = exported
    if hits > prev_h:
        registry.inc(
            "karpenter_solver_resident_hits_total",
            {"consumer": consumer},
            by=hits - prev_h,
        )
    if rebuilds > prev_r:
        registry.inc(
            "karpenter_solver_resident_rebuilds_total",
            {"consumer": consumer},
            by=rebuilds - prev_r,
        )
    return (hits, rebuilds)


# process-global default registry (controllers accept an override)
REGISTRY = Registry()
