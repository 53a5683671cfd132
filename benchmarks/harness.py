"""The harness's shared machinery: the manifest and a cell's files, the
measured window, the statistics, the device trace's reduction and the
result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel sits in a file of its own that the harness finds by the
name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<mix>.json``: the mix's parameters, with ``driver`` naming the
  closed loop in `benchmarks/drivers.py` that reads them;
- ``layer_metrics/<metric>.py``: ``read(run)`` returns the metric's value
  or None where the run has nothing to read;
- ``roofline/<kernel>.py``: ``bound_ms(...)``, the least time the card
  could take for one launch on a call's data.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A harness file by its path (metric and kernel names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmarks_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic and
    metrics."""

    def __init__(self, name: str, manifest: Optional[dict] = None):
        self.manifest = manifest if manifest is not None else load_json(MANIFEST)
        by_name = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        self.name = name
        entry = next(c for c in self.manifest["configs"] if c["name"] == self.workload["config"])
        self.config = load_json(ROOT / entry["file"])
        self.traffic = load_json(BENCH / "traffic" / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in self.manifest["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in self.manifest["per_layer"] if self.reports(m)]

    def reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells


# ---------------------------------------------------------------------------
# the measured window
# ---------------------------------------------------------------------------


class Window:
    """A closed loop of calls over ``seconds``: every call's wall time,
    kind, work and the program's phases, and every pause of the garbage
    collector, which stays on."""

    def __init__(self, seconds: float, trace: bool = False):
        self.seconds = float(seconds)
        self.calls: List[dict] = []
        self.gc_pauses: List[float] = []
        self.held: List[tuple] = []  # the harness's own work: (start, end)
        self.trace = DeviceTrace() if trace else None
        self._gc_t0 = 0.0
        self.t0 = self.t1 = 0.0

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_pauses.append(time.perf_counter() - self._gc_t0)

    def __enter__(self) -> "Window":
        gc.callbacks.append(self._gc)
        if self.trace is not None:
            self.trace.start()
        self.t0 = self.t1 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        gc.callbacks.remove(self._gc)
        if self.trace is not None:
            self.trace.stop()

    def open(self) -> bool:
        """Whether the window still takes another call."""
        return time.perf_counter() - self.t0 - self.held_s < self.seconds

    @contextlib.contextmanager
    def hold(self):
        """The harness's own work inside the window (making the next
        inputs, keeping a sample): its time is not the program's, and the
        window's clock stops for it."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.held.append((t, time.perf_counter()))

    @property
    def held_s(self) -> float:
        return sum(b - a for a, b in self.held)

    @contextlib.contextmanager
    def call(self, kind: str, work: int, phases: Optional[dict] = None):
        """Times one call; ``phases`` is the program's phase dict of the
        call, read once it has returned."""
        rec = {"kind": kind, "work": work, "index": len(self.calls)}
        marker = self.trace.marker(kind) if self.trace is not None else contextlib.nullcontext()
        with marker:
            t0 = time.perf_counter()
            try:
                yield rec
            finally:
                t1 = time.perf_counter()
        rec.update(t0=t0, t1=t1, s=t1 - t0)
        rec.setdefault("phases", dict(phases) if phases is not None else {})
        self.calls.append(rec)

    @property
    def window_s(self) -> float:
        """The window's length, the harness's own work left out."""
        return self.t1 - self.t0 - self.held_s


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile by nearest rank over every value."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def quartiles(values: List[float]) -> List[float]:
    return statistics.quantiles(values, n=4) if len(values) > 1 else list(values) * 3


def phase_means(calls: List[dict]) -> Dict[str, float]:
    """The program's phases, mean ms a call."""
    out: Dict[str, float] = {}
    for c in calls:
        for k, v in c["phases"].items():
            out[k] = out.get(k, 0.0) + 1e3 * v / len(calls)
    return out


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------


def union_s(intervals: List[tuple]) -> float:
    """The length covered by ``(start, end)`` intervals, overlaps once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: List[tuple], lo: float, hi: float) -> List[tuple]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class DeviceTrace:
    """torch.profiler over the window: the device's kernels and copies as
    intervals in seconds of the host's ``perf_counter`` clock, aligned by
    the profiler's record of each call's marker."""

    def __init__(self):
        self.prof = None
        self.marks: List[tuple] = []  # (kind, perf_counter at entry)
        self.ops: List[tuple] = []  # (name, start_s, end_s) on the device
        self.host: List[tuple] = []  # (name, start_s, end_s) of the program's spans

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from karpenter_tpu_torch.utils.trace import TRACER

        TRACER.reset()
        TRACER.enabled = True
        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def marker(self, kind: str):
        from torch.profiler import record_function

        with record_function(f"bench.{kind}"):
            self.marks.append((kind, time.perf_counter()))
            yield

    def stop(self) -> None:
        import torch

        from karpenter_tpu_torch.utils.trace import TRACER

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        TRACER.enabled = False
        spans = TRACER.recent(limit=1 << 30)
        events = list(self.prof.events())
        starts = sorted(e.time_range.start for e in events if e.name.startswith("bench."))
        offsets = [s * 1e-6 - t for s, (_, t) in zip(starts, self.marks)]
        off = statistics.median(offsets) if offsets else 0.0
        cuda = torch.autograd.DeviceType.CUDA
        # the markers' own spans on the device's timeline are no device work
        self.ops = [(e.name, e.time_range.start * 1e-6 - off, e.time_range.end * 1e-6 - off)
                    for e in events if e.device_type == cuda and not e.name.startswith("bench.")]
        self.host = [(s.path, s.start_s, s.start_s + s.duration_s) for s in spans]
        self.prof = None

    def busy_s(self, lo: float, hi: float) -> float:
        return union_s([(max(a, lo), min(b, hi)) for _, a, b in self.ops if b > lo and a < hi])

    def in_call(self, call: dict, match) -> List[tuple]:
        """The device operations ``match(name)`` takes that ran inside
        ``call``."""
        return [op for op in self.ops if call["t0"] <= op[1] and op[2] <= call["t1"] + 1e-4
                and match(op[0])]

    def breakdown(self, calls: List[dict], held: List[tuple], lo: float, hi: float) -> dict:
        """The ten device operations that took most time, by name, and the
        ten longest idle stretches, each named by the innermost span of the
        program (else the harness's call) that held the host then."""
        by_name: Dict[str, float] = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        # the harness's own work is no idle time of the program's
        idle = sorted(gaps([(a, b) for _, a, b in self.ops] + list(held), lo, hi),
                      key=lambda g: g[0] - g[1])[:10]

        def what(t: float) -> str:
            inner = [s for s in self.host if s[1] <= t <= s[2]]
            if inner:
                return min(inner, key=lambda s: s[2] - s[1])[0]
            call = next((c for c in calls if c["t0"] <= t <= c["t1"]), None)
            return f"bench.{call['kind']}" if call else "between calls"

        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[what((a + b) / 2), b - a] for a, b in idle]}


# ---------------------------------------------------------------------------
# the run a cell hands its readers, and the result line
# ---------------------------------------------------------------------------


class Run:
    """What the per-layer readers read: the window's calls and collector
    pauses, its device trace, and the bounds the check worked out."""

    def __init__(self, window: Window, bounds: Optional[Dict[str, dict]] = None):
        self.calls = window.calls
        self.gc_pauses = window.gc_pauses
        self.window_s = window.window_s
        self.held = window.held
        self.trace = window.trace
        self.lo, self.hi = window.t0, window.t1
        self.bounds = bounds or {}

    def of(self, *kinds: str) -> List[dict]:
        return [c for c in self.calls if c["kind"] in kinds]

    def mean_phase_ms(self, kinds, names) -> Optional[float]:
        calls = self.of(*kinds)
        if not calls:
            return None
        return 1e3 * sum(c["phases"].get(n, 0.0) for c in calls for n in names) / len(calls)

    def busy_s(self) -> float:
        return self.trace.busy_s(self.lo, self.hi) if self.trace is not None else 0.0

    def idle_pct(self) -> Optional[float]:
        """The share of the window, the harness's own work left out, in
        which no kernel or copy ran on the device."""
        if self.trace is None or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def roofline_pct(self, kernel: str, match) -> Optional[float]:
        """The kernel's least time over its device time (the operations
        ``match(name)`` takes), summed over the calls whose bound the check
        worked out."""
        if self.trace is None:
            return None
        bound = spent = 0.0
        for idx, ms in self.bounds.get(kernel, {}).items():
            ops = self.trace.in_call(self.calls[idx], match)
            if ops:
                bound += ms
                spent += 1e3 * sum(b - a for _, a, b in ops)
        return 100.0 * bound / spent if spent > 0 else None


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def per_layer(cell: Cell, run: Run) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = load_module(BENCH / "layer_metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out
