"""Always-on flight recorder: the last N ticks' full context, on a ring.

When an SLO burns or a controller crashes, the dashboards show *that* it
happened; the flight recorder preserves *what was going on* — per tick:

- the tick's identity (seq, trace ID, injected-clock timestamp, wall
  duration),
- a cluster summary (pending / nodes / claims / running instances),
- the ledger slice: every decision event emitted during the tick (with
  a ``dropped`` count if the ring overflowed between records),
- the span slice: spans stamped with the tick's trace ID (empty unless
  profiling is enabled — the recorder itself never turns the tracer on),
- metric deltas: every counter that moved this tick, and per-series
  (count, sum) deltas for the latency histograms — which is exactly the
  per-phase self-time spent THIS tick, the series ``doctor`` baselines.

The ring is bounded (``Settings.flight_ticks``) and recording costs one
registry snapshot diff per tick — cheap enough to stay always-on, like
the event ledger.  Dumps are JSONL (header line ``{"t": "flight"}``,
then one ``{"t": "ftick"}`` line per tick) written on SLOBreach,
controller crash, or SIGUSR1, served live at ``/debug/flight``
(obs/http.py), rendered by ``python -m karpenter_tpu_torch obs`` into
Perfetto-loadable Chrome-trace JSON (obs/render.py), and diagnosed by
``python -m karpenter_tpu_torch doctor`` (obs/doctor.py).
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.locks import make_lock

FLIGHT_VERSION = 1

# default ring depth: ~a minute of 1s ticks, enough to bracket a breach
DEFAULT_TICKS = 64

# histogram families whose per-tick (count, sum) deltas are recorded —
# the per-phase latency anatomy doctor baselines
DELTA_HISTOGRAMS = (
    "karpenter_solver_phase_seconds",
    "karpenter_consolidation_phase_seconds",
    "karpenter_consolidation_search_phase_seconds",
    "karpenter_reconcile_tick_duration_seconds",
    "karpenter_provisioner_scheduling_duration_seconds",
    # device observatory (obs/device.py): per-tick compile time and the
    # resident scatter sizes the doctor's transfer rule normalizes by
    "karpenter_device_compile_seconds",
    "karpenter_solver_resident_delta_rows",
    # store plane (docs/designs/store-scale.md): the operator's per-RPC
    # store latency, so a flight dump brackets store slowness next to
    # the solver phases it stalls
    "karpenter_store_rpc_seconds",
    # solver service (docs/designs/solver-service.md): per-tenant
    # solve-wait — the doctor's tenant-starvation rule reads these
    # tenant-labeled deltas out of a service flight dump
    "karpenter_service_solve_wait_seconds",
)


def _series_key(name: str, labels: Tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class FlightRecorder:
    def __init__(
        self,
        clock: Clock,
        registry: Registry,
        ledger=None,
        tracer=None,
        capacity: int = DEFAULT_TICKS,
    ):
        self.clock = clock
        self.registry = registry
        self.ledger = ledger
        self.tracer = tracer
        self._lock = make_lock("FlightRecorder._lock")
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._led_cursor = 0
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], Tuple[int, float]] = {}

    # -------------------------------------------------------------- capture
    def _counter_deltas(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self.registry._lock:
            for name, series in self.registry.counters.items():
                for labels, v in series.items():
                    key = (name, labels)
                    prev = self._counters.get(key, 0.0)
                    if v != prev:
                        out[_series_key(name, labels)] = round(v - prev, 9)
                        self._counters[key] = v
        return out

    def _hist_deltas(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        with self.registry._lock:
            for name in DELTA_HISTOGRAMS:
                for labels, h in self.registry.histograms.get(name, {}).items():
                    key = (name, labels)
                    pc, ps = self._hists.get(key, (0, 0.0))
                    if h.count != pc:
                        out[_series_key(name, labels)] = {
                            "count": h.count - pc,
                            "sum_s": round(h.total - ps, 9),
                        }
                        self._hists[key] = (h.count, h.total)
        return out

    def record(
        self,
        seq: int,
        trace_id: str,
        duration_s: float,
        summary: Optional[dict] = None,
        device: Optional[dict] = None,
    ) -> dict:
        """Capture one tick's context into the ring (the operator calls
        this at the end of every reconcile tick).  ``device`` is the
        observatory's per-tick section (obs/device.py tick_section):
        compiles / warm recompiles / transfer bytes this tick plus the
        current resident footprint — what the doctor's device rules
        read."""
        events: List[dict] = []
        dropped = 0
        if self.ledger is not None:
            evs, dropped = self.ledger.read(self._led_cursor)
            if evs:
                self._led_cursor = evs[-1].seq
            events = [ev.to_dict() for ev in evs]
        spans: List[dict] = []
        if self.tracer is not None and trace_id:
            spans = [
                {
                    "path": s.path,
                    "start_s": s.start_s,
                    "duration_s": s.duration_s,
                    "meta": s.meta,
                }
                for s in self.tracer.recent(4096)
                if s.trace_id == trace_id
            ]
        entry = {
            "t": "ftick",
            "seq": seq,
            "trace_id": trace_id,
            "ts": self.clock.now(),
            "dur_s": round(duration_s, 9),
            "summary": dict(summary or {}),
            "events": events,
            "dropped_events": dropped,
            "spans": spans,
            "counters": self._counter_deltas(),
            "hists": self._hist_deltas(),
            "device": dict(device or {}),
        }
        with self._lock:
            self._ring.append(entry)
        return entry

    # ----------------------------------------------------------------- dump
    def dump_lines(self, trigger: str = "manual") -> List[str]:
        with self._lock:
            ticks = list(self._ring)
        header = {
            "t": "flight",
            "v": FLIGHT_VERSION,
            "trigger": trigger,
            "ticks": len(ticks),
            "dumped_ts": self.clock.now(),
        }
        return [json.dumps(header, sort_keys=True)] + [
            json.dumps(t, sort_keys=True) for t in ticks
        ]

    def dump(self, path: str, trigger: str = "manual") -> str:
        """Write the ring as JSONL; returns the path.  Counted per
        trigger so a dump storm is itself observable."""
        with open(path, "w") as f:
            f.write("\n".join(self.dump_lines(trigger)) + "\n")
        self.registry.inc(
            "karpenter_flight_dumps_total", {"trigger": trigger}
        )
        return path


# ------------------------------------------------------------------ loading
def read_flight(text: str) -> dict:
    """Parse a flight dump (JSONL text) -> {"meta": header, "ticks": [...]}.
    Raises ValueError on anything that is not a flight dump."""
    lines = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    if not lines or lines[0].get("t") != "flight":
        raise ValueError("not a flight dump (no {'t': 'flight'} header line)")
    return {
        "meta": lines[0],
        "ticks": [ln for ln in lines[1:] if ln.get("t") == "ftick"],
    }


def load_flight(path: str) -> dict:
    with open(path) as f:
        return read_flight(f.read())
