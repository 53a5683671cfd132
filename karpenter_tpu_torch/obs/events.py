"""Cluster event ledger: typed, ring-buffered decision records.

The reference leans on Kubernetes Events to answer "why did Karpenter do
that?" after the fact; this ledger is that surface for the reproduction,
with a stronger determinism contract: every entry is a pure function of
the injected clock and the controllers' (seeded) decisions, so the
simulator records the ledger into its JSONL trace and replays it
byte-identically (sim/runner.py, tests/test_obs.py).

Event types (emitted at the existing decision sites):

- ``PodNominated``    provisioning: a pod was steered onto a node/claim
- ``NodeLaunched``    provisioning: a NodeClaim launched successfully
- ``NodeDisrupted``   disruption/interruption: a node was marked for
                      deletion, ``reason`` carries the mechanism
                      (expired, drifted/…, emptiness, consolidation/…,
                      interruption/…)
- ``RetryBackoff``    cloud retry layer: a classified failure is being
                      retried after backoff
- ``CircuitOpen``     cloud retry layer: an API's breaker opened
- ``StaleServed``     a degraded provider served last-good data
- ``VerdictFallback`` a consolidation what-if the batched path could not
                      answer resolved through the sequential solver
- ``CatalogRolled``   a provider's catalog cache was invalidated (image
                      roll); compile storms downstream start here
- ``SLOBreach``       the SLO engine (obs/slo.py): a rule's fast AND
                      slow burn-rate windows exceeded budget
- ``SLORecovered``    the SLO engine: a breached rule's fast window
                      dropped back under budget
- ``AnomalyDetected`` streaming anomaly detection (obs/detect.py): a
                      phase-latency sample blew past its rolling robust
                      baseline, attrs carry the attribution
- ``DeviceRecompile`` device observatory (obs/device.py): a jit entry
                      point recompiled on a WARM tick (it already had
                      dispatches in an earlier tick) — a fresh padded
                      bucket, an axis change, a donation falling
                      through; attrs carry fn + compile seconds

Every event stamps the current trace ID (obs/context.py), so the ledger
joins the span timeline on the same key.  Emission also bumps
``karpenter_events_total{type}`` on the owning registry, which is how
the /metrics endpoint and the sim SLO report count the ledger without
reading it.  An optional JSONL sink mirrors events to disk for
production operators (``--events-log``).
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.obs.context import current_trace_id
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.locks import make_lock

log = logging.getLogger(__name__)

POD_NOMINATED = "PodNominated"
NODE_LAUNCHED = "NodeLaunched"
NODE_DISRUPTED = "NodeDisrupted"
RETRY_BACKOFF = "RetryBackoff"
CIRCUIT_OPEN = "CircuitOpen"
STALE_SERVED = "StaleServed"
VERDICT_FALLBACK = "VerdictFallback"
CATALOG_ROLLED = "CatalogRolled"
SLO_BREACH = "SLOBreach"
SLO_RECOVERED = "SLORecovered"
ANOMALY_DETECTED = "AnomalyDetected"
DEVICE_RECOMPILE = "DeviceRecompile"

EVENT_TYPES = (
    POD_NOMINATED,
    NODE_LAUNCHED,
    NODE_DISRUPTED,
    RETRY_BACKOFF,
    CIRCUIT_OPEN,
    STALE_SERVED,
    VERDICT_FALLBACK,
    CATALOG_ROLLED,
    SLO_BREACH,
    SLO_RECOVERED,
    ANOMALY_DETECTED,
    DEVICE_RECOMPILE,
)

# bounded history: several hundred ticks of decisions on a busy cluster
RING_SIZE = 4096


@dataclass
class ObsEvent:
    seq: int  # monotonic per ledger, never reused
    ts: float  # injected-clock time (deterministic under FakeClock)
    type: str
    trace_id: str
    attrs: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts": self.ts,
            "type": self.type,
            "trace_id": self.trace_id,
            "attrs": dict(self.attrs),
        }


class EventLedger:
    """Thread-safe ring of ObsEvents.  Cheap enough to stay on: one lock
    acquisition and a deque append per decision (decisions are orders of
    magnitude rarer than metric observations)."""

    def __init__(
        self,
        clock: Optional[Clock] = None,
        registry=None,
        capacity: int = RING_SIZE,
        sink_path: Optional[str] = None,
    ):
        self.clock = clock or Clock()
        self.registry = registry
        self._lock = make_lock("EventLedger._lock")
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self._sink = open(sink_path, "a") if sink_path else None

    def set_sink(self, path: str) -> None:
        """Mirror every future event to a JSONL file (production
        operators; the simulator records through its trace instead)."""
        with self._lock:
            if self._sink is not None:
                self._sink.close()
            self._sink = open(path, "a")

    # --------------------------------------------------------------- emitting
    def emit(self, type_: str, **attrs) -> ObsEvent:
        """Record one event: stamps the injected clock and the current
        trace ID, bumps ``karpenter_events_total{type}``.  Attribute
        values are stringified (the ledger is a wire-safe JSON surface)."""
        with self._lock:
            self._seq += 1
            ev = ObsEvent(
                seq=self._seq,
                ts=self.clock.now(),
                type=type_,
                trace_id=current_trace_id(),
                attrs={k: str(v) for k, v in attrs.items()},
            )
            self._ring.append(ev)
            if self._sink is not None:
                self._sink.write(
                    json.dumps(ev.to_dict(), sort_keys=True) + "\n"
                )
                self._sink.flush()
        if self.registry is not None:
            self.registry.inc("karpenter_events_total", {"type": type_})
        return ev

    # ---------------------------------------------------------------- reading
    def recent(self, limit: int = 500) -> List[ObsEvent]:
        with self._lock:
            return list(self._ring)[-limit:]

    def read(
        self, since_seq: int, limit: Optional[int] = None
    ) -> Tuple[List[ObsEvent], int]:
        """(events with seq > since_seq still in the ring, dropped count):
        ``dropped`` counts events that matched the cursor but were already
        evicted — the loss a poller must see to know its cursor fell
        behind the ring (the `/events?since_seq=` contract, obs/http.py).
        ``limit`` caps the returned slice from the OLD end, so a catching-
        up poller pages forward without skipping."""
        with self._lock:
            dropped = (
                self._ring[0].seq - since_seq - 1
                if self._ring and self._ring[0].seq > since_seq + 1
                else max(0, self._seq - since_seq) if not self._ring else 0
            )
            events = [ev for ev in self._ring if ev.seq > since_seq]
        if limit is not None:
            events = events[: max(0, limit)]
        return events, dropped

    def drain(self, since_seq: int) -> List[ObsEvent]:
        """Events with seq > since_seq still in the ring (the simulator
        polls this once per tick to record the ledger into its trace).
        A poll interval that emitted more than the ring's capacity has
        already evicted the oldest events — that loss is LOUD, never
        silent: a sim trace/report undercounting vs
        ``karpenter_events_total`` must be explainable."""
        events, lost = self.read(since_seq)
        if lost > 0:
            log.warning(
                "event ledger overflowed between drains: %d event(s) "
                "evicted before being read (ring capacity %d)",
                lost, self._ring.maxlen,
            )
        return events

    def counts(self) -> Dict[str, int]:
        """Per-type counts over the RING (bounded); the registry counter
        `karpenter_events_total{type}` is the unbounded census."""
        out: Dict[str, int] = {}
        with self._lock:
            for ev in self._ring:
                out[ev.type] = out.get(ev.type, 0) + 1
        return out

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
