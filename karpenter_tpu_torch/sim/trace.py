"""Trace record/replay for the cluster simulator.

A trace is a JSONL file: one JSON object per line, keys sorted, compact
separators — so two runs are comparable byte-for-byte.  Line types:

    {"t": "meta", ...}            run header (scenario/seed/ticks/tick_s)
    {"t": "tick", "tick", "dt", "phase"}   a tick boundary + its duration
    {"t": "ev",   "tick", "kind", "data"}  one injected scenario event
    {"t": "api",  "tick", "api", "args"}   one cloud API call (at entry)
    {"t": "led",  "tick", ...}    one cluster-ledger event (obs/events.py):
                                  seq/ts/type/trace_id/attrs — the
                                  controllers' decisions on the tick's
                                  trace timeline
    {"t": "dig",  "tick", ...}    per-tick state digest (counts + sha)
    {"t": "report", "slo": ...}   the final deterministic SLO report

Values ride the existing tagged wire codec (state/wire.py): event data is
plain JSON by construction, API args and digest hashing go through
``to_wire``/``canonical`` so dataclass arguments (SelectorTerm, ...)
encode without pickling.  Fake-cloud dataclasses are registered into the
codec here via ``register_dataclass`` — the store protocol itself never
ships them, but the trace does.

``ev`` and ``tick`` lines are the REPLAYABLE surface: `read_tape` turns a
recorded trace back into the per-tick event schedule a ScenarioRunner can
re-execute without the original generators.  ``api`` and ``dig`` lines
are evidence — they exist to make two runs diffable, not to be decoded.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, IO, List, Optional, Tuple

from karpenter_tpu_torch.utils.locks import make_lock
from karpenter_tpu_torch.cloud.fake.backend import (
    FakeImage,
    FakeInstance,
    FakeLaunchTemplate,
    FakeSecurityGroup,
    FakeSubnet,
    MachineShape,
)
from karpenter_tpu_torch.state.wire import canonical, register_dataclass, to_wire

for _cls in (
    FakeImage,
    FakeInstance,
    FakeLaunchTemplate,
    FakeSecurityGroup,
    FakeSubnet,
    MachineShape,
):
    register_dataclass(_cls)

TRACE_VERSION = 1


def _dumps(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _wire_args(args: tuple) -> list:
    """API args -> wire trees.  An argument the codec cannot encode
    degrades to its type name (never repr: default reprs carry memory
    addresses, which would break byte-identical traces)."""
    out = []
    for a in args:
        try:
            out.append(to_wire(a))
        except TypeError:
            out.append({"!m": {"~unencodable": type(a).__name__}})
    return out


class TraceWriter:
    """Appends trace lines to an optional file AND an in-memory buffer
    (`text()`, `sha256()`).  Thread-safe: the recorder tap fires from
    batcher worker threads."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh: Optional[IO[str]] = open(path, "w") if path else None
        self._lines: List[str] = []
        self._lock = make_lock("TraceWriter._lock")
        self.tick = -1  # set by the runner; -1 = before the first tick

    # ------------------------------------------------------------- writing
    def _write(self, obj: dict) -> None:
        line = _dumps(obj)
        with self._lock:
            self._lines.append(line)
            if self._fh is not None:
                # line-buffered on purpose: the trace is the reproduction
                # artifact for a CRASHING run, so the ticks leading up to
                # the failure must already be on disk when it dies
                self._fh.write(line + "\n")
                self._fh.flush()

    def meta(self, scenario: str, seed: int, ticks: int, tick_s: float) -> None:
        self._write(
            {
                "t": "meta",
                "v": TRACE_VERSION,
                "scenario": scenario,
                "seed": seed,
                "ticks": ticks,
                "tick_s": tick_s,
            }
        )

    def tick_start(self, tick: int, dt: float, phase: str = "run") -> None:
        self.tick = tick
        self._write({"t": "tick", "tick": tick, "dt": dt, "phase": phase})

    def event(self, tick: int, kind: str, data: dict) -> None:
        self._write({"t": "ev", "tick": tick, "kind": kind, "data": data})

    def api(self, api: str, args: tuple) -> None:
        self._write(
            {"t": "api", "tick": self.tick, "api": api, "args": _wire_args(args)}
        )

    def ledger(self, tick: int, ev) -> None:
        """One cluster-ledger event (obs/events.py ObsEvent).  Part of the
        byte-comparable surface: everything in it is a function of the
        injected clock and seeded decisions, so a replay re-emits the
        identical lines (tests/test_obs.py pins this).  NOT part of the
        replay tape — `read_tape` skips it (the controllers re-emit the
        events when the tape re-executes)."""
        self._write(
            {
                "t": "led",
                "tick": tick,
                "seq": ev.seq,
                "ts": ev.ts,
                "type": ev.type,
                "trace_id": ev.trace_id,
                "attrs": dict(ev.attrs),
            }
        )

    def digest(self, tick: int, env) -> None:
        """Per-tick state fingerprint: headline counts for humans, a sha
        over the full canonical state for regression diffing."""
        kube, cloud = env.kube, env.cloud
        running = sum(
            1 for i in cloud.instances.values() if i.state == "running"
        )
        h = hashlib.sha256()
        for attr in ("pods", "nodes", "node_claims", "node_pools"):
            store = getattr(kube, attr)
            for key in sorted(store):
                h.update(f"{attr}/{key}=".encode())
                h.update(canonical(store[key]).encode())
        for iid in sorted(cloud.instances):
            h.update(f"inst/{iid}=".encode())
            h.update(canonical(cloud.instances[iid]).encode())
        self._write(
            {
                "t": "dig",
                "tick": tick,
                "now": env.clock.now(),
                "pods": len(kube.pods),
                "pending": len(kube.pending_pods()),
                "nodes": len(kube.nodes),
                "claims": len(kube.node_claims),
                "running": running,
                "sha": h.hexdigest()[:16],
            }
        )

    def report(self, slo: dict) -> None:
        self._write({"t": "report", "slo": slo})

    # ------------------------------------------------------------- reading
    def text(self) -> str:
        with self._lock:
            return "\n".join(self._lines) + ("\n" if self._lines else "")

    def sha256(self) -> str:
        return hashlib.sha256(self.text().encode()).hexdigest()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ------------------------------------------------------------------ replay
def read_trace(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_tape(
    path: str,
) -> Tuple[dict, Dict[int, Tuple[float, List[Tuple[str, dict]]]], Optional[dict]]:
    """Trace file -> (meta, tape, recorded_slo_report).

    The tape maps tick -> (dt, [(kind, data), ...]) covering the "run"
    phase only: drain/settle ticks inject nothing and re-derive from the
    scenario, so they are not part of the replayable schedule."""
    meta: Optional[dict] = None
    tape: Dict[int, Tuple[float, List[Tuple[str, dict]]]] = {}
    slo: Optional[dict] = None
    for line in read_trace(path):
        t = line.get("t")
        if t == "meta":
            meta = line
        elif t == "tick" and line.get("phase") == "run":
            tape[line["tick"]] = (line["dt"], [])
        elif t == "ev":
            tape[line["tick"]][1].append((line["kind"], line["data"]))
        elif t == "report":
            slo = line["slo"]
    if meta is None:
        raise ValueError(f"not a sim trace (no meta line): {path}")
    return meta, tape, slo
