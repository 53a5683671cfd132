"""Trace renderer: span rings and sim traces -> Chrome-trace JSON.

``python -m karpenter_tpu_torch obs INPUT`` converts any of

- a span dump (``Tracer.dump`` JSON, also served live at ``/trace``) —
  every recorded span becomes a duration event, one timeline row per
  trace ID, so "where did the tick go" reads as a flame slice;
- a recorded sim trace (the JSONL the scenario runner writes) — ticks
  become duration events on a ``sim`` row, injected scenario events and
  cluster-ledger events become instant markers, and the per-tick digest
  becomes counter tracks (pending pods, nodes, running instances); or
- a flight-recorder dump (obs/flight.py JSONL, dumped on SLOBreach /
  crash / SIGUSR1 or fetched from ``/debug/flight``) — ticks become
  duration events (wall durations on the injected-clock timeline),
  ledger events become instant markers, per-tick spans nest under their
  tick, and the cluster summary becomes counter tracks — so a breach
  artifact opens directly in Perfetto

into Chrome-trace (Perfetto / chrome://tracing loadable) JSON, plus a
terminal top-N SELF-time table — the ``pprof -top`` analogue, computed
by subtracting each span path's direct children from its inclusive
total.  The renderer is read-only tooling: a CI artifact (a crashed
run's trace, a span dump from a live /trace scrape) is enough input.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

_US = 1_000_000  # chrome-trace timestamps are microseconds


# ------------------------------------------------------------- span dumps
def chrome_from_spans(payload: dict) -> dict:
    """Tracer.dump payload -> chrome-trace dict.  Spans are placed on
    one thread row per trace ID (unattributed spans share a row), with
    start times normalized to the earliest recorded span."""
    recent = payload.get("recent", [])
    starts = [s.get("start_s", 0.0) for s in recent]
    base = min(starts) if starts else 0.0
    tids: Dict[str, int] = {}
    events: List[dict] = []
    for s in recent:
        trace_id = s.get("trace_id", "") or "(untraced)"
        tid = tids.setdefault(trace_id, len(tids) + 1)
        events.append(
            {
                "name": s["path"],
                "ph": "X",
                "ts": round((s.get("start_s", 0.0) - base) * _US, 3),
                "dur": round(s.get("duration_s", 0.0) * _US, 3),
                "pid": 1,
                "tid": tid,
                "args": {"trace_id": trace_id, **s.get("meta", {})},
            }
        )
    events += [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": 1,
            "tid": tid,
            "args": {"name": trace_id},
        }
        for trace_id, tid in tids.items()
    ]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def self_times(stats: Dict[str, dict]) -> List[Tuple[str, float, int]]:
    """(path, self_seconds, count) rows, self-time descending: each
    path's inclusive total minus its DIRECT children's totals (dotted
    span paths encode the nesting)."""
    rows = []
    for path, st in stats.items():
        child_total = sum(
            other["total_s"]
            for other_path, other in stats.items()
            if other_path.startswith(path + ".")
            and "." not in other_path[len(path) + 1 :]
        )
        rows.append(
            (path, max(st["total_s"] - child_total, 0.0), st["count"])
        )
    rows.sort(key=lambda r: -r[1])
    return rows


def top_table(stats: Dict[str, dict], n: int = 20) -> str:
    """Terminal top-N self-time table (the text-mode pprof -top)."""
    rows = self_times(stats)[:n]
    out = [f"{'span':48s} {'count':>8s} {'self_ms':>10s} {'self_avg_ms':>12s}"]
    for path, self_s, count in rows:
        avg = self_s / count if count else 0.0
        out.append(
            f"{path:48s} {count:8d} {self_s * 1000:10.1f} {avg * 1000:12.3f}"
        )
    return "\n".join(out)


# -------------------------------------------------------------- sim traces
def chrome_from_sim_trace(lines: List[dict]) -> dict:
    """Recorded sim-trace lines -> chrome-trace dict.

    Tick boundaries come from the ``tick`` lines' dt sequence; the
    absolute base is recovered from the first digest (`now` minus its
    tick's dt), so ledger events — which carry absolute simulated
    timestamps — land inside their ticks."""
    ticks: Dict[int, Tuple[float, str]] = {}
    order: List[int] = []
    for ln in lines:
        if ln.get("t") == "tick":
            ticks[ln["tick"]] = (ln["dt"], ln.get("phase", "run"))
            order.append(ln["tick"])
    first_dig = next((ln for ln in lines if ln.get("t") == "dig"), None)
    base = 0.0
    if first_dig is not None and order:
        base = first_dig["now"] - ticks[order[0]][0]
    starts: Dict[int, float] = {}
    cur = base
    for tick in order:
        starts[tick] = cur
        cur += ticks[tick][0]

    def ts(t: float) -> float:
        return round((t - base) * _US, 3)

    events: List[dict] = []
    meta = next((ln for ln in lines if ln.get("t") == "meta"), {})
    for tick in order:
        dt, phase = ticks[tick]
        events.append(
            {
                "name": f"tick {tick} ({phase})",
                "ph": "X",
                "ts": ts(starts[tick]),
                "dur": round(dt * _US, 3),
                "pid": 1,
                "tid": 1,
                "args": {"tick": tick, "phase": phase},
            }
        )
    for ln in lines:
        t = ln.get("t")
        if t == "ev":
            events.append(
                {
                    "name": ln["kind"],
                    "ph": "i",
                    "s": "t",
                    "ts": ts(starts.get(ln["tick"], base)),
                    "pid": 1,
                    "tid": 2,
                    "args": dict(ln.get("data", {})),
                }
            )
        elif t == "led":
            events.append(
                {
                    "name": ln["type"],
                    "ph": "i",
                    "s": "t",
                    "ts": ts(ln.get("ts", starts.get(ln["tick"], base))),
                    "pid": 1,
                    "tid": 3,
                    "args": {
                        "trace_id": ln.get("trace_id", ""),
                        **ln.get("attrs", {}),
                    },
                }
            )
        elif t == "dig":
            for counter in ("pending", "nodes", "running"):
                events.append(
                    {
                        "name": counter,
                        "ph": "C",
                        "ts": ts(ln["now"]),
                        "pid": 1,
                        "tid": 0,
                        "args": {counter: ln.get(counter, 0)},
                    }
                )
    events += [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
         "args": {"name": "ticks"}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2,
         "args": {"name": "injected events"}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 3,
         "args": {"name": "cluster ledger"}},
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": f"sim {meta.get('scenario', '?')} "
                          f"seed={meta.get('seed', '?')}"}},
    ]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def sim_event_counts(lines: List[dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for ln in lines:
        if ln.get("t") == "led":
            out[ln["type"]] = out.get(ln["type"], 0) + 1
    return out


# ------------------------------------------------------------ flight dumps
def chrome_from_flight(flight: dict) -> dict:
    """Flight-recorder dump (obs/flight.py) -> chrome-trace dict.  Ticks
    are duration events placed at their injected-clock timestamps with
    their WALL durations (a 1s-cadence loop whose ticks take ~10ms reads
    as sparse slices — correct: the gaps are idle time); ledger events
    are instants on their own row, per-tick spans nest on a third row,
    and the pending/nodes/running summary becomes counter tracks."""
    ticks = flight["ticks"]
    base = ticks[0]["ts"] if ticks else 0.0

    def ts(t: float) -> float:
        return round((t - base) * _US, 3)

    events: List[dict] = []
    for tick in ticks:
        start = tick["ts"] - tick.get("dur_s", 0.0)
        events.append(
            {
                "name": f"tick {tick['seq']}",
                "ph": "X",
                "ts": ts(start),
                "dur": round(tick.get("dur_s", 0.0) * _US, 3),
                "pid": 1,
                "tid": 1,
                "args": {
                    "trace_id": tick.get("trace_id", ""),
                    **tick.get("summary", {}),
                },
            }
        )
        for ev in tick.get("events", []):
            events.append(
                {
                    "name": ev.get("type", "?"),
                    "ph": "i",
                    "s": "t",
                    "ts": ts(ev.get("ts", tick["ts"])),
                    "pid": 1,
                    "tid": 2,
                    "args": {
                        "trace_id": ev.get("trace_id", ""),
                        **ev.get("attrs", {}),
                    },
                }
            )
        # spans carry perf_counter starts, not clock time: re-anchor them
        # inside their tick proportionally to their own earliest start
        spans = tick.get("spans", [])
        if spans:
            s0 = min(s.get("start_s", 0.0) for s in spans)
            for s in spans:
                events.append(
                    {
                        "name": s["path"],
                        "ph": "X",
                        "ts": ts(start + (s.get("start_s", 0.0) - s0)),
                        "dur": round(s.get("duration_s", 0.0) * _US, 3),
                        "pid": 1,
                        "tid": 3,
                        "args": dict(s.get("meta", {})),
                    }
                )
        for counter in ("pending", "nodes", "running"):
            if counter in tick.get("summary", {}):
                events.append(
                    {
                        "name": counter,
                        "ph": "C",
                        "ts": ts(tick["ts"]),
                        "pid": 1,
                        "tid": 0,
                        "args": {counter: tick["summary"][counter]},
                    }
                )
        # device observatory section -> counter tracks: the per-tick
        # upload bytes and compile counts sit on the timeline next to
        # the tick durations, so a recompile storm or transfer spike is
        # visible at the same glance as the phase slices
        dev = tick.get("device") or {}
        for counter in (
            "transfer_bytes", "compiles", "warm_recompiles",
            "resident_bytes",
        ):
            if counter in dev:
                events.append(
                    {
                        "name": f"device.{counter}",
                        "ph": "C",
                        "ts": ts(tick["ts"]),
                        "pid": 1,
                        "tid": 0,
                        "args": {counter: dev[counter]},
                    }
                )
    events += [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
         "args": {"name": "ticks"}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2,
         "args": {"name": "cluster ledger"}},
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 3,
         "args": {"name": "spans"}},
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": f"flight ({flight['meta'].get('trigger', '?')})"}},
    ]
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def flight_event_counts(flight: dict) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for tick in flight["ticks"]:
        for ev in tick.get("events", []):
            out[ev["type"]] = out.get(ev["type"], 0) + 1
    return out


# --------------------------------------------------------------------- CLI
def _load(path: str) -> Tuple[str, object]:
    """Autodetect the input kind: ('sim', jsonl lines) for a scenario
    trace (first line has ``"t": "meta"``), ('flight', flight dict) for
    a flight-recorder dump (first line has ``"t": "flight"``),
    ('spans', payload) for a Tracer dump / a /trace scrape."""
    with open(path) as f:
        text = f.read()
    first = text.lstrip().split("\n", 1)[0]
    try:
        head = json.loads(first)
    except json.JSONDecodeError:
        head = None
    if isinstance(head, dict) and head.get("t") == "meta":
        return "sim", [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    if isinstance(head, dict) and head.get("t") == "flight":
        from karpenter_tpu_torch.obs.flight import read_flight

        return "flight", read_flight(text)
    payload = json.loads(text)
    if isinstance(payload, dict) and (
        "stats" in payload or "recent" in payload
    ):
        return "spans", payload
    raise ValueError(
        f"{path}: not a sim trace (JSONL with a meta line), a flight dump "
        "(JSONL with a flight header), or a span dump (JSON with "
        "stats/recent)"
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch obs",
        description="render a span dump or a recorded sim trace as "
        "Chrome-trace (Perfetto-loadable) JSON + a top-N self-time table",
    )
    parser.add_argument(
        "input",
        help="a sim trace JSONL (sim-<scenario>-seed<N>.jsonl), a flight-"
        "recorder dump (flight-<trace>.jsonl / a /debug/flight fetch), or "
        "a span dump JSON (Tracer.dump / a /trace scrape)",
    )
    parser.add_argument(
        "--out",
        default="",
        help="chrome-trace output path (default: INPUT + .chrome.json)",
    )
    parser.add_argument(
        "--top", type=int, default=20, help="rows in the self-time table"
    )
    args = parser.parse_args(argv)

    kind, data = _load(args.input)
    if kind == "sim":
        chrome = chrome_from_sim_trace(data)
        counts = sim_event_counts(data)
        if counts:
            print("cluster events recorded in the trace:")
            for type_, n in sorted(counts.items()):
                print(f"  {type_:20s} {n:6d}")
        else:
            print("no cluster-ledger lines in this trace")
    elif kind == "flight":
        chrome = chrome_from_flight(data)
        counts = flight_event_counts(data)
        if counts:
            print("cluster events recorded in the flight dump:")
            for type_, n in sorted(counts.items()):
                print(f"  {type_:20s} {n:6d}")
        else:
            print("no cluster events in this flight dump")
        print(
            "diagnose it: python -m karpenter_tpu_torch doctor "
            f"{args.input}", file=sys.stderr,
        )
    else:
        chrome = chrome_from_spans(data)
        stats = data.get("stats", {})
        if stats:
            print(top_table(stats, args.top))

    out_path = args.out or (args.input + ".chrome.json")
    with open(out_path, "w") as f:
        json.dump(chrome, f, sort_keys=True)
    print(
        f"chrome trace -> {out_path} "
        f"({len(chrome['traceEvents'])} events); load it in "
        "https://ui.perfetto.dev or chrome://tracing",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
