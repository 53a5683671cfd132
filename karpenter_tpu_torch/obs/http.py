"""Live telemetry endpoint: /metrics, /healthz, /events, /trace.

The reference serves ~50 Prometheus series plus pprof handlers on its
metrics port (website v0.31 concepts/metrics.md, settings.md:18); this is
that surface for the reproduction, mounted on BOTH the operator process
(`python -m karpenter_tpu_torch --metrics-port`) and the store server
(`store-server --telemetry-port`):

- ``/metrics``  real Prometheus exposition (HELP/TYPE headers from the
                shared metric catalog, cumulative histogram buckets) —
                scrapeable by an actual Prometheus server;
- ``/healthz``  liveness (``ok``) — the chart's probe target;
- ``/events``   the cluster event ledger as JSON, with cursor support:
                ``?since_seq=N&limit=M`` pages forward from a poller's
                last seen sequence number, and the payload's ``dropped``
                count says how many events aged out of the ring before
                the cursor caught up — a poller can fall behind, but
                never silently.  ``ring_counts`` are per-type counts over
                the bounded ring; ``total_counts`` mirror the cumulative
                ``karpenter_events_total`` census (the two diverge once
                the ring overflows — by design);
- ``/trace``    the span tracer's aggregates + recent spans as JSON —
                feedable to ``python -m karpenter_tpu_torch obs`` for a
                Perfetto-loadable timeline;
- ``/debug/flight``  the flight recorder's ring (obs/flight.py) as
                JSONL — the same artifact a breach dumps to disk, for
                ``python -m karpenter_tpu_torch doctor http://host:port``;
- ``/debug/device``  the device observatory's live snapshot
                (obs/device.py): new launch signatures / warm ones per
                kernel entry point, library build seconds, transfer
                bytes per site,
                and the resident device-buffer footprint per consumer —
                "what lives on the device and what crossed the link";
- ``/debug/tenants``  the solver service's per-tenant admission state
                (service/server.py tenants_payload): in-flight counts,
                solve/batch/refusal tallies, resident footprints vs the
                device-bytes budget, and tenant-scoped ledger slices —
                "who is on the mesh and what are they costing".

Every request bumps ``karpenter_telemetry_scrapes_total{endpoint}`` so
the scrape cadence is itself observable (a stalled scraper is an
outage-in-waiting).  Stdlib-only by design: the container bakes no
client libraries, and a ThreadingHTTPServer is plenty for one scraper
plus a human.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from karpenter_tpu_torch.metrics.registry import Registry, exposition


def _trace_payload(tracer) -> dict:
    return {
        "stats": {
            path: {"count": st.count, "total_s": st.total_s, "max_s": st.max_s}
            for path, st in tracer.stats().items()
        },
        "recent": [
            {
                "path": s.path,
                "start_s": s.start_s,
                "duration_s": s.duration_s,
                "trace_id": s.trace_id,
                "meta": s.meta,
            }
            for s in tracer.recent(500)
        ],
    }


def _int_param(params: dict, name: str, default: int) -> int:
    try:
        return int(params.get(name, [default])[0])
    except (TypeError, ValueError):
        return default


def events_payload(ledger, registry: Registry, params: dict) -> dict:
    """The /events JSON body.  ``since_seq``/``limit`` page the ring
    forward (oldest first); WITHOUT a cursor the newest ``limit`` events
    are served — a bare curl must show what just happened, not the
    oldest survivors of a full ring.  ``last_seq`` is the cursor for the
    next poll.  ``dropped``
    counts events the cursor missed because they aged out of the
    4096-entry ring — without it a slow poller silently undercounts.
    ``ring_counts`` (the old ambiguous ``counts``) covers only what the
    ring still holds; ``total_counts`` is the cumulative
    ``karpenter_events_total`` census from the registry."""
    since_seq = _int_param(params, "since_seq", 0)
    limit = _int_param(params, "limit", 500)
    if ledger is None:
        events, dropped = [], 0
    elif "since_seq" in params:
        # cursor mode: page forward from the poller's last seen seq,
        # oldest first, with the dropped count for ring overflow
        events, dropped = ledger.read(since_seq, limit)
    else:
        # no cursor: the human-curl case — serve the NEWEST events, the
        # "why did that node go away?" surface
        events, dropped = ledger.recent(limit), 0
    with registry._lock:
        # copy under the lock: the operator thread inserts a NEW label
        # key the instant a first-of-its-type event fires — exactly the
        # moment a poller is most likely to be reading this
        census = dict(registry.counters.get("karpenter_events_total", {}))
    total_counts = {
        labels[0][1] if labels else "": int(v)
        for labels, v in census.items()
    }
    return {
        "events": [ev.to_dict() for ev in events],
        "last_seq": events[-1].seq if events else since_seq,
        "dropped": dropped,
        "ring_counts": ledger.counts() if ledger is not None else {},
        "total_counts": dict(sorted(total_counts.items())),
    }


def start_telemetry(
    port: int,
    registry: Registry,
    tracer=None,
    ledger=None,
    flight=None,
    device=None,
    tenants=None,
    host: str = "",
) -> ThreadingHTTPServer:
    """Serve the telemetry surface on (host, port) in a daemon thread;
    port 0 binds a free port (tests).  Returns the server (its
    ``server_address[1]`` is the bound port; ``shutdown()`` stops it)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            path, _, query = self.path.partition("?")
            known = (
                "/metrics", "/healthz", "/events", "/trace",
                "/debug/flight", "/debug/device", "/debug/tenants",
            )
            if path not in known:
                self.send_response(404)
                self.end_headers()
                return
            # counting BEFORE rendering: the scrape that reads the
            # counter sees itself, so the series is never 0 on a
            # scraped process
            registry.inc(
                "karpenter_telemetry_scrapes_total",
                {"endpoint": path.strip("/")},
            )
            if path == "/metrics":
                body = exposition(registry).encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/healthz":
                body = b"ok"
                ctype = "text/plain"
            elif path == "/events":
                payload = events_payload(
                    ledger, registry, urllib.parse.parse_qs(query)
                )
                body = json.dumps(payload, sort_keys=True).encode()
                ctype = "application/json"
            elif path == "/debug/flight":
                lines = (
                    flight.dump_lines(trigger="http")
                    if flight is not None
                    else []
                )
                if flight is not None:
                    # dump_lines itself never counts (FlightRecorder.dump
                    # counts after a successful disk write); the served
                    # dump counts here so the documented {trigger="http"}
                    # series exists
                    registry.inc(
                        "karpenter_flight_dumps_total", {"trigger": "http"}
                    )
                body = ("\n".join(lines) + "\n").encode() if lines else b""
                ctype = "application/x-ndjson"
            elif path == "/debug/device":
                payload = (
                    device.snapshot() if device is not None else {}
                )
                body = json.dumps(payload, sort_keys=True).encode()
                ctype = "application/json"
            elif path == "/debug/tenants":
                # ``tenants`` is a callable (the solver service's
                # tenants_payload) so every scrape sees live state
                payload = tenants() if tenants is not None else {}
                body = json.dumps(payload, sort_keys=True).encode()
                ctype = "application/json"
            else:  # /trace
                payload = (
                    _trace_payload(tracer) if tracer is not None else {}
                )
                body = json.dumps(payload, sort_keys=True).encode()
                ctype = "application/json"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet access log
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(
        target=server.serve_forever, daemon=True, name=f"telemetry-{port}"
    ).start()
    return server
