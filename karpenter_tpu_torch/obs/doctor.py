"""``python -m karpenter_tpu_torch doctor`` — from telemetry to diagnosis.

Input: a flight-recorder dump (obs/flight.py JSONL) or a live process
(``http://host:port`` — fetches ``/debug/flight``).  Output: a terminal
diagnosis that answers "why was that tick slow / why did that SLO burn"
without a human staring at dashboards:

1. **phases vs rolling baseline** — per-phase self-time per tick comes
   from the dump's histogram deltas; the last ticks are compared against
   the median of the earlier ones, and regressing phases are named;
2. **event timeline bracketing the breach** — the ledger slice around
   the first ``SLOBreach`` (or the tail of the dump when nothing
   breached), one line per decision event;
3. **rule-based suspected causes** — deterministic correlations over the
   dump: "CircuitOpen on CreateFleet preceded the provisioning stall",
   "compile-cache misses spiked after the catalog roll", restated
   ``AnomalyDetected`` attributions, and (with ``--bench``) regressed
   lines from a ``bench.py --compare-out`` verdict.

``diagnose()`` is the pure core (tests assert on its dict, not on
terminal text); ``main()`` is the CLI shell around it.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.obs.flight import load_flight, read_flight

# how many trailing ticks count as "recent" when no breach anchors the
# split (a breach splits the dump at its tick instead)
RECENT_TICKS = 8

# a phase regresses when its recent median exceeds twice its baseline
# median AND moves by an absolute floor (sub-ms wiggle is not a story)
REGRESSION_FACTOR = 2.0
REGRESSION_FLOOR_S = 0.005

_SERIES_RE = re.compile(r"^(?P<name>[a-z0-9_]+)(?:\{(?P<labels>.*)\})?$")

# histogram family -> short prefix used in phase keys ("solver/compile")
_FAMILY_SHORT = {
    "karpenter_solver_phase_seconds": "solver",
    "karpenter_consolidation_phase_seconds": "consolidation",
    "karpenter_consolidation_search_phase_seconds": "search",
    "karpenter_reconcile_tick_duration_seconds": "tick",
    "karpenter_provisioner_scheduling_duration_seconds": "scheduling",
    "karpenter_device_compile_seconds": "device_compile",
    "karpenter_store_rpc_seconds": "store_rpc",
    "karpenter_admission_latency_seconds": "admission",
}

# tenant-starvation thresholds (solver service): one tenant's mean
# solve-wait running this factor past the fleet median (with an
# absolute floor so microsecond jitter on an idle service never pages)
# means the weighted-round-robin share is not protecting it — a noisy
# neighbor is monopolizing the batch window or its weight is wrong
_STARVATION_FACTOR = 4.0
_STARVATION_FLOOR_S = 0.01
_STARVATION_MIN_SOLVES = 4

# device-rule thresholds: a warm tick's upload bytes must not grow past
# this factor of the baseline median (with an absolute floor so byte
# jitter on tiny problems never pages) while its resident delta rows
# stay flat — more bytes than the delta justifies means the warm path
# is silently re-uploading something it should have kept resident
_TRANSFER_FACTOR = 2.0
_TRANSFER_FLOOR_B = 4096
_ROWS_SLACK = 1.5


def _parse_series(key: str) -> Tuple[str, Dict[str, str]]:
    m = _SERIES_RE.match(key)
    if m is None:
        return key, {}
    labels = {}
    for pair in (m.group("labels") or "").split(","):
        if "=" in pair:
            k, _, v = pair.partition("=")
            labels[k] = v
    return m.group("name"), labels


def _median(values: List[float]) -> float:
    return statistics.median(values) if values else 0.0


# ----------------------------------------------------------------- analysis
def phase_series(ticks: List[dict]) -> Dict[str, List[float]]:
    """phase key ("solver/compile") -> per-tick self-time seconds, one
    entry per tick (0.0 on ticks where the phase did not run)."""
    out: Dict[str, List[float]] = {}
    for i, tick in enumerate(ticks):
        for key, delta in tick.get("hists", {}).items():
            name, labels = _parse_series(key)
            short = _FAMILY_SHORT.get(name)
            if short is None:
                continue
            # device compile series label per function, not phase
            phase = labels.get("phase", "") or labels.get("fn", "")
            pkey = f"{short}/{phase}" if phase else short
            series = out.setdefault(pkey, [0.0] * len(ticks))
            series[i] += float(delta.get("sum_s", 0.0))
    return out


def device_sections(ticks: List[dict]) -> List[dict]:
    """Per-tick ``device`` sections (obs/device.py tick_section; empty
    dicts for dumps predating the observatory)."""
    return [tick.get("device") or {} for tick in ticks]


def resident_delta_rows(ticks: List[dict]) -> List[float]:
    """Per-tick resident scatter rows (the delta-size the transfer rule
    normalizes upload bytes by), from the flight hist deltas."""
    out = []
    for tick in ticks:
        delta = tick.get("hists", {}).get(
            "karpenter_solver_resident_delta_rows", {}
        )
        out.append(float(delta.get("sum_s", 0.0)))
    return out


def ledger_events(ticks: List[dict]) -> List[Tuple[int, dict]]:
    """(tick index, event) pairs in emission order."""
    out = []
    for i, tick in enumerate(ticks):
        for ev in tick.get("events", []):
            out.append((i, ev))
    return out


def counter_deltas(ticks: List[dict], family: str) -> List[float]:
    """Per-tick delta of one counter family summed over its series."""
    out = []
    for tick in ticks:
        total = 0.0
        for key, delta in tick.get("counters", {}).items():
            name, _ = _parse_series(key)
            if name == family:
                total += float(delta)
        out.append(total)
    return out


def tenant_wait_stats(ticks: List[dict]) -> Dict[str, Tuple[int, float]]:
    """tenant -> (solves, total wait seconds) aggregated over the dump,
    from the solver service's per-tenant solve-wait histogram deltas."""
    out: Dict[str, Tuple[int, float]] = {}
    for tick in ticks:
        for key, delta in tick.get("hists", {}).items():
            name, labels = _parse_series(key)
            if name != "karpenter_service_solve_wait_seconds":
                continue
            tenant = labels.get("tenant", "?")
            c, s = out.get(tenant, (0, 0.0))
            out[tenant] = (
                c + int(delta.get("count", 0)),
                s + float(delta.get("sum_s", 0.0)),
            )
    return out


def _split_index(ticks: List[dict], events) -> int:
    """Where baseline ends and "recent" begins: the first SLOBreach's
    tick when one exists, else the last RECENT_TICKS."""
    for i, ev in events:
        if ev.get("type") == "SLOBreach":
            return max(1, i)
    return max(1, len(ticks) - RECENT_TICKS)


def phase_analysis(ticks: List[dict], split: int) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for pkey, series in sorted(phase_series(ticks).items()):
        base = _median(series[:split])
        recent = _median(series[split:])
        regressing = (
            recent > base * REGRESSION_FACTOR
            and recent - base > REGRESSION_FLOOR_S
        )
        out[pkey] = {
            "baseline_ms": round(base * 1000.0, 3),
            "recent_ms": round(recent * 1000.0, 3),
            "ratio": round(recent / base, 2) if base > 0 else None,
            "regressing": regressing,
        }
    return out


# ------------------------------------------------------- suspected causes
def suspected_causes(
    ticks: List[dict],
    events: List[Tuple[int, dict]],
    phases: Dict[str, dict],
    bench_verdict: Optional[dict] = None,
    split: Optional[int] = None,
) -> List[str]:
    causes: List[str] = []
    regressing = [k for k, p in phases.items() if p["regressing"]]
    breaches = [(i, ev) for i, ev in events if ev.get("type") == "SLOBreach"]
    if split is None:
        split = _split_index(ticks, events)

    # catalog roll -> compile-cache miss storm -> compile-phase blowup
    rolls = [(i, ev) for i, ev in events if ev.get("type") == "CatalogRolled"]
    if rolls:
        i, roll = rolls[0]
        misses = counter_deltas(
            ticks, "karpenter_solver_compile_cache_misses_total"
        )
        # the roll tick's own misses belong to the roll: the invalidation
        # happens mid-tick, before that tick's solves recompile
        before, after = sum(misses[:i]), sum(misses[i:])
        if after > before:
            msg = (
                f"compile-cache misses spiked after the catalog roll "
                f"(CatalogRolled seq {roll.get('seq')}, tick "
                f"{roll.get('trace_id') or i}): {int(after)} misses after "
                f"vs {int(before)} before"
            )
            compile_keys = [k for k in regressing if k.endswith("/compile")]
            if compile_keys:
                k = compile_keys[0]
                p = phases[k]
                msg += (
                    f"; phase '{k}' regressed to {p['recent_ms']}ms "
                    f"(baseline {p['baseline_ms']}ms)"
                )
            causes.append(msg)

    # circuit open -> provisioning stall
    opens = [(i, ev) for i, ev in events if ev.get("type") == "CircuitOpen"]
    if opens:
        pending = [t.get("summary", {}).get("pending", 0) for t in ticks]
        i, op_ev = opens[0]
        stalled = (
            max(pending[i:], default=0) > max(pending[:i], default=0)
            or any(
                bev.get("attrs", {}).get("rule") == "pending-pod-age"
                for _, bev in breaches
            )
        )
        if stalled:
            causes.append(
                f"CircuitOpen on {op_ev.get('attrs', {}).get('api', '?')} "
                f"(seq {op_ev.get('seq')}) preceded a provisioning stall: "
                f"pending peaked at {max(pending[i:], default=0)} afterwards"
            )

    # shard stuck in migration: a store shard raised its export fence
    # (migration begun) but the coordinator never confirmed the drop
    # (migration committed) — the shard is serving with a rotated epoch
    # and keys that may already live at their new owner.  Matched
    # per-shard so a commit on one shard cannot mask a stall on another.
    begun: Dict[str, float] = {}
    committed: Dict[str, float] = {}
    last_begun_tick: Dict[str, int] = {}
    for i, tick in enumerate(ticks):
        for key, delta in tick.get("counters", {}).items():
            name, labels = _parse_series(key)
            shard = labels.get("shard", "?")
            if name == "karpenter_store_shard_migration_begun_total":
                begun[shard] = begun.get(shard, 0.0) + float(delta)
                last_begun_tick[shard] = i
            elif name == "karpenter_store_shard_migration_committed_total":
                committed[shard] = committed.get(shard, 0.0) + float(delta)
    for shard in sorted(begun):
        pending_migrations = begun[shard] - committed.get(shard, 0.0)
        if pending_migrations > 0:
            causes.append(
                f"store shard {shard} stuck in migration: "
                f"{int(begun[shard])} migration(s) begun but only "
                f"{int(committed.get(shard, 0.0))} committed (last begun "
                f"at tick {last_begun_tick[shard]}) — its export fence "
                "rotated the epoch but the key drop never landed; "
                "re-run the reshard or restore the old topology"
            )

    # ---- device observatory rules (obs/device.py tick sections) -------
    dev = device_sections(ticks)
    compiles = [int(d.get("compiles", 0) or 0) for d in dev]
    warm = [int(d.get("warm_recompiles", 0) or 0) for d in dev]

    # device recompile storm: new launch signatures concentrated AFTER a
    # catalog roll — the device-layer twin of the compile-cache-miss
    # rule above (the roll obsoletes the resident tensors and the padded
    # shapes, so every kernel entry point launches at new shapes).  The
    # port's observatory counts a new launch signature where the JAX
    # package counts a jit compile (obs/device.py)
    storm_named = False
    if rolls and any(compiles):
        i, roll = rolls[0]
        before, after = sum(compiles[:i]), sum(compiles[i:])
        if after > before:
            storm_named = True
            msg = (
                f"device recompile storm after the catalog roll "
                f"(CatalogRolled seq {roll.get('seq')}, tick "
                f"{roll.get('trace_id') or i}): {after} new launch signature(s) "
                f"in the {len(ticks) - i} tick(s) after vs {before} before"
            )
            if sum(warm[i:]):
                msg += f", {sum(warm[i:])} on warm kernel entry points"
            dc_keys = [
                k for k in regressing if k.startswith("device_compile")
            ]
            if dc_keys:
                p = phases[dc_keys[0]]
                msg += (
                    f"; compile time '{dc_keys[0]}' regressed to "
                    f"{p['recent_ms']}ms (baseline {p['baseline_ms']}ms)"
                )
            causes.append(msg)
    if sum(warm) and not storm_named:
        # warm new signatures the storm rule did NOT explain — either
        # no roll at all, or a roll with no spike behind it: something
        # launches at new shapes on a steady cluster (bucket churn, a
        # resident state re-seeded)
        first = next(i for i, w in enumerate(warm) if w)
        causes.append(
            f"{sum(warm)} warm-tick new launch signature(s) not explained "
            f"by a catalog roll (first at tick {first}): a kernel entry "
            "point is launching at new shapes on a steady cluster — look "
            "for padded-bucket churn or a resident state re-seeded"
        )

    # transfer regression: warm ticks uploading more than their resident
    # delta rows justify — the warm path's contract is that a tick ships
    # only its scatter payloads (docs/designs/observability.md §device)
    xfer = [int(d.get("transfer_bytes", 0) or 0) for d in dev]
    if any(xfer):
        rows = resident_delta_rows(ticks)
        base_b, rec_b = _median(xfer[:split]), _median(xfer[split:])
        base_r, rec_r = _median(rows[:split]), _median(rows[split:])
        if (
            rec_b > base_b * _TRANSFER_FACTOR
            and rec_b - base_b > _TRANSFER_FLOOR_B
            and rec_r <= base_r * _ROWS_SLACK + 1.0
        ):
            causes.append(
                f"warm-tick transfer regression: ticks past the split "
                f"upload a median {int(rec_b)}B vs {int(base_b)}B "
                f"baseline while resident delta rows stayed flat "
                f"({base_r:g} -> {rec_r:g}) — the uploads are not "
                "justified by the cluster delta"
            )

    # ---- admission fast path rules (controllers/provisioning.py) ------
    # fallback storm: the single-pod fast path declining at a spiking
    # rate after the split — every decline re-routes an arrival through
    # the batched solve (latency regression for exactly the traffic the
    # fast path exists for), and the dominant reason names the trigger
    # (catalog_roll -> resident tensors obsoleted; resident_miss ->
    # delta planner churn; pod_shape -> the workload stopped being plain)
    fb_per_tick = [0.0] * len(ticks)
    fb_reasons: Dict[str, float] = {}
    fp_mismatches = 0.0
    for i, tick in enumerate(ticks):
        for key, delta in tick.get("counters", {}).items():
            name, labels = _parse_series(key)
            if name == "karpenter_admission_fastpath_fallback_total":
                fb_per_tick[i] += float(delta)
                reason = labels.get("reason", "?")
                fb_reasons[reason] = fb_reasons.get(reason, 0.0) + float(delta)
            elif name == "karpenter_admission_fastpath_mismatch_total":
                fp_mismatches += float(delta)
    fb_before, fb_after = sum(fb_per_tick[:split]), sum(fb_per_tick[split:])
    if fb_after > fb_before and fb_after >= 4:
        top = max(fb_reasons, key=fb_reasons.get) if fb_reasons else "?"
        causes.append(
            f"admission fast-path fallback storm: {int(fb_after)} "
            f"fallback(s) in the {len(ticks) - split} tick(s) after the "
            f"split vs {int(fb_before)} before — single-pod arrivals are "
            f"re-routing through the batched solve; dominant reason "
            f"'{top}' ({int(fb_reasons.get(top, 0))} of "
            f"{int(sum(fb_reasons.values()))})"
        )
    if fp_mismatches:
        causes.append(
            f"{int(fp_mismatches)} admission fast-path verdict "
            "mismatch(es): the admit dispatch disagreed with the "
            "sequential host oracle — the convergence contract requires "
            "this counter to stay 0; no pod was nominated off the "
            "disagreeing verdict, but the device arithmetic (or the "
            "resident mirrors) has drifted and needs a bug hunt"
        )

    # ---- solver service rules (service/server.py) ---------------------
    # tenant starvation: one tenant's mean solve-wait running far past
    # the fleet median — the weighted-round-robin share is not
    # protecting it (noisy neighbor monopolizing the coalesce window,
    # or a misconfigured weight); refusal counts name the backpressure
    # the starved tenant also ate
    waits = tenant_wait_stats(ticks)
    means = {
        t: s / c
        for t, (c, s) in waits.items()
        if c >= _STARVATION_MIN_SOLVES
    }
    if len(means) >= 2:
        fleet_median = _median(sorted(means.values()))
        refusals: Dict[str, float] = {}
        for tick in ticks:
            for key, delta in tick.get("counters", {}).items():
                name, labels = _parse_series(key)
                if name == "karpenter_service_refusals_total":
                    t = labels.get("tenant", "?")
                    refusals[t] = refusals.get(t, 0.0) + float(delta)
        for t in sorted(means):
            mean = means[t]
            if (
                mean > fleet_median * _STARVATION_FACTOR
                and mean - fleet_median > _STARVATION_FLOOR_S
            ):
                msg = (
                    f"tenant '{t}' starving in the solver service: mean "
                    f"solve-wait {mean * 1000.0:.1f}ms over "
                    f"{waits[t][0]} solve(s) vs fleet median "
                    f"{fleet_median * 1000.0:.1f}ms "
                    f"({mean / fleet_median:.1f}x) — check its "
                    "round-robin weight and the noisy neighbors "
                    "sharing its batch bucket"
                )
                if refusals.get(t):
                    msg += (
                        f"; it also ate {int(refusals[t])} "
                        "backpressure refusal(s)"
                    )
                causes.append(msg)

    # warm-recompile attributions are causes by construction
    for i, ev in events:
        if ev.get("type") == "DeviceRecompile":
            a = ev.get("attrs", {})
            causes.append(
                f"warm new launch signature of device fn "
                f"'{a.get('fn', '?')}' at tick {i} ({a.get('compile_s')}s "
                "of compile time on the hot path)"
            )

    # anomaly attributions are causes by construction
    for _, ev in events:
        if ev.get("type") == "AnomalyDetected":
            a = ev.get("attrs", {})
            causes.append(
                f"anomaly in {a.get('series', '?')} phase "
                f"'{a.get('phase', '')}': observed {a.get('observed_s')}s vs "
                f"baseline {a.get('baseline_s')}s ({a.get('magnitude')}x)"
            )

    # any regressing phase not already blamed gets named on its own
    blamed = " ".join(causes)
    for k in regressing:
        if f"'{k}'" not in blamed:
            p = phases[k]
            causes.append(
                f"phase '{k}' regressed: {p['recent_ms']}ms recent vs "
                f"{p['baseline_ms']}ms baseline"
            )

    if bench_verdict and bench_verdict.get("regressed"):
        causes.append(
            "bench --compare flagged regressions: "
            + ", ".join(bench_verdict["regressed"])
        )
    return causes


# ---------------------------------------------------------------- diagnose
def diagnose(
    flight: dict, bench_verdict: Optional[dict] = None
) -> dict:
    ticks = flight["ticks"]
    events = ledger_events(ticks)
    split = _split_index(ticks, events)
    phases = phase_analysis(ticks, split)
    breaches = [ev for _, ev in events if ev.get("type") == "SLOBreach"]
    recoveries = [ev for _, ev in events if ev.get("type") == "SLORecovered"]
    # the timeline brackets the first breach: everything from a few ticks
    # before it through the end of the dump (or the whole tail of a
    # breach-free dump)
    lo = max(0, split - 4)
    timeline = [
        {"tick": i, **ev} for i, ev in events if i >= lo
    ]
    return {
        "meta": flight["meta"],
        "ticks": len(ticks),
        "split_tick": split,
        "breaches": breaches,
        "recoveries": recoveries,
        "phases": phases,
        "regressing_phases": [
            k for k, p in phases.items() if p["regressing"]
        ],
        "device": {
            "compiles": sum(
                int(d.get("compiles", 0) or 0) for d in device_sections(ticks)
            ),
            "warm_recompiles": sum(
                int(d.get("warm_recompiles", 0) or 0)
                for d in device_sections(ticks)
            ),
            "transfer_bytes": sum(
                int(d.get("transfer_bytes", 0) or 0)
                for d in device_sections(ticks)
            ),
            "resident_bytes_final": int(
                (device_sections(ticks)[-1] if ticks else {}).get(
                    "resident_bytes", 0
                )
                or 0
            ),
        },
        "timeline": timeline,
        "suspected_causes": suspected_causes(
            ticks, events, phases, bench_verdict, split=split
        ),
    }


def render_diagnosis(diag: dict) -> str:
    out: List[str] = []
    meta = diag["meta"]
    out.append(
        f"flight dump: {diag['ticks']} tick(s), trigger="
        f"{meta.get('trigger', '?')}, dumped_ts={meta.get('dumped_ts')}"
    )
    out.append(
        f"SLO breaches: {len(diag['breaches'])}, recoveries: "
        f"{len(diag['recoveries'])}"
    )
    dev = diag.get("device") or {}
    if any(dev.values()):
        out.append(
            f"device: {dev.get('compiles', 0)} new launch signature(s) "
            f"({dev.get('warm_recompiles', 0)} warm), "
            f"{dev.get('transfer_bytes', 0)}B uploaded, "
            f"{dev.get('resident_bytes_final', 0)}B resident at dump time"
        )
    out.append("")
    out.append("phases vs rolling baseline (recent = ticks past the "
               f"split at tick {diag['split_tick']}):")
    out.append(
        f"  {'phase':32s} {'baseline_ms':>12s} {'recent_ms':>10s} "
        f"{'ratio':>6s}"
    )
    for pkey, p in diag["phases"].items():
        flag = "  << REGRESSING" if p["regressing"] else ""
        ratio = f"{p['ratio']:.2f}" if p["ratio"] is not None else "-"
        out.append(
            f"  {pkey:32s} {p['baseline_ms']:12.3f} {p['recent_ms']:10.3f} "
            f"{ratio:>6s}{flag}"
        )
    out.append("")
    out.append("event timeline bracketing the breach:")
    if not diag["timeline"]:
        out.append("  (no ledger events in the dump)")
    for ev in diag["timeline"][-40:]:
        attrs = " ".join(
            f"{k}={v}" for k, v in sorted(ev.get("attrs", {}).items())
        )
        out.append(
            f"  tick {ev['tick']:>4d}  seq {ev.get('seq', '?'):>5}  "
            f"{ev.get('type', '?'):18s} {attrs}"
        )
    out.append("")
    out.append("suspected causes:")
    if diag["suspected_causes"]:
        for cause in diag["suspected_causes"]:
            out.append(f"  - {cause}")
    else:
        out.append("  - none: no regressing phase, breach, or correlated "
                   "event in this dump")
    return "\n".join(out)


# --------------------------------------------------------------------- CLI
def _fetch_flight(base_url: str) -> dict:
    import urllib.request

    url = base_url.rstrip("/") + "/debug/flight"
    with urllib.request.urlopen(url, timeout=10) as resp:
        text = resp.read().decode()
    if not text.strip():
        raise ValueError(
            f"{url} returned an empty body (no flight recorder attached?)"
        )
    return read_flight(text)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch doctor",
        description="correlate a flight dump (or a live /debug/flight "
        "endpoint) into a terminal diagnosis: phases vs baseline, the "
        "event timeline around the breach, and suspected causes",
    )
    parser.add_argument(
        "input",
        help="a flight dump JSONL (flight-<trace>.jsonl) or a live "
        "process base URL (http://host:port)",
    )
    parser.add_argument(
        "--bench",
        default="",
        metavar="VERDICT.json",
        help="a `bench.py --compare-out` verdict to fold into the "
        "suspected-causes section",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the diagnosis as JSON instead of the terminal report",
    )
    args = parser.parse_args(argv)

    try:
        if args.input.startswith(("http://", "https://")):
            flight = _fetch_flight(args.input)
        else:
            flight = load_flight(args.input)
        verdict = None
        if args.bench:
            with open(args.bench) as f:
                verdict = json.load(f)
    except (OSError, ValueError) as exc:
        print(f"doctor: {exc}", file=sys.stderr)
        return 64

    diag = diagnose(flight, bench_verdict=verdict)
    if args.json:
        print(json.dumps(diag, indent=2, sort_keys=True))
    else:
        print(render_diagnosis(diag))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
