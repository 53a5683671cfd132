"""SLO report for a simulation run.

`build_report` produces the DETERMINISTIC summary: everything in it is a
function of (scenario, seed, ticks) on the simulated clock, so a replayed
trace reproduces it byte-for-byte.  Wall-clock measurements — the solver
phase breakdown from `last_phases`, scheduling wall durations — are host
performance, not simulation outcome, and live in the separate
`wall_profile` section the CLI only attaches under `--profile`.
"""

from __future__ import annotations

from typing import Dict, List


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    rank = max(0, min(len(ordered) - 1, int(round(q * (len(ordered) - 1)))))
    return ordered[rank]


def _counter_family(registry, name: str) -> Dict[str, float]:
    """Sum a counter family per first-label value (e.g. per nodepool)."""
    out: Dict[str, float] = {}
    for labels, v in registry.counters.get(name, {}).items():
        key = labels[0][1] if labels else ""
        out[key] = out.get(key, 0.0) + v
    return out


def _consolidation_section(registry) -> dict:
    """Batched-vs-sequential consolidation evaluation counts plus the
    batch-size distribution — how much of the what-if work ran as single
    device dispatches instead of per-subset solver round-trips."""
    evals = {
        (labels[0][1] if labels else ""): int(v)
        for labels, v in registry.counters.get(
            "karpenter_consolidation_evals_total", {}
        ).items()
    }
    sizes = registry.histogram("karpenter_consolidation_eval_batch_size")
    hist = registry.histograms.get(
        "karpenter_consolidation_eval_batch_size", {}
    ).get(())
    return {
        "evals": dict(sorted(evals.items())),
        "batches": hist.count if hist is not None else 0,
        "batch_size_p50": percentile(sizes, 0.5),
        "search": _search_section(registry),
    }


def _search_section(registry) -> dict:
    """Population-search accounting (controllers/disruption.py +
    scheduling/popsearch.py): passes run, rounds and population-size
    distributions, and how each pass concluded (winners by action type).
    Deterministic — rounds, population, and winners are functions of the
    seeded mask schedule and the verdicts, never of wall time — so a
    replay reproduces the section byte-for-byte."""
    rounds_hist = registry.histograms.get(
        "karpenter_consolidation_search_rounds", {}
    ).get(())
    pop_hist = registry.histograms.get(
        "karpenter_consolidation_population_size", {}
    ).get(())
    winners = {
        (labels[0][1] if labels else ""): int(v)
        for labels, v in registry.counters.get(
            "karpenter_consolidation_search_winners_total", {}
        ).items()
    }
    return {
        "passes": rounds_hist.count if rounds_hist is not None else 0,
        # quantile, not percentile(histogram(...)): exact below the
        # sample window, bucket-estimated past it (same contract as the
        # resident section's delta_rows)
        "rounds_p50": registry.quantile(
            "karpenter_consolidation_search_rounds", 0.5
        ),
        "rounds_max": rounds_hist.vmax if rounds_hist is not None else 0.0,
        "population_p50": registry.quantile(
            "karpenter_consolidation_population_size", 0.5
        ),
        "population_max": pop_hist.vmax if pop_hist is not None else 0.0,
        "winners": dict(sorted(winners.items())),
    }


def _resident_section(registry) -> dict:
    """Resident-tensor warm-path accounting: hit/rebuild counts (summed
    over the provisioner and disruption consumers) and the scatter-delta
    row distribution of the warm ticks."""
    hist = registry.histograms.get(
        "karpenter_solver_resident_delta_rows", {}
    ).get(())
    return {
        "hits": int(
            sum(
                _counter_family(
                    registry, "karpenter_solver_resident_hits_total"
                ).values()
            )
        ),
        "rebuilds": int(
            sum(
                _counter_family(
                    registry, "karpenter_solver_resident_rebuilds_total"
                ).values()
            )
        ),
        "delta_rows": {
            "ticks": hist.count if hist is not None else 0,
            # quantile, not percentile(histogram(...)): the latter
            # degrades to the last-window tail past 1024 solves
            "p50": registry.quantile(
                "karpenter_solver_resident_delta_rows", 0.5
            ),
            "max": hist.vmax if hist is not None else 0.0,
        },
    }


def _device_section(runner) -> dict:
    """Device-observatory accounting for THIS run (obs/device.py scope):
    would-compile counts (distinct launch signatures, which the port
    counts where the JAX package counts jit compiles), dispatches,
    transfer bytes per site, and the resident footprint/update counts.
    Counts and bytes only — never wall-clock seconds — so the section is
    byte-identical across record/replay, the same discipline that keeps
    anomaly detection out of the sim.  The resident footprint reads the
    run's OWN schedulers (the process-wide observatory view merges every
    live cache, including a previous run's not-yet-collected one)."""
    op = runner.env.operator
    resident: Dict[str, int] = {}
    for sched in (op.provisioner.scheduler, op.disruption._scheduler):
        for consumer, v in sched._resident.footprint().items():
            resident[consumer] = resident.get(consumer, 0) + v
    return runner.device_scope.device_section(resident=resident)


def _fleet_section(runner) -> dict:
    """Fleet-level SLOs for the load harness — deterministic (simulated
    clock only; see build_report's inline note)."""
    env = runner.env
    sim_seconds = env.clock.now() - runner.t0
    pod_hours = runner.pod_seconds / 3600.0
    cost_total = sum(runner.cost_by_ct.values())
    disruptions = sum(runner.disruptions_by_reason.values())
    return {
        "tts": runner.tts_sketch.section(),
        "pod_hours": round(pod_hours, 6),
        "cost_per_pod_hour": round(
            cost_total / pod_hours if pod_hours > 0 else 0.0, 6
        ),
        "disruptions_per_hour": round(
            disruptions / (sim_seconds / 3600.0) if sim_seconds > 0 else 0.0,
            6,
        ),
        "time_to_settle_s": runner.time_to_settle_s,
        "settle_budget_s": runner.scenario.settle_budget_s,
    }


def build_report(runner) -> dict:
    env = runner.env
    registry = env.registry
    tts = registry.histogram("karpenter_pods_time_to_schedule_seconds")
    tts_count = 0
    tts_max = 0.0
    hist = registry.histograms.get(
        "karpenter_pods_time_to_schedule_seconds", {}
    ).get(())
    if hist is not None:
        tts_count = hist.count
        tts_max = hist.vmax
    launched = sum(
        _counter_family(registry, "karpenter_nodeclaims_launched").values()
    )
    terminated = sum(
        _counter_family(registry, "karpenter_nodes_terminated").values()
    )
    paths = {
        (labels[0][1] if labels else ""): int(v)
        for labels, v in registry.counters.get(
            "karpenter_provisioner_scheduling_simulation_count", {}
        ).items()
    }
    running_final = sum(
        1 for i in env.cloud.instances.values() if i.state == "running"
    )
    return {
        "scenario": runner.scenario.name,
        "seed": runner.seed,
        "ticks": runner.ticks,
        "sim_seconds": round(env.clock.now() - runner.t0, 6),
        "pods": {
            "created": runner.pods_created,
            "deleted": runner.pods_deleted,
            "final": len(env.kube.pods),
        },
        "time_to_schedule_s": {
            # window-exact while the run fits the sample window,
            # bucket-estimated past it (Registry.quantile) — a long run
            # no longer silently reports the tail's percentiles;
            # "window" < "scheduled" marks where the estimate takes over
            "p50": round(
                registry.quantile(
                    "karpenter_pods_time_to_schedule_seconds", 0.50
                ), 6,
            ),
            "p95": round(
                registry.quantile(
                    "karpenter_pods_time_to_schedule_seconds", 0.95
                ), 6,
            ),
            "p99": round(
                registry.quantile(
                    "karpenter_pods_time_to_schedule_seconds", 0.99
                ), 6,
            ),
            "max": round(tts_max, 6),
            "scheduled": tts_count,
            "window": len(tts),
        },
        "pending": {
            "peak": runner.peak_pending,
            "final": len(env.kube.pending_pods()),
        },
        "nodes": {
            "launched": int(launched),
            "terminated": int(terminated),
            "churn": int(launched + terminated),
            "final": len(env.kube.nodes),
            "instances_running_final": running_final,
        },
        "cost_usd": {
            "total": round(sum(runner.cost_by_ct.values()), 6),
            "by_capacity_type": {
                ct: round(v, 6) for ct, v in sorted(runner.cost_by_ct.items())
            },
        },
        "solver": {
            "paths": dict(sorted(paths.items())),
            # device-resident tensor layer (ops/resident.py): warm-tick
            # hits vs full-tensorize rebuilds, plus the scatter-delta
            # size distribution — deterministic for equal seeds, so a
            # replay reproduces the section byte-for-byte
            "resident": _resident_section(registry),
            # deterministic in a sim run: the id/epoch fingerprints hit
            # and miss on the same reconciles for equal seeds
            "compile_cache": {
                "hits": int(
                    sum(
                        _counter_family(
                            registry,
                            "karpenter_solver_compile_cache_hits_total",
                        ).values()
                    )
                ),
                "misses": int(
                    sum(
                        _counter_family(
                            registry,
                            "karpenter_solver_compile_cache_misses_total",
                        ).values()
                    )
                ),
            },
        },
        "consolidation": _consolidation_section(registry),
        # the on-device half of the tick (obs/device.py): what would
        # compile, what crossed the link, what stays resident
        "device": _device_section(runner),
        "events": dict(sorted(runner.event_counts.items())),
        # the operator's OWN decision timeline (obs/events.py), distinct
        # from `events` above (what the scenario injected): what the
        # controllers did about it, and why nodes went away
        "cluster_events": {
            "counts": dict(sorted(runner.cluster_event_counts.items())),
            "disruptions_by_reason": dict(
                sorted(runner.disruptions_by_reason.items())
            ),
        },
        "invariants": {
            "checked_ticks": runner.checker.checked_ticks,
            "violations": [str(v) for v in runner.checker.violations],
        },
        # fleet-level section (load harness): streaming-sketch tts
        # percentiles over EVERY observation (the histogram window
        # saturates at 1024 samples — useless at a million events),
        # cost per scheduled pod-hour, disruption rate, settle time.
        # Everything here is a function of the simulated clock, so it
        # is part of the byte-compared run/run and run/replay surface;
        # the HARNESS-OVERHEAD fraction is wall clock and lives in
        # `wall_profile` instead.
        "fleet": _fleet_section(runner),
        # scenario-declared SLO rules (obs/slo.py), evaluated by the real
        # engine each tick: breach/recovery counts, final status, and
        # total simulated time spent breached — deterministic, so replays
        # reproduce it byte-for-byte
        "slo": env.operator.slo.report(),
    }


def wall_profile(registry) -> dict:
    """Host-side (NON-deterministic) performance: solver phase breakdown
    from `last_phases` as observed by karpenter_solver_phase_seconds, plus
    the end-to-end scheduling-duration histogram."""
    phases = {}
    for labels, h in registry.histograms.get(
        "karpenter_solver_phase_seconds", {}
    ).items():
        phase = labels[0][1] if labels else ""
        phases[phase] = {
            "count": h.count,
            "total_s": round(h.total, 6),
            "p50_s": round(percentile(list(h.samples), 0.5), 6),
        }
    sched = registry.histogram(
        "karpenter_provisioner_scheduling_duration_seconds"
    )
    out = {
        "wall_clock": True,
        "solver_phases": dict(sorted(phases.items())),
        "scheduling_duration_s": {
            "p50": round(percentile(sched, 0.5), 6),
            "p95": round(percentile(sched, 0.95), 6),
            "solves": len(sched),
        },
    }
    # sim harness phase split (generate / apply / reconcile /
    # invariants, observed per tick by the scenario runner): before
    # this, --profile attributed the whole tick to reconcile.  The
    # harness fraction is generation + invariant checking as a share of
    # the measured tick — the load-harness overhead claim, measurable
    # straight from the CLI.
    sim_phases = {}
    for labels, h in registry.histograms.get(
        "karpenter_sim_phase_seconds", {}
    ).items():
        phase = labels[0][1] if labels else ""
        sim_phases[phase] = {
            "count": h.count,
            "total_s": round(h.total, 6),
            "p50_s": round(percentile(list(h.samples), 0.5), 6),
        }
    if sim_phases:
        total = sum(p["total_s"] for p in sim_phases.values())
        harness = sum(
            sim_phases.get(p, {"total_s": 0.0})["total_s"]
            for p in ("generate", "invariants")
        )
        out["sim_phases"] = dict(sorted(sim_phases.items()))
        out["harness_fraction"] = round(
            harness / total if total > 0 else 0.0, 4
        )
    return out
