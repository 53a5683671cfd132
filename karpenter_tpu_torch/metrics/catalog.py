"""Metric metadata: the ONE source of truth for metric type / labels /
semantics, consumed by BOTH the generated reference page
(tools/gen_metrics_doc.py -> docs/metrics.md) and the live /metrics
endpoint's Prometheus exposition (metrics/registry.py `exposition` ->
HELP/TYPE lines).  An entry here renders identically in the doc and on
the wire, so the two can never disagree about what a series means.

Entries: name -> (type, labels, description).  Families without an entry
still expose and document — type inferred from the registry family they
live in, description defaulting to the name — so the catalog grows as
families gain documentation, never as a precondition.
"""

from __future__ import annotations

from typing import Dict, Tuple

METRIC_DETAILS: Dict[str, Tuple[str, str, str]] = {
    "karpenter_cloud_api_retries_total": (
        "counter",
        "api, classification",
        "bumped each time RetryingCloud retries a cloud call classified "
        "throttle or transient; terminal errors (ICE, NotFound) never move it",
    ),
    "karpenter_cloud_api_circuit_state": (
        "gauge",
        "api",
        "0 closed / 1 half-open / 2 open; opens after "
        "cloud_circuit_failure_threshold consecutive classified failures, "
        "half-opens when cloud_circuit_reset_timeout elapses, closes on the "
        "next success",
    ),
    "karpenter_provider_cache_stale_seconds": (
        "gauge",
        "provider",
        "age of the last-good data a degraded provider (pricing / subnet / "
        "securitygroup / image / version) is serving while its refresh API "
        "fails; reset to 0 by the next successful refresh",
    ),
    "karpenter_tpu_controller_healthy": (
        "gauge",
        "controller",
        "1 after a clean reconcile; 0 while the controller is "
        "crash-contained in per-controller requeue backoff after raising",
    ),
    "karpenter_pods_time_to_schedule_seconds": (
        "histogram",
        "(none)",
        "pod first-seen-pending -> nominated onto a node/claim, observed "
        "by the provisioning controller on the injected clock; the "
        "simulator's SLO report (sim/report.py) aggregates its samples "
        "into p50/p95/p99 time-to-schedule",
    ),
    "karpenter_admission_latency_seconds": (
        "histogram",
        "path",
        "pod first-seen-pending -> nominated, split by the admission "
        "path that nominated it: fast (the single-pod resident admit "
        "dispatch) vs batch (the authoritative coalesced solve).  Same "
        "clock and endpoints as karpenter_pods_time_to_schedule_seconds "
        "— that legacy series keeps the unsplit stream",
    ),
    "karpenter_admission_fastpath_total": (
        "counter",
        "outcome",
        "admission fast-path attempts: nominated (pods placed onto live "
        "nodes in one admit dispatch), fallback (ineligible or no fit — "
        "the batched solve runs, reason on the fallback counter), "
        "mismatch (device score refuted by the sequential host oracle)",
    ),
    "karpenter_admission_fastpath_fallback_total": (
        "counter",
        "reason",
        "fast-path declines by reason (docs/designs/admission-fastpath"
        ".md taxonomy): burst_too_large, mixed_burst, pod_shape, "
        "affinity_carrier, catalog_roll, resident_cold, resident_miss, "
        "sharded_backend, needs_new_node, unschedulable, no_pools — "
        "every one lands in the batched solve, never a mis-nomination",
    ),
    "karpenter_admission_fastpath_mismatch_total": (
        "counter",
        "(none)",
        "admit-dispatch verdicts refuted by the sequential host oracle "
        "(bit-equality over the take vector, placed count, and "
        "open-capacity bit).  The convergence contract requires this to "
        "stay 0 — the sim/load invariant planes fail the run otherwise; "
        "a mismatch never nominates (the batched solve decides)",
    ),
    "karpenter_sim_events_injected_total": (
        "counter",
        "kind",
        "scenario events the simulator applied (pod_create, pod_delete, "
        "instance_kill, spot_interruption, chaos, az_down/az_up, "
        "image_roll, image_deprecate, price_shock, pool_update)",
    ),
    "karpenter_sim_phase_seconds": (
        "histogram",
        "phase",
        "host wall time of one sim-tick phase (generate = workload/tape "
        "event materialization, apply = event application, reconcile = "
        "kubelet + operator, invariants = the per-tick invariant suite); "
        "feeds the --profile sim_phases section and the bench's "
        "harness-overhead fraction ((generate+invariants)/total must stay "
        "under 20% on the million-events anchor) — wall clock, so never "
        "part of the byte-compared trace/report surface",
    ),
    "karpenter_sim_time_to_settle_seconds": (
        "gauge",
        "(none)",
        "last simulated moment the cluster had pending pods, relative to "
        "run start — the scale anchors' acceptance signal; exceeding the "
        "scenario's settle_budget_s raises a settle-budget invariant "
        "violation",
    ),
    "karpenter_load_vector_checked_ticks_total": (
        "counter",
        "(none)",
        "ticks whose invariant suite ran on the vectorized plane "
        "(load/invariants.py VectorInvariantChecker) instead of the "
        "scalar one — cross-validation tests prove both planes emit "
        "byte-identical violations",
    ),
    "karpenter_sim_ticks_total": (
        "counter",
        "phase",
        "simulated ticks executed per phase (run / drain / settle)",
    ),
    "karpenter_sim_pending_pods": (
        "gauge",
        "(none)",
        "pending-pod depth at the end of the last simulated tick; the "
        "report's pending.peak is the max this gauge reached",
    ),
    "karpenter_sim_invariant_violations_total": (
        "counter",
        "invariant",
        "invariant checks that failed (no-double-launch, "
        "registered-eq-launched, budgets, no-leaked-instances, "
        "schedule-deadline, all-pods-scheduled, no-wedged-controller); "
        "any movement fails the run",
    ),
    "karpenter_solver_phase_seconds": (
        "histogram",
        "phase",
        "per-solve wall time of one solver phase (partition / compile / "
        "pad / dispatch / device_block / oracle / decode / delta / other; "
        "delta is the resident-tensor plan+scatter that replaces "
        "compile+pad on warm ticks) — "
        "disjoint self-times that sum to the solve's wall clock, observed "
        "by the provisioning controller after every scheduling solve; see "
        "the 'solve latency anatomy' section in the README for how to "
        "read them",
    ),
    "karpenter_solver_compile_cache_hits_total": (
        "counter",
        "consumer",
        "solves served from the TensorScheduler's incremental compile "
        "cache, per consuming controller (provisioner, disruption); "
        "exported as the delta of the scheduler's lifetime counter each "
        "reconcile",
    ),
    "karpenter_solver_compile_cache_misses_total": (
        "counter",
        "consumer",
        "solves that had to run the full host-side compile; a warm "
        "steady-state cluster should see hits dominate — misses every "
        "tick mean something (pods, pools, live nodes) is being mutated "
        "in place",
    ),
    "karpenter_solver_resident_hits_total": (
        "counter",
        "consumer",
        "solves (and consolidation base builds) served from the "
        "device-resident cluster tensors (ops/resident.py) — the compiled "
        "problem stayed on device and this tick's cluster diff applied as "
        "donated scatter deltas (or no delta at all), skipping both the "
        "host re-tensorize and the host->device upload",
    ),
    "karpenter_solver_resident_rebuilds_total": (
        "counter",
        "consumer",
        "full tensorize+upload passes while the resident layer was "
        "eligible to serve: the delta planner could not prove equivalence "
        "(catalog roll, pool/daemonset mutation, constraint carriers, "
        "extended-resource axis change, padded-bucket overflow, >50% "
        "churn) or the state was cold; a warm steady cluster should see "
        "hits dominate",
    ),
    "karpenter_solver_resident_delta_rows": (
        "histogram",
        "(none)",
        "scattered tensor rows+columns of one resident warm tick (class "
        "rows + live-node columns + usage rows; 0 = a pure no-change "
        "hit), observed by the provisioner per resident solve — the delta "
        "sizes the sim report's solver.resident section summarizes",
    ),
    "karpenter_consolidation_eval_batch_size": (
        "histogram",
        "",
        "candidate-subset elements per batched what-if dispatch "
        "(TensorScheduler.evaluate_removals): the single-node scan is one "
        "batch, each drop-one descent level is one batch",
    ),
    "karpenter_consolidation_phase_seconds": (
        "histogram",
        "phase",
        "per-dispatch wall time of one batched-evaluation phase "
        "(partition / compile / pad / dispatch / device_block / decode / "
        "other) — kept separate from karpenter_solver_phase_seconds so "
        "verdict batches don't skew the provisioner's per-solve "
        "percentiles",
    ),
    "karpenter_consolidation_evals_total": (
        "counter",
        "path",
        "consolidation what-if simulations by evaluation path: 'batched' "
        "elements were answered on-device from one shared compile, "
        "'sequential' elements ran the per-subset solver round-trip "
        "(fallback conditions: docs/designs/consolidation-batching.md)",
    ),
    "karpenter_consolidation_search_rounds": (
        "histogram",
        "",
        "propose→score→select rounds executed by one multi-node "
        "consolidation pass's population search "
        "(controllers/disruption.py + scheduling/popsearch.py); fewer "
        "than consolidation_search_rounds means the universe ran out of "
        "fresh subsets early",
    ),
    "karpenter_consolidation_population_size": (
        "histogram",
        "",
        "distinct candidate subsets (removal masks) a pass's population "
        "search scored across all of its rounds — structured seeds plus "
        "random diversity plus annealed mutations, each round one "
        "vmapped device dispatch",
    ),
    "karpenter_consolidation_search_phase_seconds": (
        "histogram",
        "phase",
        "per-round wall time of one population-search phase (propose / "
        "pad / dispatch / device_block / decode / select / other) — the "
        "search analogue of karpenter_consolidation_phase_seconds, kept "
        "separate so population rounds don't skew the per-subset batch "
        "distribution",
    ),
    "karpenter_consolidation_search_winners_total": (
        "counter",
        "action",
        "how population-search passes concluded: a multi-node 'delete' "
        "or 'replace' action was taken, or 'none' (no acceptable subset, "
        "or the sequential re-derivation declined the winner)",
    ),
    "karpenter_consolidation_verdict_mismatch_total": (
        "counter",
        "",
        "batched verdicts contradicted by the winner's sequential decode "
        "— must stay 0 (the parity suite enforces it); any movement is a "
        "bug in the batched path",
    ),
    # ---- observability plane (docs/designs/observability.md)
    "karpenter_events_total": (
        "counter",
        "type",
        "cluster event ledger entries by type (PodNominated, NodeLaunched, "
        "NodeDisrupted, RetryBackoff, CircuitOpen, StaleServed, "
        "VerdictFallback, CatalogRolled, SLOBreach, SLORecovered, "
        "AnomalyDetected) — emitted at the controllers' decision sites, "
        "deterministic under the simulator's FakeClock; the ring itself is "
        "readable at /events and in the sim trace's `led` lines",
    ),
    "karpenter_telemetry_scrapes_total": (
        "counter",
        "endpoint",
        "HTTP requests served by the telemetry server "
        "(metrics / healthz / events / trace / debug/flight), per endpoint "
        "— the scrape heartbeat a dead-man's-switch alert can sit on",
    ),
    "karpenter_store_requests_total": (
        "counter",
        "method",
        "store-server RPCs dispatched, per method (put / delete / "
        "bind_pod / evict_pod / lease_* / watch / hello / ...); served "
        "from the store process's own registry on ITS telemetry endpoint",
    ),
    # ---- fleet-scale store plane (docs/designs/store-scale.md)
    "karpenter_store_request_seconds": (
        "histogram",
        "method",
        "server-side wall time of one store RPC dispatch (fence + verb "
        "+ broadcast), per method — the store process's latency anatomy, "
        "on ITS telemetry endpoint",
    ),
    "karpenter_store_rpc_seconds": (
        "histogram",
        "method",
        "client-side wall time of one store RPC including retries "
        "(state/remote.py), per method — the operator's view of store "
        "latency; watched by the anomaly detector and baselined by "
        "doctor like a solver phase",
    ),
    "karpenter_store_watch_clients": (
        "gauge",
        "(none)",
        "watch subscribers currently registered on this store server "
        "(operator replicas, read replicas, passive mirrors)",
    ),
    "karpenter_store_watch_queue_depth": (
        "gauge",
        "(none)",
        "deepest per-subscriber broadcast queue after the last commit; "
        "queues are BOUNDED (store_watch_queue_batches) — a subscriber "
        "that hits the bound is coalesced onto a forced resync instead "
        "of growing server memory",
    ),
    "karpenter_store_bytes_sent_total": (
        "counter",
        "codec",
        "bytes written to store-plane sockets (frames + length prefix), "
        "per negotiated payload codec — on the server AND on each "
        "client's own registry; the bin1/json split is the negotiated "
        "binary codec's adoption in one glance",
    ),
    "karpenter_store_bytes_received_total": (
        "counter",
        "codec",
        "bytes read off store-plane sockets (frames + length prefix), "
        "per negotiated payload codec, both halves of the plane",
    ),
    "karpenter_store_resync_total": (
        "counter",
        "kind",
        "watch resyncs: 'replay' (a reconnect gap served from the "
        "replay log — events only, no snapshot), 'snapshot' (the log "
        "was compacted past the client's seq; full state), 'overflow' "
        "(a slow subscriber's bounded queue filled and was coalesced "
        "onto a forced resync), 'epoch' (the store's own continuity "
        "broke under its watchers — a read replica full-resynced from "
        "its primary); servers count what they served, clients count "
        "what they underwent",
    ),
    "karpenter_store_compactions_total": (
        "counter",
        "log",
        "bounded-log trims on the store server: 'replay' (the delta "
        "resync log dropped its oldest batch — clients older than "
        "compacted_seq now snapshot), 'events' (the durable "
        "cluster-event ledger dropped its oldest entries)",
    ),
    # ---- durable log + sharding (docs/designs/store-scale.md)
    "karpenter_store_log_records_total": (
        "counter",
        "(none)",
        "records appended to the durable replay log (batch and "
        "checkpoint alike), each length-prefixed, encoded, and fsynced "
        "per the log's fsync policy before the commit acks",
    ),
    "karpenter_store_log_bytes_total": (
        "counter",
        "(none)",
        "bytes appended to the durable replay log segment, length "
        "prefixes included",
    ),
    "karpenter_store_log_checkpoints_total": (
        "counter",
        "(none)",
        "full-snapshot checkpoints written to a fresh segment "
        "(tmp + fsync + atomic rename); recovery reads the LAST "
        "checkpoint plus its contiguous batch tail",
    ),
    "karpenter_store_log_torn_records_total": (
        "counter",
        "(none)",
        "records discarded at recovery because the segment tail was "
        "torn mid-write (truncated length prefix, short payload, or "
        "undecodable bytes); everything before the tear is kept — a "
        "torn tail is a crash artifact, never an error",
    ),
    "karpenter_store_log_failures_total": (
        "counter",
        "(none)",
        "append/fsync failures after which the log failed CLOSED "
        "(inert for the rest of the process) while the in-memory "
        "store kept serving; a restart from a failed log loses the "
        "un-fsynced suffix, so alert on any nonzero delta",
    ),
    "karpenter_store_epoch_rotations_total": (
        "counter",
        "reason",
        "store epoch rotations ('recovery_tail_lost' — the durable "
        "log could not prove continuity at restart; 'shard_import' / "
        "'shard_drop' — a key migration changed this shard's key set); "
        "every rotation forces connected watchers onto a full snapshot "
        "resync, which is exactly the safety the rotation buys",
    ),
    "karpenter_store_shard_migration_begun_total": (
        "counter",
        "shard",
        "reshard export fences raised on a source shard by the "
        "coordinator (service/shardrouter.py); pairs with "
        "..._committed_total — a begun without a commit is a shard "
        "stuck in migration (the doctor names it)",
    ),
    "karpenter_store_shard_migration_committed_total": (
        "counter",
        "shard",
        "reshard migrations committed on a source shard: every "
        "exported key was imported at its new owner (import-before-"
        "drop) and the source's drop landed",
    ),
    "karpenter_sim_wire_faults_total": (
        "counter",
        "fault",
        "scripted wire faults injected by the shard-chaos scenario "
        "(sim/faults.py: drop, zero_frame, truncated_frame, "
        "garbled_payload, delay); each must cost the client one retry "
        "and zero wrong answers",
    ),
    # ---- diagnosis layer (docs/designs/observability.md)
    "karpenter_reconcile_tick_duration_seconds": (
        "histogram",
        "(none)",
        "wall-clock duration of one full reconcile_once tick (every "
        "controller plus the diagnosis tail's own evaluation); the SLO "
        "engine's tick_duration_p99 signal reads its bucket-honest p99",
    ),
    "karpenter_pods_pending_age_seconds": (
        "gauge",
        "(none)",
        "age of the oldest pending pod not yet nominated onto a "
        "node/claim, on the injected clock, refreshed by the provisioner "
        "each reconcile (0 when nothing is waiting); the SLO engine's "
        "pending_pod_age_max signal — the reference's pending-pod-age "
        "alerting contract",
    ),
    "karpenter_slo_status": (
        "gauge",
        "rule",
        "1 while the rule is breached (fast AND slow burn windows over "
        "budget), 0 once the fast window recovers; transitions also emit "
        "SLOBreach/SLORecovered ledger events",
    ),
    "karpenter_slo_burn_rate": (
        "gauge",
        "rule, window",
        "time-weighted violating fraction over the rule's fast/slow "
        "window divided by its budget; >= 1 on both windows pages "
        "(zero-budget rules saturate at 1000 on any violation)",
    ),
    "karpenter_slo_breaches_total": (
        "counter",
        "rule",
        "SLOBreach transitions per rule over the process lifetime; the "
        "sim report's `slo` section carries the per-scenario counts",
    ),
    "karpenter_anomaly_detected_total": (
        "counter",
        "series, phase",
        "phase-latency samples that blew past their rolling "
        "median/MAD baseline (obs/detect.py); each detection also emits "
        "an AnomalyDetected ledger event carrying baseline vs observed "
        "and the magnitude",
    ),
    "karpenter_flight_dumps_total": (
        "counter",
        "trigger",
        "flight-recorder dumps written, per trigger (slo_breach / "
        "controller_crash / sigusr1 / http / manual); the dump itself is "
        "a JSONL ring of the last flight_ticks ticks' full context",
    ),
    # ---- pipelined reconcile (pipeline.py, docs/designs/
    # pipelined-reconcile.md)
    "karpenter_reconcile_overlap_seconds": (
        "histogram",
        "(none)",
        "per-tick host wall time that ran WHILE a speculatively "
        "dispatched consolidation search computed on device (dispatch at "
        "the previous tick's tail, advance under this tick's "
        "provisioning solve, join at the disruption slot); observed only "
        "when the speculation was adopted — the overlap the pipelined "
        "schedule actually realized, the difference between "
        "sum-of-phases and max-of-phases tick latency",
    ),
    "karpenter_pipeline_speculation_total": (
        "counter",
        "controller, outcome",
        "boundary-dispatched speculations by fate: 'adopted' (the "
        "authoritative pass's fingerprint matched — verdicts reused, "
        "overlap banked), 'stale' (cluster state moved between dispatch "
        "and join — every speculative verdict discarded, the pass "
        "recomputed synchronously), 'unused' (an earlier mechanism "
        "acted, consolidation never ran), 'refused' (the pass "
        "fingerprint declined to cover exotic inputs — no speculation "
        "possible; every tick refusing is a fingerprint bug, not a "
        "quiet cluster); adoption rate is the pipeline's hit rate on "
        "quiet ticks",
    ),
    "karpenter_pipeline_stage_errors_total": (
        "counter",
        "controller, stage",
        "speculative dispatch/advance stages that raised; crash-"
        "contained at the pipeline seam — the tick proceeds and the "
        "mutate stage recomputes synchronously, so a speculation bug "
        "can cost latency but never actions",
    ),
    "karpenter_launch_inflight": (
        "gauge",
        "(none)",
        "NodeClaim creates currently in flight in the provisioner's "
        "launch fan-out (bounded by launch_max_concurrency; the "
        "CreateFleet batcher coalesces them underneath); nonzero between "
        "flush start and the last outcome — a stuck CreateFleet is "
        "visible here while it is stuck",
    ),
    # ---- device observatory (obs/device.py, docs/designs/observability.md)
    "karpenter_device_compiles_total": (
        "counter",
        "fn",
        "XLA compilations per jit entry point (pack_kernel / "
        "pack_kernel_buffered / removal_verdict_kernel / "
        "population_verdict_kernel / resident_delta / mesh_pack / "
        "pallas_pack), detected as jit-cache growth at the counted "
        "dispatch seam; a warm steady cluster should see this flat — "
        "movement after the first ticks is a recompile storm in the "
        "making",
    ),
    "karpenter_device_compile_seconds": (
        "histogram",
        "fn",
        "wall time of one XLA compilation (the jit call's duration when "
        "the cache grew — trace+compile dominates; execution stays "
        "async); watched by the anomaly detector and baselined by "
        "doctor like a solver phase",
    ),
    "karpenter_device_warm_recompiles_total": (
        "counter",
        "fn",
        "compilations of a jit entry point that already had dispatches "
        "in an EARLIER reconcile tick — a fresh padded bucket, an axis "
        "change, a donation falling through; each also emits a "
        "DeviceRecompile ledger event (outside the simulator) and is "
        "the doctor's recompile-storm signal",
    ),
    "karpenter_device_dispatches_total": (
        "counter",
        "fn",
        "device dispatches per jit entry point through the counted seam "
        "(obs/device.py) — the denominator that turns transfer bytes "
        "and compile counts into per-dispatch attributions",
    ),
    "karpenter_device_transfer_bytes_total": (
        "counter",
        "site",
        "host->device bytes crossing the counted seam, per site: jit "
        "argument uploads attribute to their entry point (a numpy "
        "argument IS a transfer; device-resident args count zero), "
        "explicit uploads to their put site (pack_constants / "
        "mesh_constants / pallas_constants / resident_seed / "
        "removal_base / population_tensors); lint rule 9 fences raw "
        "device_put call sites so this family stays complete",
    ),
    "karpenter_device_resident_bytes": (
        "gauge",
        "consumer",
        "live device-buffer footprint of the resident cluster tensors "
        "(ops/resident.py), per consumer ('solve' = the pending-batch "
        "state, 'removal' = the consolidation base universe); reported "
        "after every seed/evict so it is the CURRENT truth, not a "
        "high-water mark — a monotonically growing value is a leak",
    ),
    "karpenter_device_resident_updates_total": (
        "counter",
        "kind",
        "resident-tensor updates by kind: 'donated' (warm scatter delta "
        "reusing donated buffers — allocates nothing), 'seed' (fresh "
        "full-tensor upload), 'noop' (refresh hit with no tensor "
        "change); warm steady state should be donated/noop-dominated",
    ),
    # ---- multi-tenant solver service (docs/designs/solver-service.md);
    # every family carries `tenant` (lint rule 12) and is served from the
    # solver process's OWN registry on ITS telemetry endpoint
    "karpenter_service_requests_total": (
        "counter",
        "tenant, method",
        "solver-service RPCs dispatched (ping / info / pack), per tenant "
        "— the fleet's per-cluster demand in one family",
    ),
    "karpenter_service_solves_total": (
        "counter",
        "tenant, path",
        "completed pack solves per tenant, split by execution path: "
        "'solo' (idle-group fall-through straight into the single-problem "
        "kernel) vs 'batched' (rode a coalesced fleet dispatch); a "
        "healthy busy mesh is batched-dominated, a quiet one solo-only",
    ),
    "karpenter_service_solve_wait_seconds": (
        "histogram",
        "tenant",
        "arrival-to-answer latency of one pack RPC including queue wait, "
        "per tenant — the fairness ground truth: doctor's tenant-"
        "starvation rule flags a tenant whose p99 runs far above the "
        "fleet median from this family's flight deltas",
    ),
    "karpenter_service_refusals_total": (
        "counter",
        "tenant, reason",
        "solves refused under backpressure with an explicit retry-after "
        "hint ('inflight-cap' = that tenant over its concurrent-solve "
        "cap, 'saturated' = the whole mesh's queue bound hit) — refusals "
        "are the DESIGNED overload behavior, never silent queuing",
    ),
    "karpenter_service_inflight": (
        "gauge",
        "tenant",
        "solves currently admitted (queued or on-device) per tenant; "
        "pinned at the inflight cap means that tenant is being shed",
    ),
    "karpenter_service_resident_bytes": (
        "gauge",
        "tenant",
        "device bytes pinned by this tenant's warm solve tensors in the "
        "budgeted cross-tenant resident pool (ops/resident.py); the sum "
        "across tenants stays under service_resident_budget_mb",
    ),
    "karpenter_service_resident_evictions_total": (
        "counter",
        "tenant",
        "times this tenant's WHOLE resident set was dropped as the "
        "coldest entry to fit another tenant under the device-bytes "
        "budget; a hot tenant evicting repeatedly means the budget is "
        "too small for the working set",
    ),
}
