"""Global settings (reference pkg/apis/settings/settings.go:32-61 plus the
batching windows from website v0.31 concepts/settings.md:43-47,94-102)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Settings:
    cluster_name: str = "default"
    cluster_endpoint: str = ""
    isolated_vpc: bool = False
    vm_memory_overhead_percent: float = 0.075  # settings.go:48-61 default
    interruption_queue_name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    reserved_enis: int = 0
    enable_pod_eni: bool = False
    enable_eni_limited_pod_density: bool = True
    feature_gate_drift: bool = True
    # provisioning pod batching window (settings.md:43-47): a batch opens
    # when the first pending pod appears and closes after
    # provision_batch_idle_s of quiet or provision_batch_max_s total —
    # the same idle/max discipline batcher/core.py applies to CreateFleet
    # coalescing (the shared CoalesceWindow arithmetic), on the injected
    # clock instead of wall time
    provision_batch_idle_s: float = 1.0
    provision_batch_max_s: float = 10.0
    # single-pod admission fast path (docs/designs/admission-fastpath.md):
    # a fresh tiny-burst arrival with nothing else pending is scattered
    # into the resident tensors and scored in one admit dispatch, then
    # nominated immediately — the periodic batched solve stays
    # authoritative and must converge identically (the mismatch counter
    # pins it); off restores the pure batch-window behavior
    enable_admission_fastpath: bool = True
    # singleton batch-window bypass: a LONE pending pod has nothing to
    # coalesce with, so when the fast path declines (or is off) it is
    # released to the batched solve immediately instead of waiting out
    # provision_batch_idle_s
    provision_fastpath_bypass: bool = True
    # pipelined reconcile (pipeline.py + docs/designs/pipelined-reconcile
    # .md): the disruption controller speculatively DISPATCHES its
    # consolidation search's device rounds at tick boundaries so the
    # device scores removal masks while the host runs the other
    # controllers; a fingerprint guard makes actions bit-identical to the
    # sequential order (the simulator forces this off — its traces are
    # byte-compared against the sequential schedule)
    enable_pipelined_reconcile: bool = True
    # cap on concurrent NodeClaim launches per provisioning flush (the
    # CreateFleet batcher coalesces them underneath); the sim pins the
    # provisioner's launch_concurrency override to 1 instead — thread
    # scheduling must never order a byte-compared cloud-call stream
    launch_max_concurrency: int = 64
    # span tracing / profiling, off by default (the ENABLE_PROFILING flag,
    # settings.md:18); profile_dir additionally enables the XLA timeline
    # for solver dispatches (TensorBoard-readable)
    enable_profiling: bool = False
    profile_dir: str = ""
    # cloud-API resilience (cloud/retry.py): classified retries with
    # exponential backoff + full jitter under a per-tick budget, and a
    # per-API circuit breaker — the AWS-SDK retry / circuit behavior the
    # reference gets for free under its providers
    cloud_max_retries: int = 3
    cloud_retry_budget_per_tick: int = 50
    cloud_backoff_base: float = 0.1
    cloud_backoff_max: float = 5.0
    cloud_circuit_failure_threshold: int = 5
    cloud_circuit_reset_timeout: float = 30.0
    # crash-contained reconcile loop (operator.py): a failing controller is
    # requeued with exponential backoff while the rest of the tick proceeds
    controller_backoff_base: float = 1.0
    controller_backoff_max: float = 300.0
    # multi-node consolidation's population search (controllers/
    # disruption.py + scheduling/popsearch.py): rounds of
    # propose→score→select per pass, and the population of removal masks
    # scored per round — one vmapped device dispatch each.  These REPLACE
    # the deprecated MULTI_NODE_SIM_BUDGET knob (it counted batch
    # elements, which a population round either trivially exhausts or
    # ignores); the old constant now caps only the legacy drop-one
    # descent (use_population_search=False), and the mapping is
    # budget ≈ search_rounds × population_size.
    consolidation_search_rounds: int = 2
    consolidation_population_size: int = 128
    # SLO rule engine (obs/slo.py): per-rule overrides merged over the
    # default rule set — {"rule-name": {"threshold": ..., "budget": ...,
    # "fast_window_s": ..., "slow_window_s": ..., "enabled": ...}}; a
    # non-default name creates a new rule and must carry "signal"
    slo_rules: Dict[str, dict] = field(default_factory=dict)
    # streaming anomaly detection over the phase-latency series
    # (obs/detect.py); the simulator force-disables it (wall-clock values
    # cannot enter a byte-compared trace)
    enable_anomaly_detection: bool = True
    # flight recorder (obs/flight.py): ring depth in ticks, and the
    # directory breach/crash dumps land in ("" keeps the ring in-memory
    # only — still served at /debug/flight and dumpable via SIGUSR1)
    flight_ticks: int = 64
    flight_dir: str = ""
    # device observatory (obs/device.py): compile/transfer/resident
    # accounting behind the dispatch boundary — the karpenter_device_*
    # families, the flight `device` section, /debug/device.  Counting
    # only; off turns every seam into a passthrough (the twin-run test
    # proves on/off changes zero scheduling actions)
    enable_device_observatory: bool = True
    # fleet-scale store plane, CLIENT side (docs/designs/store-scale.md).
    # store_codec: "auto" negotiates the compact binary payload codec
    # (state/binwire.py) per connection and falls back to tagged JSON
    # against an older server; "json" never negotiates.  store_events_cap
    # bounds the mirror's local cluster-event ledger (the server's own
    # bounds are the store-server flags --replay-log-events /
    # --watch-queue-batches / --events-cap, chart store.* values).
    store_codec: str = "auto"
    store_events_cap: int = 4096
    # runtime concurrency sanitizer (analysis/sanitizer.py): wrap every
    # seam-constructed lock in the lock-order/lockset witness.  OFF in
    # production by default — the sanitized test suites are the normal
    # consumer; enabling in a deployment buys the deadlock watchdog and
    # a witness artifact on shutdown at measured per-acquisition cost
    # (the sanitizer_lock_overhead bench line)
    enable_lock_sanitizer: bool = False
    # multi-tenant SolverService (service/server.py + docs/designs/
    # solver-service.md): one solver process serving a fleet of operator
    # tenants.  OFF keeps the legacy single-operator sidecar contract
    # exactly (no batching, no admission, no resident pooling).  The
    # window pair is the cross-tenant CoalesceWindow (batch_idle_s of
    # quiet or batch_max_s total closes a solve batch); the inflight cap
    # bounds any one tenant's concurrent solves (excess gets an explicit
    # RETRY-AFTER refusal, never a silent queue slot); the resident
    # budget caps total device bytes pinned across all tenants' warm
    # solve tensors (cross-tenant LRU eviction above it)
    service_multi_tenant: bool = False
    service_batch_idle_s: float = 0.005
    service_batch_max_s: float = 0.05
    service_tenant_inflight_cap: int = 4
    service_resident_budget_mb: int = 256
    # deadlock watchdog (sanitizer.LockWatchdog): when the sanitizer is
    # enabled and EVERY currently-held lock has been held longer than
    # this many seconds, dump the live lock graph + a flight record.
    # 0 disables the watchdog thread entirely
    lock_watchdog_stall_s: float = 0.0

    # legacy names accepted on ingest (file and env) so a configmap or
    # environment written before the provision_batch_* rename keeps
    # working across an image upgrade; the new name wins when both are
    # present
    _LEGACY_NAMES = {
        "batch_idle_duration": "provision_batch_idle_s",
        "batch_max_duration": "provision_batch_max_s",
    }

    @classmethod
    def from_file(cls, path: str) -> "Settings":
        """Load from a JSON file — the configmap analogue
        (karpenter-global-settings, reference settings.go:48-61)."""
        import json

        with open(path) as f:
            raw = json.load(f)
        for old, new in cls._LEGACY_NAMES.items():
            if old in raw:
                raw.setdefault(new, raw.pop(old))
        known = {f.name for f in cls.__dataclass_fields__.values()}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown settings: {sorted(unknown)}")
        return cls(**raw)

    @classmethod
    def from_env(cls, environ=None) -> "Settings":
        """Load from KARPENTER_* environment variables (the CLI/env layer
        of the reference's 3-tier config, website v0.31 settings.md:15-27):
        KARPENTER_CLUSTER_NAME, KARPENTER_CLUSTER_ENDPOINT,
        KARPENTER_ISOLATED_VPC, KARPENTER_INTERRUPTION_QUEUE_NAME, ..."""
        import json
        import os

        environ = environ if environ is not None else os.environ
        legacy_of = {new: old for old, new in cls._LEGACY_NAMES.items()}
        kw: Dict[str, object] = {}
        for f in cls.__dataclass_fields__.values():
            raw = environ.get(f"KARPENTER_{f.name.upper()}")
            if raw is None and f.name in legacy_of:
                # pre-rename env var: accepted, new name wins when both set
                raw = environ.get(
                    f"KARPENTER_{legacy_of[f.name].upper()}"
                )
            if raw is None:
                continue
            if f.type in ("bool", bool):
                kw[f.name] = raw.lower() in ("1", "true", "yes")
            elif f.type in ("float", float):
                kw[f.name] = float(raw)
            elif f.type in ("int", int):
                kw[f.name] = int(raw)
            elif f.name in ("tags", "slo_rules"):
                kw[f.name] = json.loads(raw)
            else:
                kw[f.name] = raw
        return cls(**kw)

    def validate(self) -> None:
        if not self.cluster_name:
            raise ValueError("cluster_name is required")
        if not (0.0 <= self.vm_memory_overhead_percent < 1.0):
            raise ValueError("vm_memory_overhead_percent must be in [0,1)")
        if self.provision_batch_idle_s < 0 or self.provision_batch_max_s < 0:
            raise ValueError("batch windows must be non-negative")
        if self.provision_batch_max_s < self.provision_batch_idle_s:
            raise ValueError(
                "provision_batch_max_s must be >= provision_batch_idle_s"
            )
        if self.launch_max_concurrency < 1:
            raise ValueError("launch_max_concurrency must be >= 1")
        if self.reserved_enis < 0:
            raise ValueError("reserved_enis must be >= 0")
        if self.cloud_max_retries < 0 or self.cloud_retry_budget_per_tick < 0:
            raise ValueError("cloud retry knobs must be >= 0")
        if self.cloud_backoff_base < 0 or self.cloud_backoff_max < self.cloud_backoff_base:
            raise ValueError("cloud_backoff_max must be >= cloud_backoff_base >= 0")
        if self.cloud_circuit_failure_threshold < 1:
            raise ValueError("cloud_circuit_failure_threshold must be >= 1")
        if self.cloud_circuit_reset_timeout < 0:
            raise ValueError("cloud_circuit_reset_timeout must be >= 0")
        if (
            self.controller_backoff_base <= 0
            or self.controller_backoff_max < self.controller_backoff_base
        ):
            raise ValueError(
                "controller_backoff_max must be >= controller_backoff_base > 0"
            )
        if self.consolidation_search_rounds < 1:
            raise ValueError("consolidation_search_rounds must be >= 1")
        if self.consolidation_population_size < 4:
            raise ValueError("consolidation_population_size must be >= 4")
        if not isinstance(self.slo_rules, dict) or any(
            not isinstance(v, dict) for v in self.slo_rules.values()
        ):
            raise ValueError(
                "slo_rules must map rule names to override dicts"
            )
        if self.flight_ticks < 1:
            raise ValueError("flight_ticks must be >= 1")
        if self.store_codec not in ("auto", "json"):
            raise ValueError("store_codec must be 'auto' or 'json'")
        if self.store_events_cap < 1:
            raise ValueError("store_events_cap must be >= 1")
        if self.service_batch_idle_s < 0 or self.service_batch_max_s < 0:
            raise ValueError("service batch windows must be non-negative")
        if self.service_batch_max_s < self.service_batch_idle_s:
            raise ValueError(
                "service_batch_max_s must be >= service_batch_idle_s"
            )
        if self.service_tenant_inflight_cap < 1:
            raise ValueError("service_tenant_inflight_cap must be >= 1")
        if self.service_resident_budget_mb < 0:
            raise ValueError("service_resident_budget_mb must be >= 0")
        if self.lock_watchdog_stall_s < 0:
            raise ValueError("lock_watchdog_stall_s must be >= 0")
        if self.lock_watchdog_stall_s and not self.enable_lock_sanitizer:
            raise ValueError(
                "lock_watchdog_stall_s needs enable_lock_sanitizer (the "
                "watchdog reads the sanitizer's holder table)"
            )
