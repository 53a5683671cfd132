"""THE declarative allowlist table: one place where every sanctioned
exception to every rule lives, each with the argument for its existence.

Entry types are rule-defined:

- path strings ``"karpenter_tpu_torch/utils/clock.py"`` (file-scoped),
- ``(file, qualified name)`` tuples (call-site / region scoped),
- ``"LockA|LockB"`` pair ids (lock-order),
- ``"root:<rel_in_pkg>:<qual>"`` strings (extra determinism roots — the
  teeth harness hook),
- bare names (doc-vocabulary extensions, used only by synthetic tests;
  for tracer-safety, the CUDA library's host-query entries).

Adding an entry here is a REVIEWED act: the change that adds one must say
why the exception is sound (see docs/designs/static-analysis.md).
"""

from __future__ import annotations

from typing import Dict

# ---------------------------------------------------------------- legacy
# rule 3: the genuinely-wall-clock spot — the Clock abstraction itself is
# the one place allowed to read the wall (time.monotonic/perf_counter
# remain free: host-side durations no simulated clock can compress).
_WALL_CLOCK = frozenset({"karpenter_tpu_torch/utils/clock.py"})

# rule 4: the sanctioned scheduler.update call sites in controllers/ —
# the provisioner's one-per-solve sync (extracted to _sync_scheduler so
# the batched solve and the admission fast path share exactly ONE update
# per provisioning pass), the deprovisioner's explicit
# sequential-simulation fallback, and the batched evaluator's
# once-per-pass full-cluster sync.
_SCHEDULER_UPDATE = frozenset(
    {
        ("karpenter_tpu_torch/controllers/provisioning.py",
         "Provisioner._sync_scheduler"),
        ("karpenter_tpu_torch/controllers/disruption.py",
         "DisruptionController._simulate"),
        ("karpenter_tpu_torch/controllers/disruption.py",
         "_RemovalEvaluator._sync_scheduler"),
    }
)

# rule 7: the sanctioned full-tensorize sites — the wrapper itself, the
# cold build / resident-miss rebuild, and the consolidation base's
# rebuild fallback.  The port's scheduler is TorchScheduler, and it has
# no counterpart of the reference's _solve_tensor (the direct
# compile+pack+decode kept for tests): its cold compile is in _solve.
_FULL_TENSORIZE = frozenset(
    {
        ("karpenter_tpu_torch/scheduling/solver.py",
         "TorchScheduler._compile_tensor"),
        ("karpenter_tpu_torch/scheduling/solver.py", "TorchScheduler._solve"),
        ("karpenter_tpu_torch/scheduling/solver.py",
         "TorchScheduler._build_removal_base"),
    }
)

# rule 8: the sanctioned sequential-descent sites — the lazy per-element
# fallback, the winner's authoritative re-derivation, and the
# consolidation pass entry points (multi -> descent fallback).
_SEQUENTIAL_DESCENT = frozenset(
    {
        ("karpenter_tpu_torch/controllers/disruption.py",
         "_RemovalEvaluator.result"),
        ("karpenter_tpu_torch/controllers/disruption.py",
         "_RemovalEvaluator.vnode_for"),
        ("karpenter_tpu_torch/controllers/disruption.py",
         "DisruptionController._consolidate"),
        ("karpenter_tpu_torch/controllers/disruption.py",
         "DisruptionController._consolidate_multi"),
    }
)

# rule 9: the counted-upload seam is the one sanctioned raw upload (its
# ``.copy_`` into a fresh device allocation), its device-to-device sibling,
# and one site that matches the upload syntax without being an upload on
# any path:
_DEVICE_PUT = frozenset(
    {
        ("karpenter_tpu_torch/obs/device.py", "DeviceObservatory.put"),
        # The counted device-to-device seam: its ``.copy_`` moves a shard's
        # slice between two device buffers (the mesh's exchange, the
        # resident state's reshard), never host data, and counts its bytes
        # under the caller's site as `put` counts an upload.
        ("karpenter_tpu_torch/obs/device.py", "DeviceObservatory.exchange"),
        # The plain version of the scan builds its first-free-slot scalar
        # on the device its tensors lie on.  The wrappers hand it CPU
        # tensors only (fused_packer.ffd_scan and fleet_pack run their
        # kernels for card tensors), where the constructor copies nothing
        # over a link.  On the card it runs only where a kernel is held
        # against its plain version on the same card tensors (the smoke
        # script's comparisons), off every path whose transfers the
        # observatory accounts, and there its one 4-byte scalar belongs
        # to the comparison, not to a solve.
        ("karpenter_tpu_torch/ops/packer.py", "ffd_scan_reference"),
    }
)

# rule 11: the one sanctioned pool constructor for the controller layer.
_THREAD_SEAM = frozenset(
    {("karpenter_tpu_torch/pipeline.py", "run_concurrently")}
)

# ------------------------------------------------------- lock discipline
# Cross-class lock aliases the AST cannot see: _Subscriber.cond is
# constructed OVER the VersionedStore's lock (store_server.py — offers
# happen under the store lock, the sender waits on the same lock), so
# holding one IS holding the other; without the alias every
# subscribe-under-lock would read as a lock-order edge.
LOCK_ALIASES: Dict[str, str] = {
    "_Subscriber.cond": "VersionedStore.lock",
}

# lock-order scan scope: the layers whose locks interleave across
# threads (store plane, pipeline/operator, controllers, batcher).
LOCK_ORDER_LAYERS = (
    "service/",
    "state/",
    "pipeline.py",
    "operator.py",
    "controllers/",
    "batcher/",
    "utils/leader.py",
)

# lock-blocking sanctioned regions, each with its argument:
_LOCK_BLOCKING = frozenset(
    {
        # The RPC lock EXISTS to serialize the one shared connection:
        # one in-flight request per socket is the framing protocol's
        # invariant, so the send/recv pair must sit inside it.  Nothing
        # else ever takes this lock.
        ("karpenter_tpu_torch/state/remote.py", "RemoteKubeStore._rpc"),
        # Lease operations serialize END-TO-END by design (the
        # base_rv race documented at the _lease_mutex definition):
        # holding the dedicated mutex across flush+RPC is the
        # correctness mechanism, and only lease ops contend on it.
        ("karpenter_tpu_torch/state/remote.py",
         "RemoteKubeStore.try_acquire_lease"),
        ("karpenter_tpu_torch/state/remote.py", "RemoteKubeStore.renew_lease"),
        ("karpenter_tpu_torch/state/remote.py", "RemoteKubeStore.release_lease"),
        # The solver sidecar client: same one-in-flight-RPC-per-
        # connection design as RemoteKubeStore._rpc.
        ("karpenter_tpu_torch/service/client.py", "RemoteSolver._call"),
        # A bin snapshot references LIVE objects, so it must be rendered
        # before the store lock drops (store_server.py documents the
        # contract; the JSON tree path encodes outside).  The watcher
        # condition shares the store lock, so the coalesced-resync build
        # (_resync_payload_locked) sits under the same region.
        ("karpenter_tpu_torch/service/store_server.py", "StoreServer.serve_watch"),
        # The ledger's JSONL sink writes one SMALL event per emit under
        # the ring lock — the lock is what keeps sink lines in seq
        # order; payloads are single events, never snapshot-sized.
        ("karpenter_tpu_torch/obs/events.py", "EventLedger.emit"),
        # The durable log's lock is what keeps on-disk records in seq
        # order — encode+write+fsync MUST sit inside it or a concurrent
        # append could interleave frames and corrupt the segment.  The
        # payload is one commit batch (bounded by the batcher), and the
        # caller already serialized on the store lock: durability-
        # before-ack is the contract under test, not an accident.
        ("karpenter_tpu_torch/state/storelog.py", "DurableReplayLog.append_batch"),
        # Checkpoints write snapshot-sized payloads, but to a TMP file
        # finalized by an atomic rename; the lock orders the segment
        # swap against concurrent appends so recovery's "last
        # checkpoint + contiguous tail" invariant can never observe a
        # half-swapped segment.
        ("karpenter_tpu_torch/state/storelog.py",
         "DurableReplayLog.write_checkpoint"),
    }
)

_LOCK_ORDER = frozenset()

# ------------------------------------------------- determinism analyzer
# The byte-compared surfaces (package-relative so synthetic trees keep
# the vocabulary): per-tick digests, ledger lines, the SLO report, the
# cluster event ledger, and the pipelined twin-run adoption seam.
DETERMINISM_ROOTS = (
    "sim/trace.py:TraceWriter.digest",
    "sim/trace.py:TraceWriter.ledger",
    "sim/trace.py:TraceWriter.report",
    "sim/report.py:build_report",
    "obs/events.py:EventLedger.emit",
    "controllers/disruption.py:DisruptionController._take_speculation",
    "controllers/disruption.py:DisruptionController._pass_fingerprint",
    # the columnar event tape's identity hash: a tape must replay
    # byte-identical to its per-event twin, so everything reachable from
    # the digest (column builds, the counter RNG, per-tick
    # materialization) is a byte-compared surface
    "load/generators.py:EventTape.digest",
)

# sanctioned sinks, each with its argument:
_DETERMINISM = frozenset(
    {
        # THE sanctioned wall-clock: determinism holds because the
        # simulator injects a FakeClock here; replay tests prove the
        # bytes (docs/designs/simulation.md).
        "karpenter_tpu_torch/utils/clock.py",
    }
)

# --------------------------------------------------- tracer-safety seam
# Bare names are the CUDA library's host queries (ops/fused_packer.py):
# entries that launch no kernel, so a function that calls only them is
# not a launch wrapper and its calls need no dispatch.  Each returns a
# figure the host plans a launch with and touches no tensor:
_TRACER_SAFETY = frozenset(
    {
        # cudaOccupancyMaxActiveBlocksPerMultiprocessor / ...Clusters for
        # a scan at given shapes: how many batch elements run at once
        "ffd_scan_concurrency",
        # the largest R whose alloc and group rows the verdict config
        # pass can stage in shared memory (a device-attribute query)
        "ffd_verdict_max_axes",
        # bytes of the scratch buffer verdict_rows allocates (arithmetic)
        "ffd_verdict_scratch_bytes",
        # the verdict config pass's compile-time tile and largest group
        "ffd_verdict_config_tile",
        "ffd_verdict_max_group",
    }
)

# ------------------------------------------------- runtime sanitizer
# Locks under which the runtime blocking witness (sanitizer.py
# note_blocking) is SANCTIONED — each the dynamic twin of a static
# _LOCK_BLOCKING region above, with the same argument:
SANITIZER_BLOCKING_LOCKS = frozenset(
    {
        # one in-flight request per socket is the framing protocol's
        # invariant: the RPC lock EXISTS to hold across send+recv
        "RemoteKubeStore._rpc_lock",
        # lease ops serialize end-to-end by design (the base_rv race):
        # the mutex is held across flush+RPC on purpose
        "RemoteKubeStore._lease_mutex",
        # the solver sidecar's one-in-flight connection lock
        "RemoteSolver._lock",
        # bin snapshots/frames reference LIVE objects and must render
        # before the store lock drops (store_server.py's documented
        # contract — the static serve_watch allowlist's runtime twin)
        "VersionedStore.lock",
        # per-shard RPC serialization: one in-flight request per shard
        # socket is the framing invariant (the sharded twin of
        # RemoteKubeStore._rpc_lock — each StoreChannel carries its own)
        "StoreChannel._lock",
        # durability-before-ack: encode+write+fsync hold the log lock
        # so disk records stay in seq order (the runtime twin of the
        # static storelog.py allowlist entries above)
        "DurableReplayLog._lock",
    }
)

# Runtime lock-order edges the static model does not predict, each
# sanctioned with an argument ("outer|inner" pair ids).  Empty on
# purpose: the sanitized suites currently exercise no edge the static
# analyzer misses — a new entry here means EITHER a static-resolution
# hole (fix locks.py) or a deliberate dynamic-only pattern (argue it).
WITNESS_EDGES = frozenset()

# settings-flow: fields exempt from the READ requirement only (chart
# presence is never exempt — an accepted field costs one values line):
_SETTINGS_FLOW = frozenset(
    {
        # Reference-parity ENI knobs (settings.go:48-61): accepted and
        # validated for config compatibility with reference settings
        # payloads, but this build's fake backend has no ENI density
        # model to consume them yet.  Wiring them into
        # InstanceTypeProvider is open work; until then they are
        # DECLARED dead, not silently dead.
        "reserved_enis",
        "enable_pod_eni",
        "enable_eni_limited_pod_density",
    }
)

# ---------------------------------------- service tenant metrics (rule 12)
# service/ files exempt from the tenant-label requirement because they
# are the STORE plane, not the solver service: one shared cluster store
# per deployment, tenant-less by design — its karpenter_store_* families
# key on method/codec, and tenancy is a solver-service concept.
_SERVICE_TENANT_METRICS = frozenset(
    {
        "karpenter_tpu_torch/service/store_server.py",
        "karpenter_tpu_torch/service/shardrouter.py",
    }
)

# lock-seam: raw constructions sanctioned by (file, "Class.attr"):
_LOCK_SEAM = frozenset(
    {
        # the sanitizer's own mutex: wrapping it in itself would recurse
        ("karpenter_tpu_torch/analysis/sanitizer.py", "LockSanitizer._mu"),
    }
)

ALLOWLISTS: Dict[str, frozenset] = {
    "wall-clock": _WALL_CLOCK,
    "scheduler-update": _SCHEDULER_UPDATE,
    "full-tensorize": _FULL_TENSORIZE,
    "sequential-descent": _SEQUENTIAL_DESCENT,
    "device-put": _DEVICE_PUT,
    "thread-seam": _THREAD_SEAM,
    "lock-blocking": _LOCK_BLOCKING,
    "lock-order": _LOCK_ORDER,
    "determinism-reachability": _DETERMINISM,
    "tracer-safety": _TRACER_SAFETY,
    "settings-flow": _SETTINGS_FLOW,
    "service-tenant-metrics": _SERVICE_TENANT_METRICS,
    "lock-seam": _LOCK_SEAM,
}
