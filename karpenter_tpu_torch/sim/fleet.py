"""Fleet chaos scenarios: 3+ REAL Operators against ONE store server.

The single-operator simulator (sim/runner.py) proves the controllers;
this module proves the fleet-scale STORE PLANE under them
(docs/designs/store-scale.md): three live Operator replicas dial one
`StoreServer` as thin clients (state/remote.py), a read replica follows
it over the watch protocol, a deliberately wedged watcher leans on the
bounded fan-out queues — and the whole thing is driven deterministically
on a FakeClock through seeded workload churn plus a scripted failover
storm (leader crash, rejoin, graceful release, a second crash of the new
leader), extending the 2-operator election-storm suite to fleet shape.

Determinism contract (same as sim/runner.py): everything the generators
and the chaos script decide is RECORDED into the trace as ``ev`` lines
(chosen pod sizes, chosen kill targets, chosen crash victims), so
``replay`` re-applies the tape with no generator in the loop; per-tick
``dig`` lines fingerprint the PRIMARY server's canonical state, the
launch log, and the leader.  Two runs of the same (scenario, seed,
ticks) — and a replay of either — are byte-identical.  Ledger lines ride
along per replica, except ``StoreResync``: like anomaly events, resyncs
depend on wall-clock thread pacing (a socket hiccup heals through one)
and must stay out of byte-compared surfaces.

Invariants (checked every tick + at the end, reported not assumed):
single writer per round outside scripted failover handoffs, no duplicate
nominations between writers, every launch from that round's writer, ZERO
NodeClaim double-launches, live claims registered against running
instances, and the read replica converged with the primary's rv numbers
preserved key-for-key.

The port of ``karpenter_tpu/sim/fleet.py``.  `FleetRunner`, `run_fleet`
and `replay_fleet` take the ``device`` every operator (and, in
``solver-fleet``, the multi-tenant `SolverServer`) runs on: the card
unless the caller asks for the CPU.  The fleet trace has no device
section, so a run's trace does not depend on the device, and the port's
trace on the CPU equals the JAX package's byte for byte.  ``shapes`` is
the fake cloud's catalog (``generate_catalog()`` when None, as in the
reference), so a cell can run the fleet over another catalog.
"""

from __future__ import annotations

import hashlib
import os
import random
import shutil
import socket
import tempfile
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.api import NodeClass, NodePool, Pod, Resources, Settings
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import (
    SelectorTerm,
    StorageClass,
    reset_name_sequences,
    tolerates_all,
)
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, generate_catalog
from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.operator import Operator
from karpenter_tpu_torch.ops.packer import resolve_device
from karpenter_tpu_torch.service.codec import (
    CODEC_BIN,
    CODEC_JSON,
    decode_payload,
    encode_payload,
    recv_frame,
    send_frame,
)
from karpenter_tpu_torch.service.client import RemoteSolver
from karpenter_tpu_torch.service.server import SolverServer
from karpenter_tpu_torch.service.shardrouter import ShardCoordinator
from karpenter_tpu_torch.service.store_server import StoreServer, VersionedStore
from karpenter_tpu_torch.sim.faults import FailingFsync, WireFaultInjector
from karpenter_tpu_torch.sim.trace import TraceWriter, read_trace
from karpenter_tpu_torch.state.binwire import SCHEMA_FP
from karpenter_tpu_torch.state.kube import Node
from karpenter_tpu_torch.state.remote import RemoteKubeStore
from karpenter_tpu_torch.state.storelog import FSYNC_ALWAYS, DurableReplayLog
from karpenter_tpu_torch.state.wire import canonical
from karpenter_tpu_torch.testing import FAST_BATCH_WINDOWS
from karpenter_tpu_torch.utils.clock import FakeClock
from karpenter_tpu_torch.utils.leader import LEASE_DURATION_S, LeaderElector

TICK_S = 2.0
SETTLE_MAX_ROUNDS = 60
FLEET_SHARDS = 4  # initial shard count for the sharded scenario

# the scripted failover storm, as tick fractions of the run: crash the
# leader, let the standby take over on lease expiry, rejoin, force a
# graceful mid-run handoff, then crash the NEW leader — every replica
# should lead at some point
_CRASH_A, _REJOIN_A, _RELEASE, _CRASH_B, _REJOIN_B = (
    0.2, 0.4, 0.55, 0.7, 0.85,
)

# the sharded scenario's second storm, layered over the failover storm:
# kill a shard mid-churn (atomic kill + restart-from-disk at the same
# address, with a protocol-level delta-resync probe), tear bytes on the
# wire, split 4 shards into 5 under the migration fence, kill again in
# the NEW topology, then fail a shard's fsync
_SHARD_KILL_A, _WIRE_FAULT_A, _SHARD_SPLIT, _WIRE_FAULT_B, _SHARD_KILL_B, _FSYNC_FAIL = (
    0.25, 0.35, 0.5, 0.6, 0.65, 0.8,
)

FLEET_SCENARIOS: Dict[str, str] = {
    "store-fleet-chaos": (
        "3 real Operators + a read replica + a wedged watcher against one "
        "store server through seeded churn and a scripted failover storm"
    ),
    "store-fleet-shard-chaos": (
        "3 real Operators against 4 durable store shards through the "
        "failover storm PLUS shard kills (restart-from-disk, delta "
        "resync), a live 4->5 split under the migration fence, scripted "
        "wire faults, and an injected fsync failure"
    ),
    "solver-fleet": (
        "many real Operators, each a TENANT of one multi-tenant "
        "SolverService (docs/designs/solver-service.md), through seeded "
        "churn and the failover storm — every solve a remote RPC with "
        "per-tenant resident state, zero refusals, zero double-launches"
    ),
}


class _FleetTrace(TraceWriter):
    """The fleet trace: same JSONL discipline as the single-op trace,
    with a fleet-shaped meta line, per-replica ledger lines, and a
    per-tick fleet line (leader / writers / launch fingerprint) next to
    the digest over the PRIMARY server's state (the authoritative truth
    all mirrors converge to)."""

    def fleet_meta(
        self, scenario: str, seed: int, ticks: int, operators: int
    ) -> None:
        self._write(
            {
                "t": "meta",
                "v": 1,
                "fleet": True,
                "scenario": scenario,
                "seed": seed,
                "ticks": ticks,
                "tick_s": TICK_S,
                "operators": operators,
            }
        )

    def fleet_led(self, tick: int, replica: str, ev) -> None:
        self._write(
            {
                "t": "led",
                "tick": tick,
                "replica": replica,
                "seq": ev.seq,
                "ts": ev.ts,
                "type": ev.type,
                "trace_id": ev.trace_id,
                "attrs": dict(ev.attrs),
            }
        )

    def fleet_tick(
        self,
        tick: int,
        leader: str,
        writers: List[str],
        launches: int,
        launch_sha: str,
    ) -> None:
        self._write(
            {
                "t": "fleet",
                "tick": tick,
                "leader": leader,
                "writers": writers,
                "launches": launches,
                "launch_sha": launch_sha,
            }
        )


class FleetRunner:
    def __init__(
        self,
        scenario: str = "store-fleet-chaos",
        seed: int = 0,
        ticks: int = 36,
        operators: int = 3,
        trace: Optional[_FleetTrace] = None,
        tape: Optional[Dict[int, List[Tuple[str, dict]]]] = None,
        device=None,
        shapes=None,
    ):
        if scenario not in FLEET_SCENARIOS:
            raise ValueError(
                f"unknown fleet scenario {scenario!r}; "
                f"have {sorted(FLEET_SCENARIOS)}"
            )
        # asking for CUDA without a card raises here, before any server
        # or client is started
        device = resolve_device(device)
        self.scenario = scenario
        self.seed = seed
        self.ticks = ticks
        self.n_operators = operators
        self.trace = trace or _FleetTrace()
        self.tape = tape  # replay mode when set
        # two rngs: the WORKLOAD rng only runs in generate mode (its
        # choices are recorded onto the tape); the DRIVE rng paces
        # nothing that the tape must carry and draws identically in
        # replay (reserved for future fuzzing — the fleet currently
        # reconciles in the production order)
        self._gen_rng = random.Random(seed)
        reset_name_sequences()

        self.sharded = scenario == "store-fleet-shard-chaos"
        self.solver_fleet = scenario == "solver-fleet"
        self._pace_stop = threading.Event()
        if self.sharded:
            # N durable shard primaries, each with its own on-disk replay
            # segment — a killed shard restarts FROM DISK at the same
            # address and must serve delta resyncs
            self._log_dir = tempfile.mkdtemp(prefix="fleet-shardlog-")
            self._fsyncs: List[FailingFsync] = []
            self._injector = WireFaultInjector()
            self.shards: List[StoreServer] = [
                self._make_shard(i) for i in range(FLEET_SHARDS)
            ]
            self.shard_addrs: List[Tuple[str, int]] = [
                s.address for s in self.shards
            ]
            self.primary = self.shards[0]
            self.shard_facts: Dict[str, object] = {
                "kills": 0,
                "delta_resyncs": 0,
                "snapshot_fallbacks": 0,
                "delta_ratio_max": 0.0,
                "epoch_preserved": True,
                "split_moved_keys": 0,
            }
        else:
            self.primary = StoreServer(
                store=VersionedStore(replay_log_events=64)
            ).start_background()
        host, port = self.primary.address
        self.replica = StoreServer(
            replica_of=self.primary.address
        ).start_background()
        # the deliberately wedged watcher: an in-process subscriber with
        # a tiny bound that is NEVER drained — churn must overflow it
        # into one coalesced resync, not into server memory
        _mode, _payload, self.sink = self.primary.store.subscribe(
            "wedged-sink", CODEC_JSON, cap=4
        )

        self.clock = FakeClock()
        self.cloud = FakeCloud(
            self.clock, shapes=generate_catalog() if shapes is None else shapes
        ).with_default_topology()
        settings = Settings(cluster_name="fleet")
        self.ops: Dict[str, Operator] = {}
        self.kubes: Dict[str, RemoteKubeStore] = {}
        self.names = [f"op-{i}" for i in range(operators)]
        for name in self.names:
            if self.sharded:
                kube = RemoteKubeStore(
                    identity=name,
                    shards=self.shard_addrs,
                    watch_pace=self._pace,
                )
            else:
                kube = RemoteKubeStore(host, port, identity=name)
            elector = LeaderElector(kube, self.clock, name)
            registry = Registry()
            op = Operator(
                self.cloud,
                kube,
                settings=settings,
                clock=self.clock,
                registry=registry,
                batch_windows=FAST_BATCH_WINDOWS,
                elector=elector,
                device=device,
            )
            self._instrument_launches(op, name)
            # same determinism contract as sim/runner.py: the anomaly
            # detector judges wall-clock values and gates the
            # DeviceRecompile ledger events, both of which depend on
            # process history — neither may enter a byte-compared trace;
            # the pipelined reconcile likewise degrades to the
            # sequential schedule (speculation is wall-clock-shaped
            # work a byte-compared fleet trace must not record)
            op.detector.enabled = False
            op.pipeline.enabled = False
            self.kubes[name] = kube
            self.ops[name] = op
        # the solver-fleet scenario: ONE multi-tenant SolverService
        # serves every operator's solves, each operator a tenant under
        # its own name.  Reconciles are sequential per tick, so every
        # RPC rides the solo fall-through — deterministic, and
        # bit-identical to a local solve (the twin contract the
        # service's batched path also holds).
        self.solver: Optional[SolverServer] = None
        self._solver_clients: List[RemoteSolver] = []
        if self.solver_fleet:
            self.solver = SolverServer(
                port=0, multi_tenant=True, device=device
            ).start_background()
            for name in self.names:
                remote = RemoteSolver(*self.solver.address, tenant=name)
                self.ops[
                    name
                ].provisioner.scheduler.pack_fn = remote.pack_problem
                self._solver_clients.append(remote)
        # a passive reader mirroring the READ REPLICA: proves the
        # replica serves snapshot+watch traffic with primary ordering.
        # In the sharded scenario a SECOND reader merges all the shards'
        # watch streams into one mirror (the replica still follows shard
        # 0, which the kill script never targets).
        self.reader = RemoteKubeStore(
            *self.replica.address, identity="replica-reader"
        )
        self.merged_reader: Optional[RemoteKubeStore] = None
        if self.sharded:
            self.merged_reader = RemoteKubeStore(
                identity="merged-reader",
                shards=self.shard_addrs,
                watch_pace=self._pace,
            )
        self._led_seqs = {name: 0 for name in self.names}
        self.launches: List[Tuple[int, str, str]] = []
        self.tick_no = -1
        self.crashed: set = set()
        self.release_pending: set = set()
        self.failover_ticks: set = set()
        self.violations: List[str] = []
        self.live_pods: List[Pod] = []
        self.writers_by_tick: Dict[int, List[str]] = {}
        self.leader_history: List[str] = []

        kube = self.kubes[self.names[0]]
        kube.put_node_class(
            NodeClass(
                name="default",
                subnet_selector_terms=[SelectorTerm.of(Name="*")],
                security_group_selector_terms=[SelectorTerm.of(Name="*")],
            )
        )
        kube.put_node_pool(NodePool(name="default", node_class_ref="default"))
        if self.sharded:
            # ballast corpus: a fleet store's snapshot is dominated by
            # STANDING state, not the churn since a disconnect — the
            # delta-vs-snapshot probe (and the whole point of disk-backed
            # delta resyncs) is only meaningful against that shape.
            # StorageClasses are inert to the controllers unless a PVC
            # references one, so they fatten every shard's snapshot
            # without adding scheduling work.
            for i in range(400):
                kube.put_storage_class(
                    StorageClass(
                        name=f"ballast-{i}", zones=(f"zone-{i % 4}",)
                    )
                )
        self._sync("init")

    # ----------------------------------------------------------- plumbing
    def _pace(self, _delay_s: float) -> bool:
        """Deterministic watch-reconnect pacer (service/watchclient.py's
        ``pace`` seam): a short FIXED wall wait instead of the wall-clock
        exponential backoff, so scripted shard kills reconnect promptly
        and uniformly — reconnect timing never shapes which tick a
        resync lands in relative to the sync barriers."""
        return self._pace_stop.wait(0.02)

    def _make_shard(self, index: int, port: int = 0) -> StoreServer:
        """One durable shard primary: its replay segment lives in the
        run's log dir under the shard's index, so a restart at the same
        index recovers the same segment.  The fsync seam is an armable
        `FailingFsync` for the scripted fsync-failure event."""
        fsync = FailingFsync()
        while len(self._fsyncs) <= index:
            self._fsyncs.append(fsync)
        self._fsyncs[index] = fsync
        dlog = DurableReplayLog(
            os.path.join(self._log_dir, f"store-shard-{index}.log"),
            fsync=FSYNC_ALWAYS,
            fsync_fn=fsync,
        )
        return StoreServer(
            port=port,
            store=VersionedStore(replay_log_events=64, durable_log=dlog),
            shard_index=index,
        ).start_background()

    def _probe_watch(self, srv: StoreServer, since_seq: int, epoch: str):
        """Protocol-level resync probe: present a (epoch, seq) cursor to
        ``srv`` and return (mode, first_sync_payload_bytes) — the
        wire-level fact of whether the server answered with a delta
        replay or a full snapshot, and how big it was."""
        sock = socket.create_connection(srv.address, timeout=5.0)
        try:
            sock.settimeout(5.0)
            send_frame(
                sock,
                encode_payload(
                    {
                        "method": "watch",
                        "identity": f"chaos-probe-{since_seq}",
                        "codecs": [CODEC_BIN, CODEC_JSON],
                        "schema_fp": SCHEMA_FP,
                        "since_seq": since_seq,
                        "epoch": epoch,
                    },
                    CODEC_JSON,
                ),
            )
            ack = decode_payload(recv_frame(sock), CODEC_JSON)
            codec = ack.get("codec", CODEC_JSON)
            payload = recv_frame(sock)
            frame = decode_payload(payload, codec)
            return frame.get("mode", "?"), len(payload)
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _kill_restart_shard(self, index: int) -> None:
        """Atomic shard crash: stop the server, restart it at the SAME
        address from its on-disk replay segment, then prove the wire
        contract — the recovered store re-adopted its epoch and serves a
        pre-kill cursor as a DELTA replay an order of magnitude smaller
        than the snapshot fallback."""
        srv = self.shards[index]
        host, port = srv.address
        pre_epoch, pre_seq = srv.store.epoch, srv.store.log_seq
        srv.stop()
        new_srv = self._make_shard(index, port=port)
        self.shards[index] = new_srv
        self.shard_addrs[index] = new_srv.address
        facts = self.shard_facts
        facts["kills"] = int(facts["kills"]) + 1
        if new_srv.store.epoch != pre_epoch:
            facts["epoch_preserved"] = False
        # a client that was at (pre_epoch, a few batches back) must get
        # a replay; a cursorless client measures the snapshot cost
        probe_seq = max(1, pre_seq - 2)
        mode, delta_bytes = self._probe_watch(new_srv, probe_seq, pre_epoch)
        _snap_mode, snap_bytes = self._probe_watch(new_srv, 0, "")
        if mode == "replay":
            facts["delta_resyncs"] = int(facts["delta_resyncs"]) + 1
        else:
            facts["snapshot_fallbacks"] = (
                int(facts["snapshot_fallbacks"]) + 1
            )
        ratio = round(delta_bytes / max(1, snap_bytes), 2)
        facts["delta_ratio_max"] = max(
            float(facts["delta_ratio_max"]), ratio
        )

    def _split_shards(self) -> None:
        """Live 4->5 reshard: start the new shard, migrate every moving
        key under the epoch fence (import-before-drop), then re-point
        every client at the new topology."""
        old = list(self.shard_addrs)
        new_srv = self._make_shard(len(self.shards))
        self.shards.append(new_srv)
        self.shard_addrs.append(new_srv.address)
        stats = ShardCoordinator().reshard(old, self.shard_addrs)
        self.shard_facts["split_moved_keys"] = stats["moved_keys"]
        for kube in self.kubes.values():
            kube.apply_topology(self.shard_addrs)
        if self.merged_reader is not None:
            self.merged_reader.apply_topology(self.shard_addrs)

    def _merged_kube(self):
        """The digest's view of authoritative truth: in the sharded
        scenario, the union of every shard's store (key spaces are
        disjoint by ownership), duck-typing the digest's KubeStore
        surface."""
        if not self.sharded:
            return self.primary.store.kube
        merged: Dict[str, dict] = {
            attr: {} for attr in ("pods", "nodes", "node_claims", "node_pools")
        }
        for srv in self.shards:
            with srv.store.lock:
                for attr, into in merged.items():
                    into.update(getattr(srv.store.kube, attr))
        ns = SimpleNamespace(**merged)
        ns.pending_pods = lambda: [
            p
            for p in ns.pods.values()
            if p.phase == "Pending" and not p.node_name
        ]
        return ns

    def _instrument_launches(self, op: Operator, name: str) -> None:
        orig = op.cloud_provider.create

        def create(claim, _orig=orig, _name=name):
            self.launches.append((self.tick_no, _name, claim.name))
            return _orig(claim)

        op.cloud_provider.create = create

    def _sync(self, note: str) -> None:
        for name, kube in self.kubes.items():
            if not kube.wait_synced(timeout=15.0):
                raise AssertionError(
                    f"mirror {name} failed to sync ({note}): "
                    f"synced_rv={kube.synced_rv} "
                    f"server_rv={self.primary.store.rv}"
                )
        if self.sharded:
            # a sharded mirror's dict INSERTION order is arrival order
            # across N watch streams — wall-clock nondeterministic even
            # though the content is fully synced.  The controllers
            # iterate those dicts, so decision order (and with it the
            # byte-compared trace) would leak thread pacing: re-sort
            # every mirror to key order at each barrier.  Content is
            # untouched; this is the sharded analogue of the single
            # stream's commit-order insertion.
            for kube in self.kubes.values():
                with kube._mirror_lock:
                    for attr in (
                        "pods",
                        "nodes",
                        "node_claims",
                        "node_pools",
                        "storage_classes",
                    ):
                        d = getattr(kube, attr)
                        for key in sorted(d):
                            d[key] = d.pop(key)

    def _violation(self, msg: str) -> None:
        self.violations.append(f"tick {self.tick_no}: {msg}")

    def _kubelet(self) -> None:
        """FakeKubelet over the shared store: register Nodes for running
        instances, bind pods the CURRENT leader nominated (a deposed
        replica's in-memory nominations are inert)."""
        kube = self.kubes[self.names[0]]
        now = self.clock.now()
        for claim in list(kube.node_claims.values()):
            if not claim.provider_id or claim.deleted_at is not None:
                continue
            inst = self.cloud.instances.get(claim.provider_id)
            if inst is None or inst.state != "running":
                continue
            if kube.node_by_provider_id(claim.provider_id) is not None:
                continue
            labels = dict(claim.labels)
            labels[L.LABEL_HOSTNAME] = claim.name
            kube.put_node(
                Node(
                    name=claim.name,
                    provider_id=claim.provider_id,
                    labels=labels,
                    taints=list(claim.taints),
                    capacity=claim.capacity,
                    allocatable=claim.allocatable,
                    ready=True,
                    created_at=now,
                )
            )
        ordered = sorted(
            self.ops.items(), key=lambda kv: not kv[1].elector.leading
        )
        for pod in list(kube.pods.values()):
            if pod.node_name or pod.phase != "Pending":
                continue
            for _name, op in ordered:
                target = op.cluster.nominated_node(pod.key())
                if target is None:
                    continue
                node = kube.nodes.get(target)
                if node is None or not node.ready or node.cordoned:
                    continue
                if not tolerates_all(pod.tolerations, node.taints):
                    continue
                kube.bind_pod(pod.key(), node.name)
                op.cluster.clear_nomination(pod.key())
                break

    # ------------------------------------------------------------- events
    def _generate_events(self, tick: int) -> List[Tuple[str, dict]]:
        """Seeded workload + the scripted failover storm — every choice
        RESOLVED here and recorded, so replay never consults an rng."""
        rng = self._gen_rng
        events: List[Tuple[str, dict]] = []
        r = rng.random()
        if r < 0.5:
            events.append(
                ("pod_create", {"cpu": rng.choice([0.5, 1, 2])})
            )
        elif r < 0.6 and self.live_pods:
            victim = self.live_pods[
                rng.randrange(len(self.live_pods))
            ]
            events.append(("pod_delete", {"key": victim.key()}))
        elif r < 0.67:
            running = sorted(
                i.id
                for i in self.cloud.instances.values()
                if i.state == "running"
            )
            if running:
                events.append(
                    ("instance_kill", {"id": rng.choice(running)})
                )

        leader = next(
            (n for n, op in self.ops.items() if op.elector.leading), None
        )

        def at(frac: float) -> bool:
            return tick == int(self.ticks * frac)

        if at(_CRASH_A) and leader is not None:
            events.append(("op_crash", {"replica": leader}))
        if at(_REJOIN_A):
            events.append(("op_rejoin", {"replica": ""}))
        if at(_RELEASE) and leader is not None:
            events.append(("op_release", {"replica": leader}))
        if at(_CRASH_B) and leader is not None:
            events.append(("op_crash", {"replica": leader}))
        if at(_REJOIN_B):
            events.append(("op_rejoin", {"replica": ""}))

        if self.sharded:
            # the shard storm rides ON TOP of the failover storm; every
            # choice (victim shard, fault kind, faulted operator) is
            # resolved here and recorded, like all chaos decisions.
            # Kills never target shard 0: it owns the Leases and feeds
            # the read replica — both pinned by design.
            from karpenter_tpu_torch.sim.faults import WIRE_FAULTS

            if at(_SHARD_KILL_A) or at(_SHARD_KILL_B):
                events.append(
                    (
                        "shard_kill",
                        {"shard": rng.randrange(1, len(self.shards))},
                    )
                )
            if at(_WIRE_FAULT_A) or at(_WIRE_FAULT_B):
                events.append(
                    (
                        "wire_fault",
                        {
                            "fault": rng.choice(sorted(WIRE_FAULTS)),
                            "op": rng.choice(self.names),
                        },
                    )
                )
            if at(_SHARD_SPLIT):
                events.append(("shard_split", {}))
            if at(_FSYNC_FAIL):
                events.append(
                    (
                        "fsync_fail",
                        {"shard": rng.randrange(len(self.shards))},
                    )
                )
        return events

    def _apply_event(self, kind: str, data: dict) -> None:
        kube = self.kubes[self.names[0]]
        if kind == "pod_create":
            pod = Pod(
                requests=Resources(cpu=data["cpu"], memory="1Gi")
            )
            kube.put_pod(pod)
            self.live_pods.append(pod)
        elif kind == "pod_delete":
            key = data["key"]
            self.live_pods = [
                p for p in self.live_pods if p.key() != key
            ]
            if key in kube.pods:
                kube.delete_pod(key)
        elif kind == "instance_kill":
            if data["id"] in self.cloud.instances:
                self.cloud.terminate_instances([data["id"]])
        elif kind == "op_crash":
            self.crashed.add(data["replica"])
            self.failover_ticks.add(self.tick_no)
        elif kind == "op_rejoin":
            self.crashed.clear()
        elif kind == "op_release":
            self.release_pending.add(data["replica"])
            self.failover_ticks.add(self.tick_no)
        elif kind == "shard_kill":
            self._kill_restart_shard(int(data["shard"]))
        elif kind == "shard_split":
            self._split_shards()
        elif kind == "wire_fault":
            # poison the op's LAST channel (never the lease shard): the
            # next RPC through it must classify the torn bytes as
            # reconnect-worthy and heal on retry
            self._injector.inject(
                self.kubes[data["op"]]._channels[-1], data["fault"]
            )
        elif kind == "fsync_fail":
            self._fsyncs[int(data["shard"])].arm()

    # --------------------------------------------------------------- tick
    def _tick(
        self,
        tick: int,
        events: List[Tuple[str, dict]],
        phase: str = "run",
    ) -> None:
        self.tick_no = tick
        self.trace.tick_start(tick, TICK_S, phase)
        for kind, data in events:
            self.trace.event(tick, kind, data)
            self._apply_event(kind, data)

        self.clock.step(TICK_S)
        # while a crashed leader holds the lease, push toward expiry so
        # the standby takes over inside the crash window
        if self.crashed and any(
            self.ops[n].elector.leading for n in self.crashed
        ):
            self.clock.step(LEASE_DURATION_S / 3 + 1)
        self._sync(f"tick {tick} pre-kubelet")
        self._kubelet()
        self._sync(f"tick {tick} post-kubelet")

        writers: List[str] = []
        noms_added: Dict[str, set] = {}
        # deterministic rotation of the reconcile order: after a crash
        # or release, WHICH standby acquires next depends on who ticks
        # first — rotating spreads leadership across the whole fleet
        # over the storm (replay-safe: a pure function of the tick)
        pivot = tick % len(self.names)
        for name in self.names[pivot:] + self.names[:pivot]:
            if name in self.crashed:
                continue
            op = self.ops[name]
            before = set(op.cluster._nominations)
            op.reconcile_once()
            if op.elector.leading:
                writers.append(name)
            added = set(op.cluster._nominations) - before
            if added:
                noms_added[name] = added
            if name in self.release_pending:
                # graceful handoff: the leader frees the Lease at the
                # end of its tick (the SIGTERM path); the next replica
                # acquires on ITS next tick
                op.elector.release()
                self.release_pending.discard(name)

        self.writers_by_tick[tick] = writers
        if len(writers) > 1 and tick not in self.failover_ticks:
            self._violation(f"multiple writers outside failover: {writers}")
        if len(noms_added) > 1 and tick not in self.failover_ticks:
            # across a scripted handoff, the OUTGOING leader's full tick
            # already nominated before the incoming one reconciled — the
            # same benign re-nomination two consecutive ticks produce;
            # the claim-level no-double-launch invariant still holds
            # unconditionally (checked at the end)
            seen: set = set()
            for name, keys in noms_added.items():
                if seen & keys:
                    self._violation(
                        f"duplicate nominations across writers: {name}"
                    )
                seen |= keys
        leader = next(
            (n for n, op in self.ops.items() if op.elector.leading), ""
        )
        if not self.leader_history or self.leader_history[-1] != leader:
            self.leader_history.append(leader)

        self._sync(f"tick {tick} post-ticks")
        self._kubelet()
        self._sync(f"tick {tick} final")
        self._drain_ledgers(tick)
        self._digest(tick, leader)

    def _drain_ledgers(self, tick: int) -> None:
        for name in self.names:
            op = self.ops[name]
            for led in op.ledger.drain(self._led_seqs[name]):
                self._led_seqs[name] = led.seq
                if led.type == "StoreResync":
                    # resyncs depend on wall-clock thread pacing (a
                    # transient socket hiccup heals through one); like
                    # anomaly events they stay out of byte-compared
                    # surfaces
                    continue
                self.trace.fleet_led(tick, name, led)

    def _digest(self, tick: int, leader: str) -> None:
        env = SimpleNamespace(
            kube=self._merged_kube(), cloud=self.cloud, clock=self.clock
        )
        self.trace.digest(tick, env)
        h = hashlib.sha256()
        for rnd, name, claim in self.launches:
            h.update(f"{rnd}/{name}/{claim};".encode())
        self.trace.fleet_tick(
            tick,
            leader,
            self.writers_by_tick.get(tick, []),
            len(self.launches),
            h.hexdigest()[:16],
        )

    # ---------------------------------------------------------------- run
    def run(self) -> dict:
        try:
            self.trace.fleet_meta(
                self.scenario, self.seed, self.ticks, self.n_operators
            )
            for tick in range(self.ticks):
                self.tick_no = tick
                events = (
                    list(self.tape.get(tick, ()))
                    if self.tape is not None
                    else self._generate_events(tick)
                )
                self._tick(tick, events)
            # settle re-derives from state in run AND replay (not on the
            # tape), exactly like the single-operator runner's drain
            self.crashed.clear()
            self._settle()
            report = self._report()
            self.trace.report(report)
            return report
        finally:
            self.close()

    def _settle(self) -> None:
        kube = self.kubes[self.names[0]]
        for i in range(SETTLE_MAX_ROUNDS):
            if not kube.pending_pods():
                break
            self._tick(self.ticks + i, [], phase="settle")

    def _report(self) -> dict:
        kube = self.kubes[self.names[0]]
        if kube.pending_pods():
            self._violation("pods still pending after settle")
        names = [c for _, _, c in self.launches]
        doubles = sorted(
            {c for c in names if names.count(c) > 1}
        )
        if doubles:
            self._violation(f"double-launched claims: {doubles}")
        live_claims = {
            c.provider_id
            for c in kube.node_claims.values()
            if c.deleted_at is None and c.provider_id
        }
        running = {
            i.id
            for i in self.cloud.instances.values()
            if i.state == "running"
        }
        if not live_claims <= running:
            self._violation(
                f"claims without instances: {sorted(live_claims - running)}"
            )
        replicas_led = sorted({n for _, n, _ in self.launches})
        for name, op in self.ops.items():
            if not op.kube.wait_synced(timeout=15.0):
                self._violation(f"mirror {name} never converged")

        # --- read-replica convergence with the primary's rv ordering.
        # This wait is genuinely wall-clock (real follower threads over
        # real sockets), so it paces on a real Clock — only the OUTCOME
        # booleans enter the byte-compared report, and they are
        # convergence facts, not timings.
        from karpenter_tpu_torch.utils.clock import Clock

        wall = Clock()
        replica_synced = False
        rv_equal = False
        reader_synced = False
        deadline = wall.now() + 15.0
        while wall.now() < deadline:
            with self.primary.store.lock:
                p_rv = self.primary.store.rv
            if (
                self.replica.store.rv >= p_rv
                and self.reader.synced_rv >= p_rv
            ):
                break
            wall.sleep(0.02)
        with self.primary.store.lock, self.replica.store.lock:
            replica_synced = self.replica.store.rv == self.primary.store.rv
            # rv ordering compared over the keys the primary SERVES: a
            # snapshot resync carries no delete tombstones, so a
            # follower that had to snapshot mid-run legitimately lacks
            # rv entries for long-gone keys
            from karpenter_tpu_torch.state.wire import STORE_KINDS

            present = {
                (kind, key)
                for kind, (_c, attr, _k) in STORE_KINDS.items()
                for key in getattr(self.primary.store.kube, attr)
            }
            rv_equal = all(
                self.replica.store.rvs.get(kk)
                == self.primary.store.rvs.get(kk)
                for kk in present
            )
            p_state = {
                attr: {
                    k: canonical(v)
                    for k, v in getattr(
                        self.primary.store.kube, attr
                    ).items()
                }
                for attr in ("pods", "nodes", "node_claims", "node_pools")
            }
            r_state = {
                attr: {
                    k: canonical(v)
                    for k, v in getattr(
                        self.replica.store.kube, attr
                    ).items()
                }
                for attr in ("pods", "nodes", "node_claims", "node_pools")
            }
            replica_synced = replica_synced and p_state == r_state
        reader_synced = all(
            canonical(self.reader.pods[k]) == canonical(v)
            for k, v in self.primary.store.kube.pods.items()
            if k in self.reader.pods
        ) and set(self.reader.pods) == set(self.primary.store.kube.pods)
        if not (replica_synced and rv_equal):
            self._violation("read replica diverged from the primary")
        if not reader_synced:
            self._violation("replica reader mirror diverged")

        merged_reader_synced = True
        if self.sharded and self.merged_reader is not None:
            # the merged-stream mirror must converge on the UNION of all
            # shards — proving the per-channel cursors never dropped or
            # cross-credited a shard's events through kills, splits, and
            # wire faults
            deadline = wall.now() + 15.0
            merged_reader_synced = False
            while wall.now() < deadline:
                mk = self._merged_kube()
                if set(self.merged_reader.pods) == set(mk.pods) and set(
                    self.merged_reader.nodes
                ) == set(mk.nodes):
                    merged_reader_synced = all(
                        canonical(self.merged_reader.pods[k])
                        == canonical(v)
                        for k, v in mk.pods.items()
                    )
                    if merged_reader_synced:
                        break
                wall.sleep(0.02)
            if not merged_reader_synced:
                self._violation("merged shard reader diverged")

        store = self.primary.store
        compactions = self.primary.registry.counter(
            "karpenter_store_compactions_total", {"log": "replay"}
        )
        shards_section = None
        if self.sharded:
            if not self.shard_facts["epoch_preserved"]:
                self._violation("restarted shard lost its epoch")
            if int(self.shard_facts["snapshot_fallbacks"]) > 0:
                self._violation(
                    "restarted shard fell back to snapshot resync"
                )
            if float(self.shard_facts["delta_ratio_max"]) >= 0.1:
                self._violation(
                    "post-restart delta resync not < 10% of snapshot"
                )
            shards_section = {
                "n": len(self.shards),
                **self.shard_facts,
                "wire_faults": dict(sorted(self._injector.injected.items())),
                "fsync_failures": sum(f.failures for f in self._fsyncs),
                "merged_reader_synced": merged_reader_synced,
            }
        solver_section = None
        if self.solver_fleet and self.solver is not None:
            payload = self.solver.tenants_payload()
            tenants = payload["tenants"]
            # only DETERMINISTIC facts enter the byte-compared report:
            # per-tenant solve tallies (a pure function of the tape),
            # never wall-clock timestamps or wait histograms
            solver_section = {
                "multi_tenant": payload["multi_tenant"],
                "tenants": sorted(tenants),
                "solves_by_tenant": {
                    t: tenants[t]["solves"] for t in sorted(tenants)
                },
                "refused": sum(t["refused"] for t in tenants.values()),
            }
            if solver_section["refused"]:
                self._violation(
                    "solver service refused a tenant in a sequential fleet"
                )
            if not solver_section["tenants"]:
                self._violation("no tenant ever solved remotely")
        report = {
            "scenario": self.scenario,
            "seed": self.seed,
            "ticks": self.ticks,
            "operators": self.n_operators,
            "launches": len(self.launches),
            "double_launches": len(doubles),
            "replicas_led": replicas_led,
            "leader_transitions": max(0, len(self.leader_history) - 1),
            "writers_max_per_tick": max(
                (len(w) for w in self.writers_by_tick.values()), default=0
            ),
            "store": {
                "codec": sorted(
                    {k._sock_codec for k in self.kubes.values()}
                ),
                "rv": store.rv,
                "seq": store.log_seq,
                "replay_log_compactions": int(compactions),
                "slow_watcher_overflowed": self.sink.overflows >= 1,
            },
            "replica": {
                "synced": replica_synced,
                "rv_ordering_preserved": rv_equal,
                "reader_synced": reader_synced,
            },
            "invariants": {"violations": self.violations},
        }
        if shards_section is not None:
            report["shards"] = shards_section
        if solver_section is not None:
            report["solver"] = solver_section
        return report

    def close(self) -> None:
        self._pace_stop.set()
        for client in self._solver_clients:
            client.close()
        if self.solver is not None:
            self.solver.stop()
        for kube in self.kubes.values():
            kube.close()
        self.reader.close()
        if self.merged_reader is not None:
            self.merged_reader.close()
        self.replica.stop()
        if self.sharded:
            for srv in self.shards:
                srv.stop()
            shutil.rmtree(self._log_dir, ignore_errors=True)
        else:
            self.primary.stop()
        self.trace.close()


# ------------------------------------------------------------------ entry
def run_fleet(
    scenario: str,
    seed: int,
    ticks: int,
    trace: Optional[_FleetTrace] = None,
    operators: int = 3,
    device=None,
) -> Tuple[FleetRunner, dict]:
    runner = FleetRunner(
        scenario,
        seed,
        ticks,
        operators=operators,
        trace=trace or _FleetTrace(),
        device=device,
    )
    report = runner.run()
    return runner, report


def read_fleet_tape(
    path: str,
) -> Tuple[dict, Dict[int, List[Tuple[str, dict]]], Optional[dict]]:
    meta: Optional[dict] = None
    tape: Dict[int, List[Tuple[str, dict]]] = {}
    report: Optional[dict] = None
    for line in read_trace(path):
        t = line.get("t")
        if t == "meta":
            meta = line
        elif t == "ev":
            tape.setdefault(line["tick"], []).append(
                (line["kind"], line["data"])
            )
        elif t == "report":
            report = line["slo"]
    if meta is None or not meta.get("fleet"):
        raise ValueError(f"not a fleet trace (no fleet meta line): {path}")
    return meta, tape, report


def replay_fleet(
    path: str, trace: Optional[_FleetTrace] = None, device=None
) -> Tuple[FleetRunner, dict, Optional[dict]]:
    meta, tape, recorded = read_fleet_tape(path)
    runner = FleetRunner(
        meta["scenario"],
        meta["seed"],
        meta["ticks"],
        operators=meta.get("operators", 3),
        trace=trace or _FleetTrace(),
        tape=tape,
        device=device,
    )
    report = runner.run()
    return runner, report, recorded
