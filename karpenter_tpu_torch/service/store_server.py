"""Shared cluster-store server: one durable KubeStore, a fleet of clients.

The reference gets HA for free because durable state lives in the
kube-apiserver and the election Lease is a shared coordination/v1 object;
each controller replica is a thin client.  This server is that apiserver
analogue for the simulation backend: it owns ONE durable `KubeStore`
(wrapped in `VersionedStore` for resourceVersion bookkeeping) and serves
it over the same length-prefixed socket protocol as the solver sidecar
(service/codec.py), which makes 2-replica HA real; the fleet-scale store
plane (docs/designs/store-scale.md) makes the same server hold up under
thousands of objects feeding many controllers:

- **Negotiated payload codec**: every connection starts as tagged JSON;
  a ``hello`` (RPC) or ``codecs`` list (watch) negotiates the compact
  binary codec ``bin1`` (state/binwire.py) when both ends share the
  schema fingerprint.  An old endpoint that knows neither negotiates
  down to JSON transparently.
- **Delta watch resync**: every broadcast batch gets a monotonic
  ``seq`` and lands in a bounded replay log; a reconnecting watcher
  presents ``since_seq`` and receives only the events it missed,
  falling back to a full snapshot when compaction has passed its seq.
- **Backpressured fan-out**: per-subscriber queues are BOUNDED; a slow
  client's overflow coalesces into one forced-resync marker (replay or
  snapshot on its own stream) instead of growing server memory or
  head-of-line blocking the fast clients.
- **Compaction**: the replay log and the durable cluster-event ledger
  are both capped; trims count into
  ``karpenter_store_compactions_total{log}``.
- **Read replicas**: ``replica_of=(host, port)`` makes this server
  follow a primary over the same watch protocol and serve
  snapshot/watch read traffic with the primary's rv ordering preserved;
  every write method refuses (the leader's CAS space stays
  authoritative on the primary).

Methods (headers ride the negotiated codec; no array blobs):

- ``ping`` / ``stat``                liveness, {rv, seq, event_count}
- ``hello`` {codecs, schema_fp}      payload-codec negotiation
- ``put``    {kind, obj, base_rv}    optimistic-concurrency write
- ``delete`` {kind, key, base_rv}    delete (cascades run server-side)
- ``bind_pod`` / ``evict_pod``       semantic pod verbs (base_rv-fenced)
- ``record_event``                   append a store event
- ``lease_acquire`` / ``lease_renew`` / ``lease_release``
                                     the coordination/v1 Lease CAS
                                     surface, atomic server-side
- ``watch``  {identity, codecs, since_seq}
                                     long-lived: codec ack, then a
                                     ``resync`` frame (snapshot or
                                     replayed events), then pushed
                                     ``events`` frames as mutations land

Every mutation is assigned a monotonically increasing resourceVersion;
``put`` with a stale ``base_rv`` returns ``status: conflict`` with the
current object so the writer can resync instead of clobbering — the
single-writer invariant for competing replicas comes from the Lease, the
rv check fences the deposed leader's stragglers.
"""

from __future__ import annotations

import logging
import os
import socket
import socketserver
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.obs.context import trace_context
from karpenter_tpu_torch.obs.events import EventLedger
from karpenter_tpu_torch.analysis.sanitizer import (
    make_condition,
    make_lock,
    make_rlock,
    note_access,
)
from karpenter_tpu_torch.service.codec import (
    CODEC_BIN,
    CODEC_JSON,
    decode_payload,
    encode_payload,
    recv_frame,
    send_frame,
)
from karpenter_tpu_torch.service.shardrouter import shard_of
from karpenter_tpu_torch.service.watchclient import WatchChannelClient
from karpenter_tpu_torch.state.binwire import (
    Raw,
    SCHEMA_FP,
    decode_value,
    encode_value,
)
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.state.storelog import DurableReplayLog, FSYNC_ALWAYS
from karpenter_tpu_torch.state.wire import STORE_KINDS, materialize, to_wire
from karpenter_tpu_torch.utils.trace import Tracer

log = logging.getLogger(__name__)

# bounded-plane defaults, overridable per server (and via the chart's
# store.* values -> main() flags)
REPLAY_LOG_EVENTS = 4096  # events retained for delta resync
WATCH_QUEUE_BATCHES = 256  # per-subscriber queued batches before resync
EVENTS_CAP = 4096  # durable cluster-event ledger bound

_WRITE_METHODS = frozenset(
    {
        "put", "delete", "bind_pod", "evict_pod", "record_event",
        "lease_acquire", "lease_renew", "lease_release",
        "shard_import", "shard_drop",
    }
)


class _Batch:
    """One broadcast unit: the events of one mutation, their seq, and
    the per-codec renderings.  Commit renders ONLY the forms someone
    currently needs (the originator's codec, the live subscribers'
    codecs) — an all-binary plane never builds a JSON tree, and vice
    versa.  Either form is an immutable rv-stamped snapshot of the
    mutation, so the missing one derives lazily from the other (replay
    to a late client of the other codec) without touching live objects
    or the store lock."""

    __slots__ = ("seq", "metas", "_json", "_bins", "_bin_frame")

    def __init__(
        self,
        seq: int,
        metas: List[dict],
        json_events: Optional[List[dict]] = None,
        bin_events: Optional[List[Raw]] = None,
    ):
        self.seq = seq
        self.metas = metas  # rv/kind/verb/key (no payloads)
        self._json = json_events
        self._bins = bin_events
        self._bin_frame: Optional[bytes] = None

    @property
    def max_rv(self) -> int:
        return max((m.get("rv", 0) for m in self.metas), default=0)

    def json_events(self) -> List[dict]:
        if self._json is None:
            out = []
            for raw in self._bins:  # type: ignore[union-attr]
                ev = decode_value(raw.data)
                if "event" in ev:
                    ev["event"] = to_wire(ev["event"])
                elif ev.get("obj") is not None:
                    ev["obj"] = to_wire(ev["obj"])
                out.append(ev)
            self._json = out
        return self._json

    def bin_events(self) -> List[Raw]:
        if self._bins is None:
            out = []
            for ev in self._json:  # type: ignore[union-attr]
                native = dict(ev)
                if "event" in ev:
                    native["event"] = materialize(ev["event"])
                elif ev.get("obj") is not None:
                    native["obj"] = materialize(ev["obj"])
                out.append(Raw(encode_value(native)))
            self._bins = out
        return self._bins

    def events_for(self, codec: str) -> List[object]:
        return (
            list(self.bin_events())
            if codec == CODEC_BIN
            else list(self.json_events())
        )

    def bin_frame_payload(self) -> bytes:
        """The fully-encoded single-batch ``events`` frame, rendered
        once and shipped VERBATIM to every bin subscriber — a designed
        property of the binary protocol: frames are content-addressed
        by seq, so fan-out is a byte copy per connection, not a
        re-serialization (the tagged-JSON path keeps its original
        per-connection rendering — it is the compatibility baseline the
        bench line compares against)."""
        if self._bin_frame is None:
            self._bin_frame = encode_payload(
                {
                    "type": "events",
                    "seq": self.seq,
                    "events": self.bin_events(),
                },
                CODEC_BIN,
            )
        return self._bin_frame


class _Subscriber:
    """A watch client's bounded queue.  ``cond`` shares the store lock:
    offers happen inside ``mutate`` (lock already held), the sender
    thread waits on it and drains outside the lock.  Overflow clears the
    queue and raises the ``pending_resync`` flag — the sender coalesces
    everything the client missed into one resync frame."""

    def __init__(self, identity: str, codec: str, cap: int, lock):
        self.identity = identity
        self.codec = codec
        self.cap = max(1, cap)
        self.cond = make_condition("_Subscriber.cond", lock)
        self.batches: Deque[_Batch] = deque()
        self.delivered_seq = 0
        self.pending_resync = False
        # why the pending resync was forced: "overflow" (this
        # subscriber's bounded queue filled) or "epoch" (the store's
        # continuity broke under it, e.g. a replica's full resync from
        # its primary) — keeps the slow-client metric signal clean
        self.forced_reason = "overflow"
        self.overflows = 0
        self.closed = False

    def offer(self, batch: _Batch) -> None:
        # store lock held by the caller (mutate/commit)
        note_access("_Subscriber.batches")  # lockset witness
        if self.pending_resync:
            return  # already coalesced; the resync frame covers this too
        if len(self.batches) >= self.cap:
            self.batches.clear()
            self.pending_resync = True
            self.forced_reason = "overflow"
            self.overflows += 1
        else:
            self.batches.append(batch)
        self.cond.notify_all()

    def close(self) -> None:
        self.closed = True
        self.cond.notify_all()


class VersionedStore:
    """A KubeStore plus resourceVersion bookkeeping, the seq'd replay
    log, and the backpressured watch broadcast.

    Survives server restarts: constructing a new `StoreServer` over the
    same `VersionedStore` keeps the objects, their rvs, AND the replay
    log, so reconnecting clients delta-resync across the restart (the
    durable half of the store lives here, the serving half in
    `StoreServer`)."""

    def __init__(
        self,
        kube: Optional[KubeStore] = None,
        replay_log_events: int = REPLAY_LOG_EVENTS,
        watch_queue_batches: int = WATCH_QUEUE_BATCHES,
        events_cap: int = EVENTS_CAP,
        durable_log: Optional[DurableReplayLog] = None,
    ):
        self.kube = kube or KubeStore()
        self.lock = make_rlock("VersionedStore.lock")
        self.rv = 0
        self.rvs: Dict[Tuple[str, str], int] = {}
        # per-lease CAS sequence, SEPARATE from the broadcast rv space:
        # silent renewals (no watch event) must not advance `rv`, or
        # other clients could never sync up to the stat rv
        self.lease_seq: Dict[str, int] = {}
        self.event_rv = 0
        self.replay_log_events = replay_log_events
        self.watch_queue_batches = watch_queue_batches
        self.events_cap = events_cap
        # the replay log: recent batches by seq.  `compacted_seq` is the
        # seq of the last batch compaction dropped — a reconnect with
        # since_seq >= compacted_seq replays, anything older snapshots.
        # `epoch` names THIS store's seq space: a fresh VersionedStore
        # (store restart without the durable object) is a new epoch, and
        # a cursor from another epoch must never claim coverage — the
        # new space's seq could have OVERTAKEN the stale cursor, making
        # a bare number look covered while silently skipping the
        # inter-epoch divergence.  Random, but never enters any
        # byte-compared surface (it rides the watch handshake only).
        self.epoch = os.urandom(8).hex()
        self.log_seq = 0
        self.compacted_seq = 0
        self.replay_log: Deque[_Batch] = deque()
        self._log_events = 0
        self.registry = Registry()  # re-bound by the owning StoreServer
        self._subscribers: List[_Subscriber] = []
        self._recorded: List[dict] = []
        self._rec_objs: List[object] = []
        self.kube.watch(self._record)
        # the crash-durable half (state/storelog.py): every commit
        # appends its bin-rendered batch; construction RECOVERS the
        # previous incarnation's state — objects, rvs, lease CAS seqs,
        # epoch, and the replay-log tail — so a restarted store serves
        # DELTA resyncs from disk instead of forcing a snapshot storm
        self.durable_log = durable_log
        if durable_log is not None:
            self._recover_from_log()

    # ------------------------------------------------------------ durability
    def _recover_from_log(self) -> None:
        """Adopt the durable segment's state: checkpoint snapshot first
        (objects + rvs verbatim — NO re-commit, these mutations already
        broadcast in the previous life), then the batch tail, which also
        repopulates the in-memory replay log so pre-restart watch
        cursors stay covered.  Re-adopting the previous EPOCH is the
        point: a recovered store is a continuation of the same seq
        space, not a new one.  A fresh segment writes a genesis
        checkpoint so even the first incarnation's epoch survives."""
        dlog = self.durable_log
        checkpoint, batches = dlog.recover()
        if checkpoint is None and not batches:
            with self.lock:
                self._checkpoint_locked()
            return
        with self.lock:
            if checkpoint is not None:
                snap = checkpoint.get("snapshot") or {}
                self.rvs = {}
                for kind, (_cls, attr, _key_fn) in STORE_KINDS.items():
                    store_dict = getattr(self.kube, attr)
                    store_dict.clear()
                    for key, entry in snap.get("kinds", {}).get(
                        kind, {}
                    ).items():
                        store_dict[key] = materialize(entry["obj"])
                        self.rvs[(kind, key)] = entry["rv"]
                self.rv = checkpoint.get("rv", 0)
                self.event_rv = checkpoint.get("event_rv", 0)
                self.lease_seq = dict(checkpoint.get("lease_seq", {}))
                self.kube.events = [
                    materialize(e)
                    for e in snap.get("events", [])[-self.events_cap:]
                ]
                self.epoch = str(checkpoint.get("epoch") or self.epoch)
                self.log_seq = checkpoint.get("seq", 0)
                self.compacted_seq = self.log_seq
            for rec in batches:
                metas: List[dict] = []
                bins: List[Raw] = []
                for ev in rec.get("events", ()):
                    meta = self._recover_event(ev)
                    if meta is None:
                        continue
                    metas.append(meta)
                    bins.append(Raw(encode_value(ev)))
                batch = _Batch(rec["seq"], metas, None, bins)
                self.replay_log.append(batch)
                self._log_events += len(metas)
                self.log_seq = rec["seq"]
                self.epoch = str(rec.get("epoch") or self.epoch)
            # the in-memory bound still applies to the recovered tail:
            # compaction advances compacted_seq exactly as _commit does
            while (
                self._log_events > self.replay_log_events
                and len(self.replay_log) > 1
            ):
                dropped = self.replay_log.popleft()
                self._log_events -= len(dropped.metas)
                self.compacted_seq = dropped.seq
            dlog.batches_since_checkpoint = len(batches)

    def _recover_event(self, ev) -> Optional[dict]:
        """Apply one recovered batch event to the kube dicts (verbatim,
        like apply_replicated — cascades already materialized in the
        recorded stream).  Returns the event's meta, or None for an
        unrecognized kind (a segment from a newer build)."""
        if not isinstance(ev, dict):
            return None
        if ev.get("kind") == "Event":
            tup = materialize(ev.get("event"))
            if ev.get("event_rv", 0) > self.event_rv:
                self.event_rv = ev["event_rv"]
                self.kube.events.append(tup)
                self._trim_events_locked()
            return {
                "kind": "Event",
                "verb": "append",
                "event_rv": ev.get("event_rv", 0),
            }
        spec = STORE_KINDS.get(ev.get("kind"))
        if spec is None:
            return None
        _cls, attr, _key_fn = spec
        key, rv = ev["key"], ev["rv"]
        store_dict = getattr(self.kube, attr)
        if ev["verb"] == "delete":
            store_dict.pop(key, None)
        else:
            store_dict[key] = materialize(ev["obj"])
        self.rvs[(ev["kind"], key)] = rv
        self.rv = max(self.rv, rv)
        return {
            "rv": rv, "kind": ev["kind"], "verb": ev["verb"], "key": key,
        }

    def _checkpoint_locked(self) -> None:
        """Lock held: rewrite the durable segment as one checkpoint
        record.  The bin snapshot references live objects, so rendering
        must finish before the lock drops — same contract as
        serve_watch's bin resync."""
        self.durable_log.write_checkpoint(
            self.epoch,
            self.log_seq,
            self.rv,
            self.event_rv,
            self.lease_seq,
            self.snapshot(CODEC_BIN),
        )

    def rotate_epoch(self, reason: str = "migration") -> None:
        """Fence every outstanding cursor: new epoch id, replay log
        reset, every subscriber forced onto its own resync.  The
        migration primitive — after an import/drop changed what this
        shard owns, no cursor minted before the change may claim
        coverage across it (a replayed gap would silently miss the
        ownership delta).  Checkpoints the durable log so the NEW epoch
        is what a post-crash recovery re-adopts."""
        with self.lock:
            self.replay_log.clear()
            self._log_events = 0
            self.log_seq += 1
            self.compacted_seq = self.log_seq
            self.epoch = os.urandom(8).hex()
            self.registry.inc(
                "karpenter_store_epoch_rotations_total", {"reason": reason}
            )
            for sub in self._subscribers:
                if not sub.closed:
                    sub.batches.clear()
                    sub.pending_resync = True
                    sub.forced_reason = "epoch"
                    sub.cond.notify_all()
            if self.durable_log is not None:
                self._checkpoint_locked()

    # ------------------------------------------------------------ recording
    def _record(self, kind: str, verb: str, obj) -> None:
        """KubeStore notification hook: capture every mutation a verb
        application produced (bind_pod touches a Pod and maybe a PVC;
        delete_node re-pends its pods) as state-based events.  Only the
        meta + a live object reference are captured here; the payload
        renders once, per needed codec, at commit time under the same
        lock."""
        spec = STORE_KINDS.get(kind)
        if spec is None:
            return
        cls, attr, key_fn = spec
        key = key_fn(obj)
        self.rv += 1
        self.rvs[(kind, key)] = self.rv
        deleted = key not in getattr(self.kube, attr)
        self._recorded.append(
            {
                "rv": self.rv,
                "kind": kind,
                "verb": "delete" if deleted else "put",
                "key": key,
            }
        )
        self._rec_objs.append(None if deleted else obj)

    def mutate(
        self, fn, origin: str = "", origin_codec: str = CODEC_JSON
    ) -> Optional[_Batch]:
        """Run `fn()` (KubeStore verbs) under the lock; collect the
        resulting events, commit them to the replay log, broadcast to
        every subscriber except the originator, and return the batch
        (for the originator's RPC response, rendered in its codec)."""
        with self.lock:
            self._recorded = []
            self._rec_objs = []
            fn()
            metas, objs = self._recorded, self._rec_objs
            self._recorded, self._rec_objs = [], []
            if not metas:
                return None
            return self._commit(metas, objs, origin, origin_codec)

    def _commit(
        self,
        metas: List[dict],
        objs,
        origin: str,
        origin_codec: str = CODEC_JSON,
    ) -> _Batch:
        """Lock held: assign the batch its seq, render, log, broadcast,
        compact.  Live objects are touched ONLY here (they may mutate
        the moment the lock is released); every later consumer reads the
        immutable rendered forms.  Rendering is per-constituency: the
        originator's codec plus whatever the live subscribers speak —
        an all-binary plane never builds a JSON tree."""
        self.log_seq += 1
        # a durable log always needs the bin rendering: the disk record
        # IS the batch's bin events (rendered once here, under the lock
        # where live objects are safe, then reused by the watch fan-out)
        need_bin = (
            origin_codec == CODEC_BIN
            or self.durable_log is not None
            or any(
                s.codec == CODEC_BIN and not s.closed
                for s in self._subscribers
            )
        )
        need_json = origin_codec == CODEC_JSON or any(
            s.codec == CODEC_JSON and not s.closed for s in self._subscribers
        )
        json_events = None
        bin_events = None
        if need_json:
            json_events = []
            for meta, obj in zip(metas, objs):
                ev = dict(meta)
                if meta.get("kind") == "Event":
                    ev["event"] = to_wire(obj)
                else:
                    ev["obj"] = None if obj is None else to_wire(obj)
                json_events.append(ev)
        if need_bin:
            bin_events = []
            for meta, obj in zip(metas, objs):
                native = dict(meta)
                if meta.get("kind") == "Event":
                    native["event"] = obj
                else:
                    native["obj"] = obj
                bin_events.append(Raw(encode_value(native)))
        batch = _Batch(self.log_seq, metas, json_events, bin_events)
        note_access("VersionedStore.replay_log")  # lockset witness
        if self.durable_log is not None:
            self.durable_log.append_batch(
                self.log_seq, self.epoch, batch.bin_events()
            )
            if self.durable_log.checkpoint_due():
                self._checkpoint_locked()
        self.replay_log.append(batch)
        self._log_events += len(metas)
        while (
            self._log_events > self.replay_log_events
            and len(self.replay_log) > 1
        ):
            dropped = self.replay_log.popleft()
            self._log_events -= len(dropped.metas)
            self.compacted_seq = dropped.seq
            self.registry.inc(
                "karpenter_store_compactions_total", {"log": "replay"}
            )
        for sub in self._subscribers:
            if sub.identity != origin:
                sub.offer(batch)
        if self._subscribers:
            self.registry.set(
                "karpenter_store_watch_queue_depth",
                max(len(s.batches) for s in self._subscribers),
            )
        return batch

    def append_cluster_event(
        self,
        kind,
        reason,
        obj_name,
        message="",
        origin: str = "",
        origin_codec: str = CODEC_JSON,
    ) -> int:
        """The durable cluster-event ledger: append, broadcast, and keep
        the ledger bounded (the snapshot ships only what is retained).
        Returns the appended event's event_rv."""
        with self.lock:
            self.kube.record_event(kind, reason, obj_name, message)
            self.event_rv += 1
            tup = tuple(self.kube.events[-1])
            meta = {
                "kind": "Event",
                "verb": "append",
                "event_rv": self.event_rv,
            }
            self._commit([meta], [tup], origin, origin_codec)
            self._trim_events_locked()
            return self.event_rv

    def _trim_events_locked(self) -> None:
        if len(self.kube.events) > self.events_cap:
            del self.kube.events[: len(self.kube.events) - self.events_cap]
            self.registry.inc(
                "karpenter_store_compactions_total", {"log": "events"}
            )

    # ------------------------------------------------------------- snapshot
    def snapshot(self, codec: str = CODEC_JSON) -> dict:
        """Full-state snapshot in the given codec's object form (trees
        for JSON, native objects for bin — MUST be encoded under the
        lock in the bin case, the objects are live)."""
        native = codec == CODEC_BIN
        kinds: Dict[str, dict] = {}
        for kind, (_cls, attr, key_fn) in STORE_KINDS.items():
            kinds[kind] = {
                key_fn(obj): {
                    "rv": self.rvs.get((kind, key_fn(obj)), 0),
                    "obj": obj if native else to_wire(obj),
                }
                for obj in getattr(self.kube, attr).values()
            }
        return {
            "rv": self.rv,
            "seq": self.log_seq,
            "event_rv": self.event_rv,
            "kinds": kinds,
            "events": [
                tuple(e) if native else to_wire(tuple(e))
                for e in self.kube.events
            ],
        }

    def covers(self, since_seq: int, epoch: str = "") -> bool:
        """Whether the replay log can reconstruct everything after
        ``since_seq``.  The cursor must come from THIS epoch (seq spaces
        are per-VersionedStore; a stale cursor from a previous store's
        space proves nothing).  since_seq 0 means "from genesis" — only
        a log that never compacted AND started with this store's birth
        (seq 0) covers that, and a store handed a pre-populated
        KubeStore never does (its initial state predates the log)."""
        if epoch != self.epoch:
            return False
        if since_seq > self.log_seq or since_seq < self.compacted_seq:
            return False
        if since_seq == 0:
            # genesis replay is only complete when the log holds every
            # event since this store's birth — a store handed a
            # pre-populated KubeStore (durable restart) has state that
            # predates the log, so 0 must fall back to a snapshot
            return bool(self.replay_log) and self.replay_log[0].seq == 1
        return True

    def replay_since(self, since_seq: int) -> List[_Batch]:
        return [b for b in self.replay_log if b.seq > since_seq]

    def subscribe(
        self,
        identity: str,
        codec: str = CODEC_JSON,
        since_seq: Optional[int] = None,
        cap: Optional[int] = None,
        epoch: str = "",
    ) -> Tuple[str, object, "_Subscriber"]:
        """Atomically register + build the initial sync: returns
        (mode, payload, sub) where mode is "replay" (payload = batches
        to flatten) or "snapshot" (payload = snapshot dict).  Counting:
        a reconnect (since_seq > 0) counts into
        karpenter_store_resync_total{kind}.  ``cap`` overrides the
        server-wide per-subscriber queue bound (the fleet simulator
        wedges one sink with a tiny cap without touching the healthy
        subscribers')."""
        with self.lock:
            sub = _Subscriber(
                identity, codec, cap or self.watch_queue_batches, self.lock
            )
            since = since_seq or 0
            if since > 0 and self.covers(since, epoch):
                mode: str = "replay"
                payload: object = self.replay_since(since)
            else:
                mode = "snapshot"
                payload = self.snapshot(codec)
            if since > 0:
                self.registry.inc(
                    "karpenter_store_resync_total", {"kind": mode}
                )
            sub.delivered_seq = self.log_seq
            self._subscribers.append(sub)
            self.registry.set(
                "karpenter_store_watch_clients", len(self._subscribers)
            )
            return mode, payload, sub

    def unsubscribe(self, sub: _Subscriber) -> None:
        with self.lock:
            if sub in self._subscribers:
                self._subscribers.remove(sub)
            self.registry.set(
                "karpenter_store_watch_clients", len(self._subscribers)
            )

    # ----------------------------------------------------------- replication
    def apply_replicated(self, events: List[dict]) -> None:
        """Read-replica ingestion: apply the primary's events verbatim —
        (each commit gets a REPLICA-local seq: seq spaces are per-server,
        and the follower tracks the primary's cursor separately) —
        objects land in the kube dicts directly (the cascades already
        materialized in the primary's event stream) and keep the
        PRIMARY's rv numbers, so replica watchers observe the same rv
        ordering the primary's watchers do."""
        with self.lock:
            metas: List[dict] = []
            objs: List[object] = []
            for ev in events:
                if ev.get("kind") == "Event":
                    tup = materialize(ev["event"])
                    if ev.get("event_rv", 0) > self.event_rv:
                        self.event_rv = ev["event_rv"]
                        self.kube.events.append(tup)
                        self._trim_events_locked()
                    metas.append(
                        {
                            "kind": "Event",
                            "verb": "append",
                            "event_rv": ev.get("event_rv", 0),
                        }
                    )
                    objs.append(tup)
                    continue
                spec = STORE_KINDS.get(ev.get("kind"))
                if spec is None:
                    continue
                _cls, attr, _key_fn = spec
                key, rv = ev["key"], ev["rv"]
                store_dict = getattr(self.kube, attr)
                if ev["verb"] == "delete":
                    store_dict.pop(key, None)
                    obj = None
                else:
                    obj = materialize(ev["obj"])
                    store_dict[key] = obj
                self.rvs[(ev["kind"], key)] = rv
                self.rv = max(self.rv, rv)
                metas.append(
                    {
                        "rv": rv,
                        "kind": ev["kind"],
                        "verb": ev["verb"],
                        "key": key,
                    }
                )
                objs.append(obj)
            if metas:
                # replica mirror objects are replaced wholesale per
                # event (never mutated in place), so rendering from them
                # under this lock is exactly as safe as on the primary;
                # bin is the compact default when no one needs trees yet
                self._commit(metas, objs, origin="", origin_codec=CODEC_BIN)

    def apply_replicated_snapshot(self, snap: dict) -> None:
        """Full resync from the primary: adopt its state wholesale.  The
        local replay log's continuity is broken, so it resets and every
        replica watcher is forced onto its own resync path."""
        with self.lock:
            # rvs REPLACED wholesale alongside the objects: a snapshot
            # has no tombstones, so keeping old entries for keys the
            # primary deleted (or stale pre-delete rvs) would leave this
            # mirror's rv map permanently diverged from what it serves
            self.rvs = {}
            for kind, (_cls, attr, _key_fn) in STORE_KINDS.items():
                store_dict = getattr(self.kube, attr)
                store_dict.clear()
                for key, entry in snap["kinds"].get(kind, {}).items():
                    store_dict[key] = materialize(entry["obj"])
                    self.rvs[(kind, key)] = entry["rv"]
            # ASSIGNED like the rvs map above, never maxed: the primary
            # may have restarted into a fresh (lower) rv space, and a
            # replica reporting an inflated rv would make wait_synced
            # against it return before convergence
            self.rv = snap.get("rv", 0)
            self.event_rv = snap.get("event_rv", 0)
            # this replica's --events-cap is an invariant even when the
            # primary's ledger is larger: adopt only the newest tail
            self.kube.events = [
                materialize(e)
                for e in snap.get("events", [])[-self.events_cap :]
            ]
            self.replay_log.clear()
            self._log_events = 0
            self.log_seq += 1
            self.compacted_seq = self.log_seq
            # genuinely a NEW epoch: this mirror adopted a (possibly
            # lower) rv space wholesale, so its own watchers' cursors —
            # seq AND per-key rvs — are meaningless; rotating the epoch
            # id is what makes them find out and reset
            self.epoch = os.urandom(8).hex()
            for sub in self._subscribers:
                if not sub.closed:
                    sub.batches.clear()
                    sub.pending_resync = True
                    # NOT an overflow: the store's own continuity broke
                    sub.forced_reason = "epoch"
                    sub.cond.notify_all()

    # ------------------------------------------------------------- migration
    def export_entries(
        self, self_index: int, new_n: int
    ) -> Dict[str, List[dict]]:
        """Read-only migration scan: every key this shard holds whose
        owner under an ``new_n``-shard topology is NOT this shard,
        grouped by new owner (string keys — the groups ride a JSON
        control-plane frame).  Leases never export: they are pinned to
        ``LEASE_SHARD`` under every topology (service/shardrouter.py),
        so the leadership CAS space never migrates."""
        out: Dict[str, List[dict]] = {}
        with self.lock:
            for kind, (_cls, attr, key_fn) in STORE_KINDS.items():
                if kind == "Lease":
                    continue
                for key, obj in getattr(self.kube, attr).items():
                    owner = shard_of(kind, key, new_n)
                    if owner == self_index:
                        continue
                    out.setdefault(str(owner), []).append(
                        {
                            "kind": kind,
                            "key": key,
                            "rv": self.rvs.get((kind, key), 0),
                            "obj": to_wire(obj),
                        }
                    )
        return out

    def import_entries(self, entries) -> int:
        """Adopt migrated keys VERBATIM — object bytes and per-key rv
        both (the rv travels with the key, so a client whose dirty
        flush carries an old-owner base_rv still fences correctly at
        the new owner).  Ends with an epoch rotation: ownership
        changed, so no pre-import cursor may claim coverage."""
        n = 0
        with self.lock:
            for e in entries:
                spec = STORE_KINDS.get(e.get("kind"))
                if spec is None or e.get("kind") == "Lease":
                    continue
                _cls, attr, _key_fn = spec
                rv = e.get("rv", 0)
                getattr(self.kube, attr)[e["key"]] = materialize(e["obj"])
                self.rvs[(e["kind"], e["key"])] = rv
                # adopt at least the imported rv space's high-water
                # mark: this shard's future commits must stamp rvs
                # ABOVE every imported one, or a client's stale-echo
                # check would drop fresh writes to migrated keys
                self.rv = max(self.rv, rv)
                n += 1
            self.rotate_epoch("migration")
        return n

    def drop_keys(self, keys) -> int:
        """Drop migrated keys WITHOUT verb cascades (delete_node would
        re-pend its pods — but those pods moved WITH their node; the
        ownership transfer is not a semantic delete).  Epoch-rotates
        like import: the fence is what keeps a cursor from spanning
        the ownership change."""
        n = 0
        with self.lock:
            for kind, key in keys:
                spec = STORE_KINDS.get(kind)
                if spec is None:
                    continue
                _cls, attr, _key_fn = spec
                if getattr(self.kube, attr).pop(key, None) is not None:
                    n += 1
                self.rvs.pop((kind, key), None)
            self.rotate_epoch("migration")
        return n

    def close_subscribers(self) -> None:
        with self.lock:
            for sub in self._subscribers:
                sub.close()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "StoreServer" = self.server  # type: ignore[assignment]
        server.track_conn(self.request)
        try:
            self._serve(server)
        finally:
            server.untrack_conn(self.request)

    def _serve(self, server: "StoreServer") -> None:
        codec = CODEC_JSON
        while True:
            try:
                payload = recv_frame(self.request)
            except (ConnectionError, OSError):
                return
            except ValueError as exc:
                log.warning("dropping malformed store frame: %s", exc)
                return
            server.count_bytes("received", codec, len(payload) + 8)
            try:
                header = decode_payload(payload, codec)
            except (ValueError, UnicodeDecodeError) as exc:
                log.warning("undecodable %s store frame: %s", codec, exc)
                return
            method = str(header.get("method", "?"))
            if method == "watch":
                # counted like every other RPC (docs/metrics.md lists
                # watch in the per-method series); the span for the
                # snapshot phase is recorded inside serve_watch, where
                # the ctx is still in hand
                server.registry.inc(
                    "karpenter_store_requests_total", {"method": "watch"}
                )
                server.serve_watch(self.request, header)
                return
            # adopt the CLIENT's trace context for the handling span:
            # the server's span log records this RPC under the caller's
            # tick trace ID, stitching the two processes' timelines
            # (state/remote.py ships the ctx; obs/render.py merges)
            ctx = header.get("ctx") or {}
            t0 = time.perf_counter()
            try:
                with trace_context(ctx.get("trace_id", "")), \
                        server.tracer.span(f"store.{method}"):
                    response = server.dispatch(header, codec)
            except Exception as exc:
                log.exception("store request failed")
                response = {"status": "error", "error": str(exc)}
            server.registry.inc(
                "karpenter_store_requests_total", {"method": method}
            )
            server.registry.observe(
                "karpenter_store_request_seconds",
                time.perf_counter() - t0,
                {"method": method},
            )
            try:
                out = encode_payload(response, codec)
                server.count_bytes("sent", codec, len(out) + 8)
                send_frame(self.request, out)
            except (ConnectionError, OSError):
                return
            if (
                method == "hello"
                and response.get("status") == "ok"
                and response.get("codec")
            ):
                # the ack itself rode the old codec; everything after
                # speaks the negotiated one
                codec = response["codec"]


class StoreServer(socketserver.ThreadingTCPServer):
    """Serve the shared store on (host, port); port 0 picks a free port.

    ``codecs`` lists the payload codecs this server negotiates (bin1
    preferred).  ``legacy_protocol=True`` emulates a pre-fleet-scale
    server — no ``hello``, inline-snapshot watches — for the
    mixed-version compatibility tests.  ``replica_of=(host, port)``
    starts this server as a READ REPLICA: a follower thread mirrors the
    primary over the watch protocol and every write method refuses."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        store: Optional[VersionedStore] = None,
        codecs: Tuple[str, ...] = (CODEC_BIN, CODEC_JSON),
        legacy_protocol: bool = False,
        replica_of: Optional[Tuple[str, int]] = None,
        shard_index: int = 0,
    ):
        super().__init__((host, port), _Handler)
        self.store = store or VersionedStore()
        # this server's position in the shard topology (0 for the
        # unsharded single-store deployment): shard_export computes
        # "what do I no longer own?" relative to it
        self.shard_index = shard_index
        self.codecs = tuple(codecs)
        self.legacy_protocol = legacy_protocol
        self.replica_of = replica_of
        self.read_only = replica_of is not None
        self._thread: Optional[threading.Thread] = None
        # the server process's OWN observability surface: request
        # counters + handling spans (recorded under each client's trace
        # ID) + a ledger, all served by --telemetry-port in main().  The
        # tracer stays on — spans are two perf_counter calls per RPC,
        # and a store server without a span log cannot answer "which
        # replica's tick was slow?"
        self.registry = Registry()
        self.tracer = Tracer(enabled=True)
        self.ledger = EventLedger(registry=self.registry)
        self.registry.ledger = self.ledger
        self.store.registry = self.registry
        if self.store.durable_log is not None:
            # the log's counters land on the serving process's surface
            self.store.durable_log.registry = self.registry
        # live connections, so stop() can sever them: a stopped server
        # must not keep answering established RPC sockets from daemon
        # handler threads (a real process exit closes them; the
        # in-process stop must behave the same, or clients talk to a
        # zombie serving pre-stop state)
        self._conns: set = set()
        self._conns_lock = make_lock("StoreServer._conns_lock")
        # follower plumbing (read replicas)
        self._primary_seq = 0
        self._primary_epoch = ""

        self._follow_stop = threading.Event()
        self._follow_sock: Optional[socket.socket] = None
        self._follow_thread: Optional[threading.Thread] = None
        if self.replica_of is not None:
            self._follow_thread = threading.Thread(
                target=self._follow_loop,
                daemon=True,
                name="store-replica-follow",
            )
            self._follow_thread.start()

    # -------------------------------------------------------------- metrics
    def count_bytes(self, direction: str, codec: str, n: int) -> None:
        if direction == "sent":
            self.registry.inc(
                "karpenter_store_bytes_sent_total", {"codec": codec}, by=n
            )
        else:
            self.registry.inc(
                "karpenter_store_bytes_received_total", {"codec": codec}, by=n
            )

    # ------------------------------------------------------------- dispatch
    def _negotiated_codec(self, header: dict) -> str:
        if (
            CODEC_BIN in self.codecs
            and CODEC_BIN in (header.get("codecs") or ())
            and header.get("schema_fp") == SCHEMA_FP
        ):
            return CODEC_BIN
        return CODEC_JSON

    def dispatch(self, header: dict, codec: str = CODEC_JSON) -> dict:
        method = header.get("method")
        store = self.store
        if method == "ping":
            return {"status": "ok"}
        if method == "hello":
            if self.legacy_protocol:
                # the pre-fleet-scale server didn't know hello; the
                # client treats the error as "speak JSON"
                return {"status": "error", "error": "unknown method hello"}
            return {
                "status": "ok",
                "codec": self._negotiated_codec(header),
                "schema_fp": SCHEMA_FP,
                "read_only": self.read_only,
            }
        if method == "stat":
            with store.lock:
                return {
                    "status": "ok",
                    "rv": store.rv,
                    "seq": store.log_seq,
                    "epoch": store.epoch,
                    "event_count": len(store.kube.events),
                    "read_only": self.read_only,
                }
        if self.read_only and method in _WRITE_METHODS:
            return {
                "status": "error",
                "error": "read-only replica: writes go to the primary "
                f"store at {self.replica_of[0]}:{self.replica_of[1]}",
            }
        if method == "put":
            return self._put(header, codec)
        if method == "delete":
            return self._delete(header, codec)
        if method == "bind_pod":
            # store.lock held across fence AND mutate (as in _put): a
            # fence that releases the lock before the mutation is a
            # TOCTOU hole for the stale write it exists to stop
            with store.lock:
                conflict = self._fence(
                    "Pod", header["key"], header.get("base_rv")
                )
                if conflict is not None:
                    return conflict
                batch = store.mutate(
                    lambda: store.kube.bind_pod(
                        header["key"], header["node_name"]
                    ),
                    origin=header.get("identity", ""),
                    origin_codec=codec,
                )
            return {
                "status": "ok",
                "events": batch.events_for(codec) if batch else [],
            }
        if method == "evict_pod":
            with store.lock:
                conflict = self._fence(
                    "Pod", header["key"], header.get("base_rv")
                )
                if conflict is not None:
                    return conflict
                batch = store.mutate(
                    lambda: store.kube.evict_pod(header["key"]),
                    origin=header.get("identity", ""),
                    origin_codec=codec,
                )
            return {
                "status": "ok",
                "events": batch.events_for(codec) if batch else [],
            }
        if method == "record_event":
            event_rv = store.append_cluster_event(
                header["kind"],
                header["reason"],
                header["obj_name"],
                header.get("message", ""),
                origin=header.get("identity", ""),
                origin_codec=codec,
            )
            return {"status": "ok", "event_rv": event_rv}
        if method == "lease_acquire":
            return self._lease_acquire(header, codec)
        if method == "lease_renew":
            return self._lease_renew(header)
        if method == "lease_release":
            return self._lease_release(header, codec)
        if method == "shard_export":
            entries = store.export_entries(
                self.shard_index, int(header.get("new_n", 1))
            )
            return {"status": "ok", "entries": entries}
        if method == "shard_import":
            imported = store.import_entries(header.get("entries", ()))
            return {"status": "ok", "imported": imported,
                    "epoch": store.epoch}
        if method == "shard_drop":
            dropped = store.drop_keys(header.get("keys", ()))
            return {"status": "ok", "dropped": dropped,
                    "epoch": store.epoch}
        return {"status": "error", "error": f"unknown method {method}"}

    def _put(self, header: dict, codec: str = CODEC_JSON) -> dict:
        store = self.store
        kind = header["kind"]
        spec = STORE_KINDS.get(kind)
        if spec is None or kind == "Lease":
            return {"status": "error", "error": f"unwritable kind {kind}"}
        cls, attr, key_fn = spec
        obj = materialize(header["obj"])
        if not isinstance(obj, cls):
            return {"status": "error", "error": f"object is not a {kind}"}
        key = key_fn(obj)
        with store.lock:
            conflict = self._fence(kind, key, header.get("base_rv"))
            if conflict is not None:
                return conflict
            verb = {
                "Pod": store.kube.put_pod,
                "Node": store.kube.put_node,
                "NodeClaim": store.kube.put_node_claim,
                "NodePool": store.kube.put_node_pool,
                "NodeClass": store.kube.put_node_class,
                "PodDisruptionBudget": store.kube.put_pdb,
                "StorageClass": store.kube.put_storage_class,
                "PersistentVolumeClaim": store.kube.put_pvc,
            }[kind]
            batch = store.mutate(
                lambda: verb(obj),
                origin=header.get("identity", ""),
                origin_codec=codec,
            )
            return {
                "status": "ok",
                "events": batch.events_for(codec) if batch else [],
            }

    def _fence(self, kind: str, key: str, base_rv) -> Optional[dict]:
        """Optimistic-concurrency check shared by delete/bind/evict: a
        deposed leader's straggler verb (stale base_rv) gets ``conflict``
        with the current object instead of clobbering — the same fencing
        ``put`` applies."""
        store = self.store
        with store.lock:
            cur = store.rvs.get((kind, key), 0)
            if base_rv is None or base_rv == cur:
                return None
            _cls, attr, _key_fn = STORE_KINDS[kind]
            existing = getattr(store.kube, attr).get(key)
            return {
                "status": "conflict",
                "rv": cur,
                "obj": to_wire(existing) if existing is not None else None,
            }

    def _delete(self, header: dict, codec: str = CODEC_JSON) -> dict:
        store = self.store
        kind, key = header["kind"], header["key"]
        spec = STORE_KINDS.get(kind)
        if spec is None or kind == "Lease":
            return {"status": "error", "error": f"undeletable kind {kind}"}
        _cls, attr, _key_fn = spec
        kube = store.kube

        def apply() -> None:
            if kind == "Pod":
                kube.delete_pod(key)
            elif kind == "Node":
                kube.delete_node(key)
            elif kind == "NodeClaim":
                kube.delete_node_claim(key)
            else:
                obj = getattr(kube, attr).pop(key, None)
                if obj is not None:
                    kube._notify(kind, "delete", obj)

        with store.lock:  # fence + mutate atomically (see bind_pod)
            conflict = self._fence(kind, key, header.get("base_rv"))
            if conflict is not None:
                return conflict
            batch = store.mutate(
                apply,
                origin=header.get("identity", ""),
                origin_codec=codec,
            )
        return {
            "status": "ok",
            "events": batch.events_for(codec) if batch else [],
        }

    # --------------------------------------------------------------- leases
    def _lease_acquire(self, header: dict, codec: str = CODEC_JSON) -> dict:
        store = self.store
        name = header["name"]
        with store.lock:
            acquired = None

            def apply() -> None:
                nonlocal acquired
                acquired = store.kube.try_acquire_lease(
                    name,
                    header["holder"],
                    header["now"],
                    header["duration_s"],
                )
                if acquired:
                    # every successful acquire-or-renew advances the CAS
                    # sequence so a competing renewer's base_rv goes stale
                    store.lease_seq[name] = store.lease_seq.get(name, 0) + 1

            batch = store.mutate(
                apply,
                origin=header.get("identity", ""),
                origin_codec=codec,
            )
            lease = store.kube.leases.get(name)
            return {
                "status": "ok",
                "acquired": bool(acquired),
                "rv": store.lease_seq.get(name, 0),
                # rv of THIS call's broadcast Lease event (fresh acquire
                # only; silent renewals broadcast nothing) — the
                # originator credits exactly this toward synced_rv
                "lease_event_rv": batch.max_rv if batch else 0,
                "lease": to_wire(lease) if lease is not None else None,
            }

    def _lease_renew(self, header: dict) -> dict:
        store = self.store
        name = header["name"]
        with store.lock:
            cur = store.lease_seq.get(name, 0)
            base_rv = header.get("base_rv")
            if base_rv is not None and base_rv != cur:
                # someone else mutated the lease since this renewer last
                # saw it — the renewal loses cleanly (optimistic CAS)
                return {
                    "status": "ok",
                    "renewed": False,
                    "conflict": True,
                    "rv": cur,
                }
            renewed = store.kube.renew_lease(
                name, header["holder"], header["now"]
            )
            if renewed:
                store.lease_seq[name] = cur + 1
            return {
                "status": "ok",
                "renewed": renewed,
                "rv": store.lease_seq.get(name, 0),
            }

    def _lease_release(self, header: dict, codec: str = CODEC_JSON) -> dict:
        store = self.store
        name = header["name"]
        with store.lock:
            lease = store.kube.leases.get(name)
            held = lease is not None and lease.holder == header["holder"]
            batch = store.mutate(
                lambda: store.kube.release_lease(name, header["holder"]),
                origin=header.get("identity", ""),
                origin_codec=codec,
            )
            if held:
                # only a release that actually freed the lease advances
                # the CAS sequence: a retried/stale release from a
                # non-holder is a no-op, and bumping the seq for it would
                # stale-out the REAL holder's next renewal base_rv
                store.lease_seq[name] = store.lease_seq.get(name, 0) + 1
            return {
                "status": "ok",
                "rv": store.lease_seq.get(name, 0),
                "lease_event_rv": batch.max_rv if batch else 0,
            }

    # ---------------------------------------------------------------- watch
    def _events_frame(self, batches: List[_Batch], codec: str) -> dict:
        events = [ev for b in batches for ev in b.events_for(codec)]
        return {"type": "events", "seq": batches[-1].seq, "events": events}

    def _resync_frame(self, mode: str, payload, codec: str) -> dict:
        """The one construction site for ``resync`` frames (part of the
        lint-rule-10 wire vocabulary): ``payload`` is a batch list for
        replay mode, a snapshot dict otherwise."""
        if mode == "replay":
            return {
                "type": "resync",
                "mode": "replay",
                "seq": self.store.log_seq,
                "epoch": self.store.epoch,
                "events": [
                    ev for b in payload for ev in b.events_for(codec)
                ],
            }
        return {
            "type": "resync",
            "mode": "snapshot",
            "seq": self.store.log_seq,
            "epoch": self.store.epoch,
            "snapshot": payload,
        }

    def _frame_payload(self, batches: List[_Batch], codec: str) -> bytes:
        """Encoded events frame for a drained batch run.  The common
        case — an up-to-date subscriber draining exactly one batch —
        ships the batch's content-addressed bin frame bytes, rendered
        once for the whole fan-out."""
        if codec == CODEC_BIN and len(batches) == 1:
            return batches[0].bin_frame_payload()
        return encode_payload(self._events_frame(batches, codec), codec)

    def _resync_payload_locked(self, sub: _Subscriber, codec: str):
        """Store lock held: build the overflow-coalesced resync frame.
        Returns encoded BYTES for bin (a bin snapshot holds live object
        references, so it must be rendered before the lock drops) or
        the frame DICT for JSON (trees are immutable — the expensive
        json.dumps of a large snapshot must NOT stall every writer on
        the store lock; the caller encodes outside)."""
        store = self.store
        self.registry.inc(
            "karpenter_store_resync_total", {"kind": sub.forced_reason}
        )
        if sub.delivered_seq > 0 and store.covers(
            sub.delivered_seq, store.epoch
        ):
            frame = self._resync_frame(
                "replay", store.replay_since(sub.delivered_seq), codec
            )
        else:
            frame = self._resync_frame(
                "snapshot", store.snapshot(codec), codec
            )
        sub.delivered_seq = store.log_seq
        return encode_payload(frame, codec) if codec == CODEC_BIN else frame

    def serve_watch(self, sock, header: dict) -> None:
        identity = header.get("identity", "")
        ctx = header.get("ctx") or {}
        store = self.store
        legacy = self.legacy_protocol or "codecs" not in header
        codec = CODEC_JSON if legacy else self._negotiated_codec(header)
        since_seq = None if legacy else header.get("since_seq")
        client_epoch = "" if legacy else str(header.get("epoch") or "")
        # span only the initial-sync phase (subscribe + snapshot/replay
        # frame) — the expensive, attributable part; the push loop below
        # lives as long as the connection and would make a meaningless
        # span
        with trace_context(ctx.get("trace_id", "")), self.tracer.span(
            "store.watch", identity=identity
        ):
            with store.lock:
                mode, payload, sub = store.subscribe(
                    identity, codec, since_seq, epoch=client_epoch
                )
                if legacy:
                    # JSON trees are immutable: encode outside the lock
                    frames = [{"status": "ok", "snapshot": payload}]
                else:
                    ack = encode_payload(
                        {
                            "status": "ok",
                            "codec": codec,
                            "resync": mode,
                            "seq": store.log_seq,
                            "epoch": store.epoch,
                            "schema_fp": SCHEMA_FP,
                        },
                        CODEC_JSON,
                    )
                    body = self._resync_frame(mode, payload, codec)
                    # only a BIN snapshot must render under the lock
                    # (it references live objects); the JSON form is an
                    # immutable tree, and dumping a large snapshot
                    # inside the lock would stall every writer
                    frames = [
                        ack,
                        encode_payload(body, codec)
                        if codec == CODEC_BIN
                        else body,
                    ]
        try:
            for i, f in enumerate(frames):
                if isinstance(f, dict):  # deferred JSON encode
                    f = encode_payload(f, CODEC_JSON)
                # the ack always rides JSON; everything after, the codec
                self.count_bytes(
                    "sent",
                    CODEC_JSON if (not legacy and i == 0) else codec,
                    len(f) + 8,
                )
                send_frame(sock, f)
            while True:
                pending_dict = None
                with sub.cond:
                    while not (
                        sub.batches or sub.pending_resync or sub.closed
                    ):
                        sub.cond.wait(1.0)
                    if sub.closed:
                        return
                    if sub.pending_resync:
                        if legacy:
                            # the legacy stream cannot express a resync
                            # marker; dropping the connection forces the
                            # old client's snapshot-reconnect path
                            return
                        sub.pending_resync = False
                        out = self._resync_payload_locked(sub, codec)
                        if isinstance(out, dict):  # JSON: encode unlocked
                            pending_dict, out = out, None
                    else:
                        note_access("_Subscriber.batches")
                        batches = list(sub.batches)
                        sub.batches.clear()
                        sub.delivered_seq = batches[-1].seq
                        out = None
                if out is None and pending_dict is not None:
                    out = encode_payload(pending_dict, codec)
                    pending_dict = None
                if out is None:
                    # event frames encode OUTSIDE the lock: trees and
                    # pre-rendered bin payloads are immutable
                    if legacy:
                        # faithful pre-fleet emulation: no seq on the
                        # wire (the old protocol had no seq space)
                        out = encode_payload(
                            {
                                "type": "events",
                                "events": [
                                    ev
                                    for b in batches
                                    for ev in b.events_for(CODEC_JSON)
                                ],
                            },
                            CODEC_JSON,
                        )
                    else:
                        out = self._frame_payload(batches, codec)
                self.count_bytes("sent", codec, len(out) + 8)
                send_frame(sock, out)
        except (ConnectionError, OSError):
            return
        finally:
            store.unsubscribe(sub)

    # ------------------------------------------------------------ replica
    def _follow_loop(self) -> None:
        """Read-replica follower: mirror the primary over the SAME watch
        protocol clients use, tracking the primary's seq space so a
        reconnect delta-resyncs instead of re-snapshotting.  The
        dial/handshake/backoff/resync choreography is the SHARED
        watch-client primitive (service/watchclient.py — one definition
        with RemoteKubeStore's mirror loop); the follower contributes
        the replica handshake and the verbatim-apply frame handler."""
        host, port = self.replica_of  # type: ignore[misc]

        def hello() -> dict:
            return {
                "method": "watch",
                "identity": f"replica@{self.address[1]}",
                "codecs": list(self.codecs),
                "schema_fp": SCHEMA_FP,
                "since_seq": self._primary_seq,
                "epoch": self._primary_epoch,
            }

        def legacy_snapshot(snapshot: dict) -> None:
            self.store.apply_replicated_snapshot(snapshot)
            self._primary_seq = snapshot.get("seq", 0)

        def set_live(sock) -> None:
            self._follow_sock = sock

        WatchChannelClient(
            dial=lambda: socket.create_connection((host, port), timeout=5.0),
            hello=hello,
            tx=send_frame,
            rx=lambda sock, _codec: recv_frame(sock),
            on_epoch=self._note_primary_epoch,
            on_legacy_snapshot=legacy_snapshot,
            on_frame=lambda frame, _initial: self._apply_frame(frame),
            stop=self._follow_stop,
            on_live=set_live,
        ).run()

    def _note_primary_epoch(self, epoch: str) -> None:
        """Adopt the primary's epoch id, zeroing the follow cursor the
        moment a CHANGE is detected — BEFORE any payload applies, so an
        interrupted handshake can never leave a new-epoch label over an
        old-space seq the busy new primary's log might falsely cover."""
        if epoch != self._primary_epoch:
            if self._primary_epoch:
                self._primary_seq = 0
            self._primary_epoch = epoch

    def _apply_frame(self, frame: dict) -> None:
        kind = frame.get("type")
        if kind == "resync" and "epoch" in frame:
            self._note_primary_epoch(str(frame.get("epoch") or ""))
        if kind == "events":
            self.store.apply_replicated(frame.get("events", ()))
            # .get: a legacy primary's frames carry no seq — the cursor
            # stays 0 and every reconnect snapshots, which is correct
            self._primary_seq = frame.get("seq", self._primary_seq)
        elif kind == "resync":
            if frame.get("mode") == "snapshot":
                self.store.apply_replicated_snapshot(frame["snapshot"])
            else:
                self.store.apply_replicated(frame.get("events", ()))
            self._primary_seq = frame.get("seq", self._primary_seq)

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> Tuple[str, int]:
        return self.server_address  # type: ignore[return-value]

    def start_background(self) -> "StoreServer":
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="store-server"
        )
        self._thread.start()
        return self

    def track_conn(self, sock) -> None:
        with self._conns_lock:
            self._conns.add(sock)

    def untrack_conn(self, sock) -> None:
        with self._conns_lock:
            self._conns.discard(sock)

    def stop(self) -> None:
        self._follow_stop.set()
        follow_sock = self._follow_sock
        if follow_sock is not None:
            try:
                follow_sock.close()
            except OSError:
                pass
        self.store.close_subscribers()
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass
        self.shutdown()
        self.server_close()
        if self._follow_thread is not None:
            self._follow_thread.join(timeout=2.0)
            self._follow_thread = None


def main(argv=None) -> int:
    """``python -m karpenter_tpu_torch store-server`` (also reachable as
    ``python -m karpenter_tpu_torch.service.store_server``)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch store-server",
        description="karpenter-tpu shared cluster-store server",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8082)
    parser.add_argument(
        "--telemetry-port",
        type=int,
        default=8083,
        help="HTTP port for /metrics, /healthz, /events and /trace on "
        "THIS process (0 disables) — the store server's request "
        "counters and its span log, which records every RPC under the "
        "calling replica's trace ID",
    )
    parser.add_argument(
        "--replica-of",
        default="",
        metavar="HOST:PORT",
        help="follow the primary store at HOST:PORT and serve READ "
        "traffic (snapshot/watch/stat) with its rv ordering preserved; "
        "every write method refuses and names the primary",
    )
    parser.add_argument(
        "--replay-log-events",
        type=int,
        default=REPLAY_LOG_EVENTS,
        help="events retained for delta watch resync before compaction",
    )
    parser.add_argument(
        "--watch-queue-batches",
        type=int,
        default=WATCH_QUEUE_BATCHES,
        help="per-subscriber queued batches before a slow client is "
        "coalesced onto a forced resync",
    )
    parser.add_argument(
        "--events-cap",
        type=int,
        default=EVENTS_CAP,
        help="durable cluster-event ledger bound (oldest trimmed)",
    )
    parser.add_argument(
        "--json-only",
        action="store_true",
        help="disable bin1 negotiation (tagged JSON only)",
    )
    parser.add_argument(
        "--log-dir",
        default="",
        help="directory for the crash-durable replay segment; empty "
        "disables durability (a restart forces snapshot resyncs). "
        "A restarted server re-adopts its epoch from the segment and "
        "serves DELTA resyncs from disk",
    )
    parser.add_argument(
        "--log-fsync",
        default=FSYNC_ALWAYS,
        choices=("always", "off"),
        help="fsync policy for the durable replay log: 'always' syncs "
        "every append (crash loses nothing acknowledged), 'off' leaves "
        "flushing to the OS (crash may lose the unsynced tail, which "
        "recovery drops as torn)",
    )
    parser.add_argument(
        "--shard-index",
        type=int,
        default=0,
        help="this server's index in the key-sharded store topology "
        "(0 for the unsharded deployment); shard_export routes moving "
        "keys relative to it",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    replica_of = None
    if args.replica_of:
        rhost, _, rport = args.replica_of.partition(":")
        replica_of = (rhost, int(rport) if rport else 8082)
    durable_log = None
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        durable_log = DurableReplayLog(
            os.path.join(
                args.log_dir, f"store-shard-{args.shard_index}.log"
            ),
            fsync=args.log_fsync,
        )
    store = VersionedStore(
        replay_log_events=args.replay_log_events,
        watch_queue_batches=args.watch_queue_batches,
        events_cap=args.events_cap,
        durable_log=durable_log,
    )
    server = StoreServer(
        args.host,
        args.port,
        store=store,
        codecs=(CODEC_JSON,) if args.json_only else (CODEC_BIN, CODEC_JSON),
        replica_of=replica_of,
        shard_index=args.shard_index,
    )
    telemetry = None
    if args.telemetry_port:
        from karpenter_tpu_torch.obs.http import start_telemetry

        telemetry = start_telemetry(
            args.telemetry_port,
            server.registry,
            tracer=server.tracer,
            ledger=server.ledger,
        )
        log.info("telemetry on :%d/metrics", args.telemetry_port)
    log.info(
        "cluster store listening on %s:%d%s",
        *server.address,
        f" (read replica of {args.replica_of})" if replica_of else "",
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - CLI path
        pass
    finally:
        if telemetry is not None:
            telemetry.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
