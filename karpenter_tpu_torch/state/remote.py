"""Remote cluster-store client: a KubeStore mirror over the wire.

`RemoteKubeStore` is a drop-in `KubeStore` (the Operator takes it
unchanged): reads serve from a local mirror, every mutation verb applies
locally AND forwards to the shared `StoreServer`
(service/store_server.py), and a background watch stream applies other
replicas' writes into the mirror — so a standby replica's caches stay
warm and a failover leader starts from the durable state, exactly like
the reference's informer-fed controllers over the kube-apiserver.

Consistency model:

- **Verbs** (put/delete/bind/evict/record_event) run the same
  deterministic KubeStore logic locally, then forward; the server is
  authoritative and assigns each object a resourceVersion.  Local object
  IDENTITY is preserved — controllers that hold a reference to an object
  they just put keep mutating the live mirror object.
- **In-place mutations** (controllers stamp conditions/labels directly,
  e.g. lifecycle.py) are picked up by shadow-diffing: before every Lease
  operation — i.e. at least once per reconcile tick and per renewal —
  `_flush_dirty` pushes every mirror object whose canonical encoding
  drifted from the server's last-known bytes.  A leader crash loses at
  most the unflushed tail of its last tick, the same as crashing before
  those writes.
- **Conflicts**: pushes carry the base resourceVersion; a stale write
  (a deposed leader's straggler) gets ``conflict`` back and the client
  adopts the server's object instead of clobbering.
- **Leases** are never written generically: acquire/renew/release are
  dedicated CAS RPCs, atomic server-side.  A store outage during a lease
  call returns False — a leader that cannot prove its lease abdicates
  (safety over liveness).
- **Failures**: transient socket errors retry with bounded backoff;
  request timeouts raise `StoreUnavailableError` (retryable) instead of
  hanging.  The watch thread reconnects and resyncs from a fresh
  snapshot, so a store restart mid-watch heals itself.
- **Sharding**: ``shards=[(host, port), ...]`` spreads the key space
  over N store primaries (service/shardrouter.py owns the hash).  Each
  shard gets its own `StoreChannel` — RPC socket, negotiated codec, and
  an independent watch stream with its own ``(epoch, seq)`` cursor and
  ``synced_rv`` (rv/seq/event_rv spaces are PER SHARD; only per-shard
  comparisons are meaningful).  Writes fan out to the owner shard;
  leases always route to shard 0; the merged watch streams feed one
  mirror, each key touched only by its owner's stream.  A topology
  change (``apply_topology``) tears down every channel and resyncs
  under the servers' migration epoch fence — per-key rvs migrate WITH
  their keys, so dirty-flush fencing survives the move.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.obs.context import current_trace_id
from karpenter_tpu_torch.analysis.sanitizer import (
    make_lock,
    make_rlock,
    note_access,
    note_blocking,
)
from karpenter_tpu_torch.service.codec import (
    CODEC_BIN,
    CODEC_JSON,
    decode_payload,
    encode_payload,
    recv_frame,
    send_frame,
)
from karpenter_tpu_torch.service.shardrouter import LEASE_SHARD, ShardRouter
from karpenter_tpu_torch.service.watchclient import WatchChannelClient
from karpenter_tpu_torch.state.binwire import SCHEMA_FP
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.state.wire import (
    STORE_KINDS,
    canonical,
    from_wire,
    materialize,
    to_wire,
)
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

RETRIES = 3
BACKOFF_S = 0.05  # doubles per attempt
EVENTS_CAP = 4096  # mirror-side cluster-event ledger bound (default)


class StoreUnavailableError(ConnectionError):
    """The shared store could not be reached (after retries) or timed
    out.  Retryable: the caller may re-issue the request."""


class StoreChannel:
    """One shard's client-side state: the RPC socket (one in-flight
    request per connection — the framing protocol's invariant, held by
    ``_lock`` across send+recv), the negotiated codec, and this shard's
    independent watch cursor.

    rv/seq/event_rv are PER-SHARD spaces: ``synced_rv`` and
    ``event_rv`` here are this shard's high-water marks, never compared
    against another channel's.  The single-shard deployment is the
    degenerate case — one channel owning every key — which is exactly
    the pre-sharding client."""

    def __init__(self, host: str, port: int, index: int):
        self.host = host
        self.port = port
        self.index = index
        self._lock = make_lock("StoreChannel._lock")
        self.sock: Optional[socket.socket] = None
        self.sock_codec = CODEC_JSON  # negotiated per RPC connection
        self.watch_seq = 0
        self.watch_epoch = ""
        self.synced_rv = 0
        self.event_rv = 0
        # whether this channel has EVER completed a state transfer —
        # the first-sync test for resync accounting.  Inferring it from
        # zeroed cursors is wrong: an epoch change zeroes them too, and
        # the forced snapshot that follows is a genuine resync that
        # must be counted
        self.ever_synced = False
        self.stop = threading.Event()
        self.watch_thread: Optional[threading.Thread] = None
        self.watch_sock: Optional[socket.socket] = None

    def close_sock(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    def shutdown(self) -> None:
        """Stop this channel's watch loop and sever both sockets.  The
        live watch socket gets a protocol-level shutdown(SHUT_RDWR)
        BEFORE close: close() alone frees the fd but does NOT wake a
        recv already blocked in another thread — the watch thread would
        sit out its whole join timeout on every teardown."""
        self.stop.set()
        self.close_sock()
        watch_sock = self.watch_sock
        if watch_sock is not None:
            try:
                watch_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already disconnected
            try:
                watch_sock.close()
            except OSError:
                pass
        if self.watch_thread is not None:
            self.watch_thread.join(timeout=2.0)
            self.watch_thread = None


class RemoteKubeStore(KubeStore):
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8082,
        identity: str = "",
        connect_timeout: float = 5.0,
        request_timeout: float = 10.0,
        start_watch: bool = True,
        clock: Optional[Clock] = None,
        codec: str = "auto",
        registry: Optional[Registry] = None,
        events_cap: int = EVENTS_CAP,
        shards: Optional[Sequence[Tuple[str, int]]] = None,
        watch_pace=None,
    ):
        super().__init__()
        self.host = host
        self.port = port
        self.identity = identity or f"client-{id(self):x}"
        # payload-codec preference: "auto" negotiates the compact binary
        # codec per connection (`hello` on the RPC socket, `codecs` on
        # the watch request) and falls back to tagged JSON against a
        # server that doesn't speak it; "json" never negotiates.
        self.codec = codec
        # store-plane telemetry (karpenter_store_rpc_seconds,
        # karpenter_store_bytes_*, StoreResync ledger events) lands in
        # the caller's registry — pass the operator's so the flight
        # recorder and doctor see the client half of the store plane.  A
        # bare default registry drops ledger events by design.
        self.registry = registry or Registry()
        # mirror-side cluster-event ledger bound (Settings.store_events_cap)
        self.events_cap = events_cap
        # injectable pacing clock: retry backoff and wait_synced polling
        # sleep on it, so under a FakeClock (the simulator's determinism
        # contract — no raw time.sleep outside utils/clock.py) the waits
        # become simulated time.  Socket TIMEOUTS stay wall-clock: they
        # bound real network reads, which no simulated clock can compress.
        # Caveat of the same contract: pairing a FakeClock with a REAL
        # remote server collapses the backoff to zero wall time, giving
        # the server no recovery window — a FakeClock belongs with
        # simulated peers; real deployments keep the default Clock.
        self.clock = clock or Clock()
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self._mirror_lock = make_rlock("RemoteKubeStore._mirror_lock")  # mirror + rv bookkeeping
        self._lease_mutex = make_lock("RemoteKubeStore._lease_mutex")  # lease ops end-to-end
        self._rvs: Dict[Tuple[str, str], int] = {}
        self._shadow: Dict[Tuple[str, str], str] = {}
        self._lease_rvs: Dict[str, int] = {}
        # one channel per shard; the single-address constructor is the
        # degenerate one-shard topology (the pre-sharding client,
        # byte-for-byte in behavior)
        self._channels: List[StoreChannel] = [
            StoreChannel(h, p, i)
            for i, (h, p) in enumerate(shards or [(host, port)])
        ]
        self._router = ShardRouter(len(self._channels))
        self.watch_resyncs: Dict[str, int] = {}
        self._stop = threading.Event()
        # reconnect-backoff pacing seam (service/watchclient.py): the
        # fleet simulator injects a deterministic pacer; None keeps
        # production's wall-clock exponential backoff
        self._watch_pace = watch_pace
        self._watch_enabled = False
        if start_watch:
            self.start_watch()

    # ----------------------------------------------- single-shard compat view
    # The one-shard deployment's tests and tools observe the client
    # through these names; they read channel 0 (the only channel).
    # Read-only on purpose: all writes go through the owning channel.
    @property
    def _sock_codec(self) -> str:
        return self._channels[0].sock_codec

    @property
    def _watch_seq(self) -> int:
        # last seq contiguously applied from the WATCH stream (snapshot
        # or event frames) — the delta-resync cursor.  NOT synced_rv:
        # that also counts rvs from our own RPC responses, whose
        # neighboring foreign events may still be in flight on the
        # watch socket; replaying from synced_rv could skip them.
        return self._channels[0].watch_seq

    @property
    def _watch_epoch(self) -> str:
        # the epoch that seq belongs to: seq spaces are
        # per-VersionedStore, and the server refuses to treat a cursor
        # from another epoch as covered (a fresh store's seqs could
        # have overtaken a stale cursor — a bare number proves nothing)
        return self._channels[0].watch_epoch

    @property
    def _watch_sock(self):
        return self._channels[0].watch_sock

    @property
    def synced_rv(self) -> int:
        """The mirror's sync high-water mark.  Per-shard rv spaces are
        independent, so the cross-shard aggregate is only meaningful as
        a monotone progress indicator; `wait_synced` compares per shard."""
        return max(c.synced_rv for c in self._channels)

    # ------------------------------------------------------------- transport
    def _owner_for(self, header: dict) -> int:
        """Which shard serves this request: leases pin to LEASE_SHARD,
        cluster events ride the shard owning the object they describe,
        keyed verbs hash by (kind, key)."""
        method = header.get("method")
        if method in ("lease_acquire", "lease_renew", "lease_release"):
            return LEASE_SHARD if self._router.n > 1 else 0
        if method == "record_event":
            return self._router.owner("Event", str(header.get("obj_name", "")))
        kind = header.get("kind")
        if kind:
            key = header.get("key")
            if key is None and header.get("obj") is not None:
                key = STORE_KINDS[kind][2](materialize(header["obj"]))
            return self._router.owner(kind, str(key))
        return 0

    def _connect(self, chan: StoreChannel) -> socket.socket:
        if chan.sock is None:
            try:
                chan.sock = socket.create_connection(
                    (chan.host, chan.port), timeout=self.connect_timeout
                )
                chan.sock.settimeout(self.request_timeout)
            except OSError as exc:
                raise StoreUnavailableError(
                    f"cluster store at {chan.host}:{chan.port}: {exc}"
                ) from exc
            chan.sock_codec = CODEC_JSON
            if self.codec == "auto":
                chan.sock_codec = self._hello(chan.sock)
        return chan.sock

    def _hello(self, sock: socket.socket) -> str:
        """Negotiate the payload codec for this connection.  The hello
        itself rides JSON; a server that doesn't know the method (the
        pre-fleet-scale protocol) answers with an error, which simply
        means: keep speaking JSON."""
        self._tx(
            sock,
            encode_payload(
                {
                    "method": "hello",
                    "codecs": [CODEC_BIN, CODEC_JSON],
                    "schema_fp": SCHEMA_FP,
                    "identity": self.identity,
                },
                CODEC_JSON,
            ),
            CODEC_JSON,
        )
        response = decode_payload(self._rx(sock, CODEC_JSON), CODEC_JSON)
        if (
            response.get("status") == "ok"
            and response.get("codec") == CODEC_BIN
            and response.get("schema_fp") == SCHEMA_FP
        ):
            return CODEC_BIN
        return CODEC_JSON

    # byte accounting wraps the raw frame I/O so every store family in
    # karpenter_store_bytes_{sent,received}_total{codec} counts the wire
    # reality (payload + the 8-byte length prefix)
    def _tx(self, sock: socket.socket, payload: bytes, codec: str) -> None:
        self.registry.inc(
            "karpenter_store_bytes_sent_total",
            {"codec": codec},
            by=len(payload) + 8,
        )
        send_frame(sock, payload)

    def _rx(self, sock: socket.socket, codec: str) -> bytes:
        payload = recv_frame(sock)
        self.registry.inc(
            "karpenter_store_bytes_received_total",
            {"codec": codec},
            by=len(payload) + 8,
        )
        return payload

    def _close_sock(self) -> None:
        for chan in self._channels:
            chan.close_sock()

    def _rpc(self, header: dict, shard: Optional[int] = None) -> dict:
        """One request/response with bounded retry on transient errors,
        routed to the owner shard (``shard`` overrides for control
        traffic like per-shard ``stat``).  Mutations here are idempotent
        re-applied (puts/deletes/lease CAS); a retried record_event may
        at worst duplicate an event line."""
        chan = self._channels[
            self._owner_for(header) if shard is None else shard
        ]
        header = dict(header, identity=self.identity)
        # runtime blocking witness: a store round trip issued while some
        # OTHER lock is held (the lease mutex is the one sanctioned
        # case) is the convoy the static lock-blocking rule predicts —
        # sanitized runs observe it here.  No-op in production.
        note_blocking("_rpc")
        # trace-context propagation (obs/context.py): the tick's trace ID
        # rides the RPC header so the StoreServer records its handling
        # span under the CLIENT's timeline — one trace spans both
        # processes (docs/designs/observability.md)
        tid = current_trace_id()
        if tid:
            header["ctx"] = {"trace_id": tid}
        last: Optional[Exception] = None
        t0 = time.perf_counter()
        for attempt in range(RETRIES):
            with chan._lock:
                try:
                    sock = self._connect(chan)
                    codec = chan.sock_codec
                    self._tx(
                        sock,
                        encode_payload(self._prep(header, codec), codec),
                        codec,
                    )
                    response = decode_payload(self._rx(sock, codec), codec)
                    break
                except socket.timeout as exc:
                    # a timed-out request must surface as retryable, not
                    # hang or half-read the next response off the socket
                    chan.close_sock()
                    raise StoreUnavailableError(
                        f"store request {header.get('method')} timed out "
                        f"after {self.request_timeout}s"
                    ) from exc
                except (ConnectionError, OSError, ValueError) as exc:
                    # ValueError: a malformed/truncated response frame
                    # (e.g. a fault injector tearing bytes) poisons the
                    # connection — reconnect, same as a transport drop
                    chan.close_sock()
                    last = exc
            if attempt < RETRIES - 1:  # no pointless sleep after the last try
                self.clock.sleep(BACKOFF_S * (2**attempt))
        else:
            raise StoreUnavailableError(
                f"cluster store at {chan.host}:{chan.port}: {last}"
            ) from last
        self.registry.observe(
            "karpenter_store_rpc_seconds",
            time.perf_counter() - t0,
            {"method": str(header.get("method", "?"))},
        )
        if response.get("status") == "error":
            raise RuntimeError(f"store error: {response.get('error')}")
        return response

    @staticmethod
    def _prep(header: dict, codec: str) -> dict:
        """Verb headers carry the live OBJECT in ``obj`` (the binary
        codec ships it natively — no tree build at all); the JSON path
        converts to the tagged tree here, at encode time."""
        obj = header.get("obj")
        if (
            obj is not None
            and codec == CODEC_JSON
            and not isinstance(obj, dict)
        ):
            header = dict(header, obj=to_wire(obj))
        return header

    # ------------------------------------------------------------ mirroring
    def _record_applied(
        self, chan: StoreChannel, kind: str, key: str, obj, rv: int
    ) -> None:
        if obj is None:
            self._rvs.pop((kind, key), None)
            self._shadow.pop((kind, key), None)
        else:
            self._rvs[(kind, key)] = rv
            self._shadow[(kind, key)] = canonical(obj)
        chan.synced_rv = max(chan.synced_rv, rv)

    def _locally_dirty(self, kind: str, key: str, obj) -> bool:
        """Whether the mirror object carries state the server has not
        acknowledged yet: its bytes differ from the last server-confirmed
        encoding (or it was never pushed at all — an in-flight create).
        Replication must never overwrite dirty local state; it reconciles
        through the flush -> conflict -> adopt path instead."""
        return self._shadow.get((kind, key)) != canonical(obj)

    def _absorb_events(self, chan: StoreChannel, events, remote: bool) -> None:
        """Apply server events to the mirror.  ``chan`` is the shard
        the events arrived from: its rv/event_rv spaces are the only
        ones these events may be compared against or credited to.

        Own RPC responses (`remote=False`): the local verb already ran —
        keep the local object (identity preserved for callers holding a
        reference) and record rv + the SERVER's bytes as the shadow, so a
        caller mutating the object right after the verb still diffs dirty
        against what the server actually holds.

        Watch events (`remote=True`): another replica wrote.  A clean
        local entry adopts the server object; a DIRTY one is left alone —
        this replica believes it is (or was) the writer, and the next
        flush's rv conflict decides who wins without ever silently
        clobbering either side."""
        with self._mirror_lock:
            for ev in events:
                kind = ev["kind"]
                if kind == "Event":
                    if ev["event_rv"] > chan.event_rv:
                        chan.event_rv = ev["event_rv"]
                        if remote:
                            self.events.append(materialize(ev["event"]))
                            if len(self.events) > self.events_cap:
                                del self.events[
                                    : len(self.events) - self.events_cap
                                ]
                    continue
                spec = STORE_KINDS.get(kind)
                if spec is None:
                    continue
                _cls, attr, _key_fn = spec
                key, rv = ev["key"], ev["rv"]
                store_dict = getattr(self, attr)
                if ev["verb"] == "delete":
                    local = store_dict.get(key)
                    if rv <= self._rvs.get((kind, key), 0):
                        # a stale echo must not delete a newer object
                        chan.synced_rv = max(chan.synced_rv, rv)
                        continue
                    if (
                        remote
                        and local is not None
                        and self._locally_dirty(kind, key, local)
                    ):
                        # same dirty protection as the put path: an
                        # in-flight local create/mutation is never
                        # silently dropped by a watch delete — the next
                        # flush's rv conflict resolves who wins
                        chan.synced_rv = max(chan.synced_rv, rv)
                        continue
                    store_dict.pop(key, None)
                    self._record_applied(chan, kind, key, None, rv)
                    if remote and local is not None:
                        self._notify(kind, "delete", local)
                    continue
                if rv <= self._rvs.get((kind, key), 0):
                    chan.synced_rv = max(chan.synced_rv, rv)
                    continue
                local = store_dict.get(key)
                server_obj = materialize(ev["obj"])  # decoded once, reused
                server_enc = canonical(server_obj)
                if not remote:
                    # own write: local object IS the source of this event
                    if local is None:  # deleted locally since; keep that
                        chan.synced_rv = max(chan.synced_rv, rv)
                        continue
                    self._rvs[(kind, key)] = rv
                    self._shadow[(kind, key)] = server_enc
                    chan.synced_rv = max(chan.synced_rv, rv)
                    continue
                if local is not None and self._locally_dirty(kind, key, local):
                    chan.synced_rv = max(chan.synced_rv, rv)
                    continue
                if local is not None and canonical(local) == server_enc:
                    self._record_applied(chan, kind, key, local, rv)
                    continue
                store_dict[key] = server_obj
                self._record_applied(chan, kind, key, server_obj, rv)
                self._notify(kind, "put", server_obj)

    def _forward(self, header: dict) -> dict:
        shard = self._owner_for(header)
        chan = self._channels[shard]
        response = self._rpc(header, shard=shard)
        if response.get("status") == "conflict":
            kind = header["kind"]
            key = header.get("key")
            if key is None:  # put headers carry the object, not the key
                key = STORE_KINDS[kind][2](materialize(header["obj"]))
            # Whose write won?  If the server's bytes equal what WE tried
            # to push, the "conflict" is our own racing flush (the verb's
            # forward and the renewal thread's flush both shipping the
            # same object): keep the LOCAL object so callers holding a
            # reference keep mutating live state, and just record rv +
            # server bytes.  Only a genuinely foreign write adopts the
            # server's clone.
            server_wire = response.get("obj")
            pushed_wire = header.get("obj")
            if (
                server_wire is not None
                and pushed_wire is not None
                and canonical(materialize(server_wire))
                == canonical(materialize(pushed_wire))
            ):
                with self._mirror_lock:
                    local = getattr(self, STORE_KINDS[kind][1]).get(key)
                    if local is not None:
                        self._rvs[(kind, key)] = response["rv"]
                        self._shadow[(kind, key)] = canonical(
                            materialize(server_wire)
                        )
                        return response
            log.warning(
                "store write conflict on %s/%s (rv %s); adopting server state",
                kind, key, response.get("rv"),
            )
            self._adopt(chan, kind, key, server_wire, response["rv"])
            return response
        self._absorb_events(chan, response.get("events", ()), remote=False)
        return response

    def _adopt(
        self, chan: StoreChannel, kind: str, key: str, obj_wire, rv: int
    ) -> None:
        _cls, attr, _key_fn = STORE_KINDS[kind]
        with self._mirror_lock:
            # lockset witness: the mirror is written from the watch
            # thread AND from controller-thread RPC responses — the
            # mirror lock must be their common lockset
            note_access("RemoteKubeStore.mirror")
            store_dict = getattr(self, attr)
            if obj_wire is None:
                store_dict.pop(key, None)
                self._record_applied(chan, kind, key, None, rv)
                chan.synced_rv = max(chan.synced_rv, rv)
            else:
                obj = materialize(obj_wire)
                store_dict[key] = obj
                self._record_applied(chan, kind, key, obj, rv)

    # -------------------------------------------------------------- flushing
    def _flush_dirty(self) -> None:
        """Push every mirror object whose canonical bytes drifted from the
        server's last-known encoding (in-place mutations by controllers).
        Runs before every lease operation — at least once per tick.

        Cost note: this is an O(mirror) encode per lease operation — the
        full sweep is deliberate, because in-place mutations by design
        leave no hook to mark keys dirty; encoding is the only general
        detector.  The scan runs concurrently with the reconcile thread's
        unlocked in-place mutations, so a single object's encode can
        observe a torn state or raise (dict mutated during iteration):
        such objects are simply skipped this round — they are still dirty
        next round, and the background renewal retries within
        RETRY_PERIOD."""
        with self._mirror_lock:
            dirty = []
            for kind, (_cls, attr, key_fn) in STORE_KINDS.items():
                if kind == "Lease":
                    continue  # leases only move through the CAS RPCs
                for key, obj in list(getattr(self, attr).items()):
                    try:
                        enc = canonical(obj)
                    except RuntimeError:  # torn concurrent mutation
                        continue
                    if self._shadow.get((kind, key)) != enc:
                        dirty.append((kind, key, obj))
        for kind, key, obj in dirty:
            try:
                wire_obj = to_wire(obj)
            except RuntimeError:  # torn since the scan; next round
                continue
            try:
                self._forward(
                    {
                        "method": "put",
                        "kind": kind,
                        "obj": wire_obj,
                        "base_rv": self._rvs.get((kind, key), 0),
                    }
                )
            except StoreUnavailableError:
                raise  # the lease op turns this into abdication
            except Exception:
                # e.g. server-side validation rejecting one object must
                # not abort the rest of the flush or kill a renewal
                log.exception("flush of %s/%s failed; skipping", kind, key)

    # ------------------------------------------------------ overridden verbs
    def _put_and_forward(self, kind: str, obj, local_put) -> object:
        with self._mirror_lock:
            result = local_put(obj)
            base = self._rvs.get((kind, STORE_KINDS[kind][2](obj)), 0)
        # the live object rides the header; `_prep` tree-ifies it only
        # when the connection negotiated down to JSON
        self._forward(
            {"method": "put", "kind": kind, "obj": obj, "base_rv": base}
        )
        return result

    def put_pod(self, pod):
        return self._put_and_forward("Pod", pod, super().put_pod)

    def put_node(self, node):
        return self._put_and_forward("Node", node, super().put_node)

    def put_node_claim(self, claim):
        return self._put_and_forward("NodeClaim", claim, super().put_node_claim)

    def put_node_pool(self, pool):
        return self._put_and_forward("NodePool", pool, super().put_node_pool)

    def put_node_class(self, nc):
        return self._put_and_forward("NodeClass", nc, super().put_node_class)

    def put_storage_class(self, sc):
        return self._put_and_forward(
            "StorageClass", sc, super().put_storage_class
        )

    def put_pvc(self, pvc):
        return self._put_and_forward(
            "PersistentVolumeClaim", pvc, super().put_pvc
        )

    def put_pdb(self, pdb):
        return self._put_and_forward("PodDisruptionBudget", pdb, super().put_pdb)

    def _delete_and_forward(self, kind: str, key: str, local_delete) -> None:
        with self._mirror_lock:
            base = self._rvs.get((kind, key), 0)
            local_delete(key)
        # base_rv fences a deposed leader's straggler deletes exactly like
        # stale puts: the server rejects if someone wrote the object since
        self._forward(
            {"method": "delete", "kind": kind, "key": key, "base_rv": base}
        )

    def delete_pod(self, key: str) -> None:
        self._delete_and_forward("Pod", key, super().delete_pod)

    def delete_node(self, name: str) -> None:
        self._delete_and_forward("Node", name, super().delete_node)

    def delete_node_claim(self, name: str) -> None:
        self._delete_and_forward("NodeClaim", name, super().delete_node_claim)

    def bind_pod(self, key: str, node_name: str) -> None:
        with self._mirror_lock:
            base = self._rvs.get(("Pod", key), 0)
            super().bind_pod(key, node_name)
        self._forward(
            {
                "method": "bind_pod",
                "kind": "Pod",
                "key": key,
                "node_name": node_name,
                "base_rv": base,
            }
        )

    def evict_pod(self, key: str) -> None:
        with self._mirror_lock:
            base = self._rvs.get(("Pod", key), 0)
            super().evict_pod(key)
        self._forward(
            {"method": "evict_pod", "kind": "Pod", "key": key, "base_rv": base}
        )

    def record_event(self, kind, reason, obj_name, message=""):
        super().record_event(kind, reason, obj_name, message)
        with self._mirror_lock:
            # the cap applies to OWN events too, not just watch-absorbed
            # foreign ones (the server's echo of this event is skipped by
            # the event_rv check, so this is the only trim site for it)
            if len(self.events) > self.events_cap:
                del self.events[: len(self.events) - self.events_cap]
        header = {
            "method": "record_event",
            "kind": kind,
            "reason": reason,
            "obj_name": obj_name,
            "message": message,
        }
        chan = self._channels[self._owner_for(header)]
        try:
            response = self._rpc(header, shard=chan.index)
        except StoreUnavailableError as exc:
            # events are advisory; a store blip must not fail a reconcile
            log.warning("event %s/%s not recorded remotely: %s", kind, reason, exc)
            return
        chan.event_rv = max(chan.event_rv, response.get("event_rv", 0))

    # ---------------------------------------------------------------- leases
    # _lease_mutex serializes each lease operation END-TO-END (header
    # construction through _lease_rvs update): without it the background
    # renewal thread can read its base_rv, lose the CPU to the tick's
    # acquire (which bumps the server's lease_seq), and then land a
    # stale-base renewal — a spurious conflict that abdicates a healthy
    # leader mid-tick.

    @property
    def _lease_chan(self) -> StoreChannel:
        """Leases pin to LEASE_SHARD under every topology — the
        leadership CAS space lives on exactly one shard."""
        return self._channels[LEASE_SHARD if self._router.n > 1 else 0]

    def try_acquire_lease(self, name, holder, now, duration_s) -> bool:
        with self._lease_mutex:
            chan = self._lease_chan
            try:
                self._flush_dirty()
                response = self._rpc(
                    {
                        "method": "lease_acquire",
                        "name": name,
                        "holder": holder,
                        "now": now,
                        "duration_s": duration_s,
                    }
                )
            except StoreUnavailableError as exc:
                log.warning("lease acquire unavailable (%s); abdicating", exc)
                return False
            self._lease_rvs[name] = response.get("rv", 0)
            # a fresh acquire's broadcast event is not echoed back to the
            # originator, so credit exactly THAT event's rv here or
            # wait_synced stalls on our own acquires.  (Never the server's
            # global rv: that would claim sync for other replicas' events
            # still queued on our watch socket.)
            chan.synced_rv = max(
                chan.synced_rv, response.get("lease_event_rv", 0)
            )
            if response.get("lease") is not None:
                with self._mirror_lock:
                    lease = from_wire(response["lease"])
                    self.leases[name] = lease
                    # record rv/shadow too: an installed-but-untracked
                    # Lease reads as permanently dirty, which would make
                    # _absorb_events skip every later foreign Lease event
                    # and freeze a stale holder into this mirror forever
                    self._record_applied(
                        chan,
                        "Lease",
                        name,
                        lease,
                        max(
                            self._rvs.get(("Lease", name), 0),
                            response.get("lease_event_rv", 0),
                        ),
                    )
            return bool(response["acquired"])

    def renew_lease(self, name, holder, now) -> bool:
        with self._lease_mutex:
            try:
                self._flush_dirty()
                response = self._rpc(
                    {
                        "method": "lease_renew",
                        "name": name,
                        "holder": holder,
                        "now": now,
                        "base_rv": self._lease_rvs.get(name),
                    }
                )
            except StoreUnavailableError as exc:
                log.warning("lease renew unavailable (%s); abdicating", exc)
                return False
            self._lease_rvs[name] = response.get("rv", 0)
            chan = self._lease_chan
            chan.synced_rv = max(
                chan.synced_rv, response.get("lease_event_rv", 0)
            )
            return bool(response["renewed"])

    def release_lease(self, name, holder) -> None:
        with self._lease_mutex:
            chan = self._lease_chan
            try:
                self._flush_dirty()
                response = self._rpc(
                    {"method": "lease_release", "name": name, "holder": holder}
                )
                self._lease_rvs[name] = response.get("rv", 0)
                chan.synced_rv = max(
                    chan.synced_rv, response.get("lease_event_rv", 0)
                )
            except StoreUnavailableError as exc:  # best-effort: expiry fences
                log.warning("lease release unavailable (%s)", exc)
            with self._mirror_lock:
                lease = self.leases.get(name)
                if lease is not None and lease.holder == holder:
                    lease.holder = ""
                    lease.renewed_at = 0.0
                    # refresh the shadow so the mirror entry stays clean
                    # for later foreign Lease events (see try_acquire)
                    self._record_applied(
                        chan,
                        "Lease",
                        name,
                        lease,
                        self._rvs.get(("Lease", name), 0),
                    )

    # ----------------------------------------------------------------- watch
    def start_watch(self) -> None:
        self._watch_enabled = True
        for chan in self._channels:
            if chan.watch_thread is not None:
                continue
            chan.watch_thread = threading.Thread(
                target=self._watch_loop,
                args=(chan,),
                daemon=True,
                name=f"store-watch-{self.identity}-s{chan.index}",
            )
            chan.watch_thread.start()

    def _watch_loop(self, chan: StoreChannel) -> None:
        # the dial/handshake/backoff/resync choreography is the SHARED
        # watch-client primitive (service/watchclient.py — one
        # definition with the read-replica follower); this mirror
        # contributes the handshake contents, the frame handler, and
        # the byte-counting tx/rx.  One loop per shard channel: each
        # stream carries only its shard's keys and advances only its
        # shard's (epoch, seq) cursor.
        def dial():
            sock = socket.create_connection(
                (chan.host, chan.port), timeout=self.connect_timeout
            )
            sock.settimeout(self.request_timeout)
            return sock

        def hello() -> dict:
            # delta resync: present the last seq this mirror applied
            # from this shard's watch stream; the server replays just
            # the gap when its replay log still covers it, and falls
            # back to a full snapshot when compaction has passed us by
            return {
                "method": "watch",
                "identity": self.identity,
                "codecs": (
                    [CODEC_BIN, CODEC_JSON]
                    if self.codec == "auto"
                    else [CODEC_JSON]
                ),
                "schema_fp": SCHEMA_FP,
                "since_seq": chan.watch_seq,
                "epoch": chan.watch_epoch,
            }

        def set_live(sock) -> None:
            chan.watch_sock = sock

        WatchChannelClient(
            dial=dial,
            hello=hello,
            tx=lambda sock, payload: self._tx(sock, payload, CODEC_JSON),
            rx=self._rx,
            on_epoch=lambda epoch: self._note_epoch(chan, epoch),
            on_legacy_snapshot=lambda snap: self._apply_snapshot(chan, snap),
            on_frame=lambda frame, initial: self._handle_watch_frame(
                chan, frame, initial=initial
            ),
            stop=chan.stop,
            on_live=set_live,
            backoff_s=BACKOFF_S,
            pace=self._watch_pace,
        ).run()

    def _handle_watch_frame(
        self, chan: StoreChannel, frame: dict, initial: bool = False
    ) -> None:
        """One pushed watch frame: ordinary events, or a resync the
        server forced (reconnect gap, or this client fell so far behind
        that its bounded queue overflowed and was coalesced)."""
        ftype = frame.get("type")
        if ftype == "events":
            self._absorb_events(chan, frame.get("events", ()), remote=True)
            # frames arrive in seq order on one stream; assignment (not
            # max) lets a post-restart server's fresh, lower seq epoch
            # take over (see _apply_snapshot)
            chan.watch_seq = frame.get("seq", chan.watch_seq)
            return
        if ftype != "resync":
            return
        # a mid-stream resync may announce a NEW epoch (a read replica
        # that had to full-resync from a restarted primary rotates its
        # own) — the reset must land before the payload applies
        if "epoch" in frame:
            self._note_epoch(chan, str(frame.get("epoch") or ""))
        mode = frame.get("mode", "snapshot")
        first_sync = initial and not chan.ever_synced
        chan.ever_synced = True
        if not first_sync:
            # a genuine resync (not the very first state transfer):
            # count it and put it on the decision ledger — a mirror that
            # keeps resyncing is either too slow or repeatedly cut off
            self.watch_resyncs[mode] = self.watch_resyncs.get(mode, 0) + 1
            self.registry.inc(
                "karpenter_store_resync_total", {"kind": mode}
            )
            self.registry.event(
                "StoreResync", mode=mode, identity=self.identity
            )
        if mode == "snapshot":
            self._apply_snapshot(chan, frame["snapshot"])
        else:
            self._absorb_events(chan, frame.get("events", ()), remote=True)
        chan.watch_seq = frame.get("seq", chan.watch_seq)

    def _note_epoch(self, chan: StoreChannel, epoch: str) -> None:
        """Adopt the server's epoch id, resetting every old-space cursor
        the moment a CHANGE is detected — before any payload applies.
        Doing it at detection time (not at snapshot-apply time) matters:
        if the connection drops between the ack and the sync frame, the
        next reconnect must still present a new-epoch-consistent cursor
        (seq 0), never a new epoch label over an old-space seq that the
        busy new server's log might falsely 'cover'."""
        with self._mirror_lock:
            if epoch == chan.watch_epoch:
                return
            if chan.watch_epoch:
                # genuine epoch change: old-space cursors are meaningless
                chan.watch_seq = 0
                chan.synced_rv = 0
                # per-key rvs drop to 0 for CLEAN keys — 0 keeps the
                # snapshot deletion sweep working (the key is still
                # provably server-acked) while never vetoing adoption of
                # new-space rvs.  Dirty keys keep their entries and heal
                # through flush -> fence conflict -> adopt.  Only THIS
                # shard's keys: other shards' rv spaces didn't rotate.
                for (kind, key) in list(self._rvs):
                    if self._router.owner(kind, key) != chan.index:
                        continue
                    _cls, attr, _key_fn = STORE_KINDS[kind]
                    obj = getattr(self, attr).get(key)
                    if obj is None or not self._locally_dirty(
                        kind, key, obj
                    ):
                        self._rvs[(kind, key)] = 0
            chan.watch_epoch = epoch

    def _apply_snapshot(self, chan: StoreChannel, snap: dict) -> None:
        """Full-state resync for ONE shard: adopt the server's objects,
        drop mirror entries this shard owns that the server no longer
        has (store restart / reconnect).  The deletion sweep is
        ownership-restricted — shard i's snapshot says nothing about
        keys other shards hold.  Locally DIRTY entries are kept as-is —
        in-flight creates and unflushed in-place mutations reconcile
        through the next flush, never by a racing snapshot clobbering
        them (lost-update hazard)."""
        with self._mirror_lock:
            for kind, (_cls, attr, _key_fn) in STORE_KINDS.items():
                entries = snap["kinds"].get(kind, {})
                store_dict = getattr(self, attr)
                for key in list(store_dict):
                    # drop only keys the server has acknowledged before
                    # (recorded rv): an absent rv means an in-flight local
                    # create the server simply hasn't seen yet
                    if (
                        key not in entries
                        and (kind, key) in self._rvs
                        and self._router.owner(kind, key) == chan.index
                    ):
                        old = store_dict.pop(key)
                        self._record_applied(chan, kind, key, None, 0)
                        self._notify(kind, "delete", old)
                for key, entry in entries.items():
                    obj_wire, rv = entry["obj"], entry["rv"]
                    local = store_dict.get(key)
                    if local is not None and (
                        rv <= self._rvs.get((kind, key), 0)
                        or self._locally_dirty(kind, key, local)
                    ):
                        chan.synced_rv = max(chan.synced_rv, rv)
                        continue
                    server_obj = materialize(obj_wire)  # decoded once
                    if local is not None and canonical(local) == canonical(
                        server_obj
                    ):
                        self._record_applied(chan, kind, key, local, rv)
                        continue
                    store_dict[key] = server_obj
                    self._record_applied(chan, kind, key, server_obj, rv)
                    self._notify(kind, "put", server_obj)
            snap_events = snap.get("events", [])
            snap_event_rv = snap.get("event_rv", chan.event_rv)
            if self._router.n <= 1:
                # single shard: the server ledger IS the ledger — adopt
                # it wholesale.  The cap is an INVARIANT, not a
                # steady-state tendency: a snapshot from a server with a
                # larger ledger adopts only the newest events_cap entries
                self.events = [
                    materialize(e)
                    for e in snap_events[-self.events_cap :]
                ]
                chan.event_rv = snap_event_rv
            else:
                # merged ledger: this shard contributes only the events
                # the mirror hasn't credited from it yet (its event_rv
                # delta) — replacing would wipe the other shards' events
                fresh = snap_event_rv - chan.event_rv
                if fresh > 0:
                    for e in snap_events[-fresh:]:
                        self.events.append(materialize(e))
                    chan.event_rv = snap_event_rv
                    if len(self.events) > self.events_cap:
                        del self.events[
                            : len(self.events) - self.events_cap
                        ]
            # synced_rv MAXES: it also credits rvs from our own RPC
            # responses, which the origin-skipping watch stream never
            # echoes — assignment could regress below a racing own write
            # and stall wait_synced forever.  Epoch changes already
            # zeroed it in _note_epoch, so maxing never resurrects an
            # old space.  watch_seq assigns: only the watch stream
            # advances it, and in-epoch a snapshot's seq is >= anything
            # it delivered.
            chan.synced_rv = max(chan.synced_rv, snap.get("rv", 0))
            chan.watch_seq = snap.get("seq", 0)
            chan.ever_synced = True  # legacy path counts as a transfer too

    def wait_synced(self, min_rv: Optional[int] = None, timeout: float = 5.0) -> bool:
        """Block until the mirror has applied every server mutation up to
        ``min_rv`` (default: every shard's current rv).  Test/handoff
        helper: a standby asserts its mirror is warm before acting.

        With an explicit ``min_rv`` the aggregate high-water mark is
        compared (single-shard semantics — the caller got the target
        from one shard's response); with the default, each shard is
        statted and waited on in ITS OWN rv space."""
        if min_rv is None:
            targets = [
                (chan, self._rpc({"method": "stat"}, shard=chan.index)["rv"])
                for chan in self._channels
            ]
            synced = lambda: all(c.synced_rv >= t for c, t in targets)
        else:
            synced = lambda: self.synced_rv >= min_rv
        deadline = self.clock.now() + timeout
        while self.clock.now() < deadline:
            if synced():
                return True
            self.clock.sleep(0.005)
        return synced()

    # ------------------------------------------------------------- topology
    def apply_topology(self, addresses: Sequence[Tuple[str, int]]) -> None:
        """Re-point this client at a new shard topology (after a
        coordinator-driven reshard).  Tears down every channel (watch
        loops included), swaps the router atomically under the mirror
        lock, and resyncs from scratch cursors.  Per-key rvs are KEPT:
        they migrated with their keys server-side, so dirty-flush
        fencing still lines up at the new owners; the fresh channels'
        empty watch_epoch means the first epoch adoption does not zero
        them (see ``_note_epoch``)."""
        for chan in self._channels:
            chan.shutdown()
        with self._mirror_lock:
            self._channels = [
                StoreChannel(h, p, i) for i, (h, p) in enumerate(addresses)
            ]
            self._router = ShardRouter(len(self._channels))
        if self._watch_enabled and not self._stop.is_set():
            self.start_watch()

    def close(self) -> None:
        self._stop.set()
        for chan in self._channels:
            chan.shutdown()
