"""Disk-backed replay log for the store plane (docs/designs/
store-scale.md, "Durability").

`VersionedStore` alone keeps its replay log in memory: a restarted
store process comes back as a NEW epoch with an empty log, so every
reconnecting client is forced onto a full snapshot — a fleet-wide
snapshot storm exactly when the plane is weakest.  `DurableReplayLog`
cursors that log to disk: every commit batch appends one length-prefixed
``bin1`` record, and a periodic checkpoint rewrites the segment as
(snapshot + tail), so a restarted `StoreServer` re-adopts its previous
epoch/seq space and serves *delta* resyncs from the recovered tail.

Record format (one segment file, records concatenated):

    [8B big-endian payload length][bin1 payload]

where the payload is the standard versioned ``encode_payload`` framing
(magic + codec version + one encoded value) of either:

- ``{"type": "checkpoint", "epoch", "seq", "rv", "event_rv",
  "lease_seq", "snapshot"}`` — a full-state snapshot; always the
  segment's FIRST record (checkpointing atomically replaces the file).
- ``{"type": "batch", "seq", "epoch", "events": [Raw...]}`` — one
  commit batch, events in the store's rendered bin form (the same bytes
  the watch fan-out ships).

Torn-tail rule: a crash mid-append leaves at most one truncated record
at the tail.  Recovery DROPS any record whose length prefix is
incomplete, whose declared length overruns the file, or whose payload
fails to decode — it is never decoded wrong, and nothing after a torn
record is trusted (a later record boundary found by luck inside garbage
is still garbage).  The durable prefix is exactly what fsync policy
guaranteed.

fsync policy (the chart's ``store.logFsync`` knob): ``"always"`` syncs
after every append (a crash loses nothing acknowledged), ``"off"``
leaves flushing to the OS (a crash may lose the unsynced tail — which
recovery then treats as torn).  The fsync call itself is an injectable
seam (``fsync_fn``) so the fleet-chaos harness can script an fsync
FAILURE deterministically: on the first OSError the log marks itself
failed, stops appending, and counts
``karpenter_store_log_failures_total`` — the in-memory store keeps
serving (availability) while restart durability degrades to the last
synced prefix, which is exactly what a real disk failure means.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.analysis.sanitizer import make_lock, note_blocking
from karpenter_tpu_torch.service.codec import (
    CODEC_BIN,
    decode_payload,
    encode_payload,
)

log = logging.getLogger(__name__)

# rewrite the segment as (checkpoint + empty tail) after this many batch
# records: bounds both recovery time and segment growth.  Deliberately
# larger than the in-memory replay bound — the disk tail is what makes a
# RESTARTED store serve deltas, so it should cover at least as much
# history as the live log does.
CHECKPOINT_EVERY_BATCHES = 1024

FSYNC_ALWAYS = "always"
FSYNC_OFF = "off"


def read_segment(path: str) -> Tuple[List[dict], int]:
    """Scan one segment file, applying the torn-tail rule.  Returns
    ``(records, torn)`` where ``torn`` counts the dropped tail records
    (0 or 1 in practice — everything after the first tear is dropped as
    one unit).  Malformed bytes surface as a DROP, never as an
    ``IndexError`` or a wrongly-decoded record."""
    try:
        blob = open(path, "rb").read()
    except FileNotFoundError:
        return [], 0
    records: List[dict] = []
    pos = 0
    while pos < len(blob):
        if pos + 8 > len(blob):
            return records, 1  # torn length prefix
        (size,) = struct.unpack(">Q", blob[pos : pos + 8])
        if pos + 8 + size > len(blob):
            return records, 1  # declared length overruns the file
        try:
            rec = decode_payload(blob[pos + 8 : pos + 8 + size], CODEC_BIN)
        except ValueError:
            return records, 1  # undecodable payload: torn mid-record
        if not isinstance(rec, dict) or "type" not in rec:
            return records, 1
        records.append(rec)
        pos += 8 + size
    return records, 0


class DurableReplayLog:
    """One store shard's crash-durable replay segment.

    The owning ``VersionedStore`` calls ``append_batch`` under its own
    lock at every commit and ``write_checkpoint`` at epoch rotations;
    auto-checkpointing (every ``checkpoint_every`` batches) is driven by
    the store too, so the snapshot renders under the store lock where
    live objects are safe to encode.  The log's own lock only orders the
    file writes against ``close`` (appends are already serialized by the
    store lock; a second writer process is out of scope — one segment,
    one store)."""

    def __init__(
        self,
        path: str,
        fsync: str = FSYNC_ALWAYS,
        fsync_fn: Optional[Callable[[int], None]] = None,
        checkpoint_every: int = CHECKPOINT_EVERY_BATCHES,
        registry=None,
    ):
        self.path = path
        self.fsync = fsync
        # the injectable fsync seam: the chaos harness swaps in a
        # failing callable; production keeps os.fsync
        self.fsync_fn = fsync_fn or os.fsync
        self.checkpoint_every = max(1, checkpoint_every)
        self.registry = registry  # re-bound by the owning store/server
        self._lock = make_lock("DurableReplayLog._lock")
        self._fh = None
        self.failed = False
        self.batches_since_checkpoint = 0
        self.torn_records = 0

    # ------------------------------------------------------------- recovery
    def recover(self) -> Tuple[Optional[dict], List[dict]]:
        """Read the segment back: ``(checkpoint, batches)``.  The LAST
        checkpoint record wins (there is at most one per segment — the
        checkpointer atomically replaces the file — but a segment
        hand-edited or produced by an older build must not confuse
        recovery); batch records before it are superseded, batch records
        after it in ITS epoch with ascending seq are the durable tail."""
        records, torn = read_segment(self.path)
        self.torn_records = torn
        if torn:
            self._count("karpenter_store_log_torn_records_total", torn)
        checkpoint: Optional[dict] = None
        batches: List[dict] = []
        for rec in records:
            if rec["type"] == "checkpoint":
                checkpoint = rec
                batches = []
            elif rec["type"] == "batch":
                if checkpoint is not None and (
                    rec.get("epoch") != checkpoint.get("epoch")
                    or rec.get("seq", 0) <= checkpoint.get("seq", 0)
                ):
                    continue  # another epoch's stray tail: superseded
                if batches and rec.get("seq", 0) != batches[-1]["seq"] + 1:
                    # a seq gap means the segment is internally
                    # inconsistent — trust only the contiguous prefix
                    break
                batches.append(rec)
        return checkpoint, batches

    # ------------------------------------------------------------- appending
    def _open(self):
        if self._fh is None:
            self._fh = open(self.path, "ab")
        return self._fh

    def _write_record(self, fh, record: dict) -> int:
        payload = encode_payload(record, CODEC_BIN)
        fh.write(struct.pack(">Q", len(payload)) + payload)
        return len(payload) + 8

    def append_batch(self, seq: int, epoch: str, events) -> None:
        """Append one commit batch.  Called under the store lock (the
        rendered ``events`` are immutable ``Raw`` bytes, so only the
        file write itself happens here).  A failed log never raises into
        the commit path: the store stays available; durability degrades
        to the synced prefix and the failure is counted."""
        if self.failed:
            return
        note_blocking("storelog_append")
        with self._lock:
            try:
                fh = self._open()
                n = self._write_record(
                    fh, {"type": "batch", "seq": seq, "epoch": epoch,
                         "events": list(events)}
                )
                fh.flush()
                if self.fsync == FSYNC_ALWAYS:
                    self.fsync_fn(fh.fileno())
            except OSError as exc:
                self._fail(exc)
                return
            self.batches_since_checkpoint += 1
            self._count("karpenter_store_log_bytes_total", n)
            self._count("karpenter_store_log_records_total", 1)

    def checkpoint_due(self) -> bool:
        return (
            not self.failed
            and self.batches_since_checkpoint >= self.checkpoint_every
        )

    def write_checkpoint(
        self,
        epoch: str,
        seq: int,
        rv: int,
        event_rv: int,
        lease_seq: Dict[str, int],
        snapshot: dict,
    ) -> None:
        """Atomically replace the segment with one checkpoint record:
        write a temp file, fsync it, ``os.replace`` over the segment.
        A crash at ANY point leaves either the old segment or the new
        one — never a half-checkpoint (the rename is the commit)."""
        if self.failed:
            return
        note_blocking("storelog_checkpoint")
        with self._lock:
            tmp = self.path + ".tmp"
            try:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                with open(tmp, "wb") as fh:
                    self._write_record(
                        fh,
                        {
                            "type": "checkpoint",
                            "epoch": epoch,
                            "seq": seq,
                            "rv": rv,
                            "event_rv": event_rv,
                            "lease_seq": dict(lease_seq),
                            "snapshot": snapshot,
                        },
                    )
                    fh.flush()
                    if self.fsync != FSYNC_OFF:
                        self.fsync_fn(fh.fileno())
                os.replace(tmp, self.path)
            except OSError as exc:
                self._fail(exc)
                return
            self.batches_since_checkpoint = 0
            self._count("karpenter_store_log_checkpoints_total", 1)

    # ------------------------------------------------------------- plumbing
    def _fail(self, exc: BaseException) -> None:
        # first failure wins; the log goes inert (appends no-op) so a
        # dead disk degrades durability, never availability
        log.error("durable replay log %s failed: %s", self.path, exc)
        self.failed = True
        self._count("karpenter_store_log_failures_total", 1)
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _count(self, metric: str, by: int) -> None:
        if self.registry is not None:
            self.registry.inc(metric, by=by)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
