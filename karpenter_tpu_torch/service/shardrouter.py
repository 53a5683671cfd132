"""Key-space partitioning for the sharded store plane.

One store process scales reads (its read replicas) but every write still
funnels through one primary.  Sharding partitions the KEY SPACE instead:
N independent `StoreServer` primaries, each owning the keys that hash to
it, so writes scale with N while each shard keeps the whole store
machinery (bin1 codec, delta resyncs, bounded fan-out, durable replay
log) unchanged.

`ShardRouter` is the one definition of ownership — client
(`RemoteKubeStore` fans writes to owners and merges the shards' watch
streams) and migration coordinator both route through it:

- keys hash with blake2b (stable across processes and runs — routing is
  part of the deterministic surface; Python's salted ``hash()`` is not),
- **Leases are pinned to shard 0**: leadership CAS must be atomic in ONE
  place; a lease that could land on different shards under different
  topologies would let two leaders each "win" on their own shard,
- cluster events route by the object name they describe, so one
  object's event ordering stays within one shard's event_rv space.

`ShardCoordinator` drives topology changes (shard add/remove) with the
epoch fence: for every shard whose ownership shrinks, export the moving
keys (grouped by new owner), import them at their new owners, then drop
them at the source — import BEFORE drop, so a crash mid-migration
duplicates keys (reconciled by the fence) rather than losing them.
Both ``shard_import`` and ``shard_drop`` rotate the shard's epoch, so
every watch cursor minted before the migration is refused coverage and
forced onto a fresh resync — a cursor can never silently claim to span
a migration (docs/designs/store-scale.md, "Migration fence").
"""

from __future__ import annotations

import hashlib
import socket
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.service.codec import (
    CODEC_JSON,
    decode_payload,
    encode_payload,
    recv_frame,
    send_frame,
)

# the shard that owns every Lease, under EVERY topology
LEASE_SHARD = 0


def shard_of(kind: str, key: str, n: int) -> int:
    """The owner shard index for (kind, key) under an n-shard topology.
    Module-level and pure so server, client, and coordinator provably
    share one routing function."""
    if n <= 1:
        return 0
    if kind == "Lease":
        return LEASE_SHARD
    digest = hashlib.blake2b(
        f"{kind}/{key}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") % n


class ShardRouter:
    """Ownership under ONE topology.  Immutable — a topology change is
    a new router (clients swap routers atomically under their mirror
    lock, so no routing decision straddles two topologies)."""

    def __init__(self, n: int):
        self.n = max(1, n)

    def owner(self, kind: str, key: str) -> int:
        return shard_of(kind, key, self.n)


class ShardCoordinator:
    """Drives a reshard across live `StoreServer` shards over one-shot
    RPC sockets (tagged JSON — migration is a control-plane operation;
    the data plane's bin1 negotiation is irrelevant at this rate).

    ``reshard(old_addresses, new_addresses)`` moves every key whose
    owner changes, with per-shard begin/commit counters
    (``karpenter_store_shard_migration_begun_total`` /
    ``..._committed_total``) whose imbalance is the doctor's
    stuck-migration signal."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        connect_timeout: float = 5.0,
    ):
        self.registry = registry or Registry()
        self.connect_timeout = connect_timeout

    # ------------------------------------------------------------- transport
    def _call(self, address: Tuple[str, int], header: dict) -> dict:
        with socket.create_connection(
            address, timeout=self.connect_timeout
        ) as sock:
            sock.settimeout(self.connect_timeout)
            send_frame(sock, encode_payload(header, CODEC_JSON))
            response = decode_payload(recv_frame(sock), CODEC_JSON)
        if response.get("status") != "ok":
            raise RuntimeError(
                f"shard rpc {header.get('method')} to {address} failed: "
                f"{response.get('error')}"
            )
        return response

    # ------------------------------------------------------------- migration
    def reshard(
        self,
        old_addresses: Sequence[Tuple[str, int]],
        new_addresses: Sequence[Tuple[str, int]],
    ) -> Dict[str, int]:
        """Migrate from the old topology to the new one.  Every OLD
        shard exports the keys it no longer owns under the new hash,
        grouped by new owner; each group imports at its new owner, then
        the source drops the moved keys.  Returns migration stats."""
        new_n = len(new_addresses)
        moved = 0
        shards_migrated = 0
        for index, address in enumerate(old_addresses):
            self.registry.inc(
                "karpenter_store_shard_migration_begun_total",
                {"shard": str(index)},
            )
            export = self._call(
                address,
                {"method": "shard_export", "new_n": new_n},
            )
            entries_by_owner: Dict[str, List[dict]] = export.get(
                "entries", {}
            )
            dropped: List[List[str]] = []
            # IMPORT before DROP: a crash between the two duplicates
            # the moved keys (old owner still serves them under its old
            # epoch; the fence forces every client onto a resync that
            # re-routes), never loses them
            for owner_str, entries in sorted(entries_by_owner.items()):
                owner = int(owner_str)
                if owner == index or not entries:
                    continue
                self._call(
                    new_addresses[owner],
                    {"method": "shard_import", "entries": entries},
                )
                dropped.extend([e["kind"], e["key"]] for e in entries)
                moved += len(entries)
            if dropped:
                self._call(
                    address, {"method": "shard_drop", "keys": dropped}
                )
            self.registry.inc(
                "karpenter_store_shard_migration_committed_total",
                {"shard": str(index)},
            )
            shards_migrated += 1
        return {
            "moved_keys": moved,
            "shards_migrated": shards_migrated,
            "new_n": new_n,
        }
