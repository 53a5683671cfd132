"""Vectorized invariant checking: the per-tick suite as array ops.

`sim/invariants.py` walks claims/instances/nodes/pods with Python dict
scans and per-element set algebra — O(cluster) Python per tick, the
second bottleneck (after generation) at million-event scale.
`VectorInvariantChecker` keeps the exact same CONTRACT while moving the
set algebra onto numpy:

- string ids (provider ids, instance ids, claim tags) are interned to
  dense int codes once, ever (the interner is append-only), so each
  tick's uniqueness/membership questions are `np.unique`/`np.isin`
  over int64 columns;
- the pending-pod set is an INCREMENTAL mirror maintained from the
  KubeStore watch stream (put/bind/evict/delete verbs), so the deadline
  check never rescans the pod dict;
- violation FORMATTING stays scalar Python — violations are rare, and
  the emitted `Violation` strings (and their order) must match the
  scalar plane byte-for-byte.  Partner-attribution semantics are
  replicated exactly: duplicate-claim reports name the PREVIOUS
  occurrence (the scalar `seen[pid] = name` overwrite), duplicate-tag
  and duplicate-node reports name the FIRST (the scalar `setdefault`).

The budget invariant (an `attach` wrap around the disruption
controller), the gang-atomicity check, and `check_final` are inherited
from the scalar class unchanged — they are O(pass outcomes), not
O(cluster).  Cross-validation (both planes over the same run produce
identical violations AND identical byte traces, forged corruptions
caught by both) lives in tests/test_load.py.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from karpenter_tpu_torch.controllers.garbagecollection import MIN_INSTANCE_AGE
from karpenter_tpu_torch.sim.invariants import InvariantChecker


class _Interner:
    """Append-only string -> dense int code table (and back)."""

    __slots__ = ("_ids", "_names")

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._names: List[str] = []

    def code(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._names)
            self._ids[s] = i
            self._names.append(s)
        return i

    def name(self, i: int) -> str:
        return self._names[i]


class VectorInvariantChecker(InvariantChecker):
    def __init__(self, env, deadline_s: float = 420.0, leak_slack_s: float = 90.0):
        super().__init__(env, deadline_s=deadline_s, leak_slack_s=leak_slack_s)
        self._ids = _Interner()
        # incremental pending-pod mirror (watch-maintained); seeded with
        # whatever is already pending — the watch only sees changes
        self._pending = {p.key() for p in env.kube.pending_pods()}

    def _on_kube_event(self, kind: str, verb: str, obj) -> None:
        super()._on_kube_event(kind, verb, obj)
        if kind != "Pod":
            return
        key = obj.key()
        if verb == "delete":
            self._pending.discard(key)
            # scalar plane prunes pod_created by scanning kube.pods each
            # tick; the watch delete IS that condition, incrementally
            self.pod_created.pop(key, None)
        elif verb == "bind":
            self._pending.discard(key)
        elif verb in ("put", "evict"):
            if getattr(obj, "phase", None) == "Pending" and not obj.node_name:
                self._pending.add(key)
            else:
                self._pending.discard(key)

    # ------------------------------------------------------------ checks
    def check_tick(self, tick: int) -> None:
        self.tick = tick
        self.checked_ticks += 1
        env = self.env
        kube, cloud = env.kube, env.cloud
        now = env.clock.now()
        ids = self._ids
        env.registry.inc("karpenter_load_vector_checked_ticks_total")

        # no double launch: live claims -> instances is injective
        claim_names: List[str] = []
        claim_codes: List[int] = []
        for c in kube.node_claims.values():
            if c.provider_id and c.deleted_at is None:
                claim_names.append(c.name)
                claim_codes.append(ids.code(c.provider_id))
        pid = np.asarray(claim_codes, dtype=np.int64)
        if pid.size:
            uniq, inv, counts = np.unique(
                pid, return_inverse=True, return_counts=True
            )
            if uniq.size != pid.size:
                prev: Dict[int, int] = {}
                for i in np.flatnonzero(counts[inv] > 1):
                    code = int(pid[i])
                    if code in prev:
                        self._fail(
                            "no-double-launch",
                            f"claims {claim_names[prev[code]]} and "
                            f"{claim_names[i]} both backed by {ids.name(code)}",
                        )
                    prev[code] = int(i)

        # ... and no two live instances claim the same NodeClaim tag.
        # One pass over the instance dict also collects the running set
        # for the leak window below.
        tag_codes: List[int] = []
        tag_insts: List[str] = []
        running_codes: List[int] = []
        for inst in cloud.instances.values():
            if inst.state == "running":
                running_codes.append(ids.code(inst.id))
            if inst.state == "terminated":
                continue
            tag = inst.tags.get("karpenter.sh/nodeclaim")
            if tag:
                tag_codes.append(ids.code(tag))
                tag_insts.append(inst.id)
        tags = np.asarray(tag_codes, dtype=np.int64)
        if tags.size:
            uniq, inv, counts = np.unique(
                tags, return_inverse=True, return_counts=True
            )
            if uniq.size != tags.size:
                first: Dict[int, int] = {}
                for i in np.flatnonzero(counts[inv] > 1):
                    code = int(tags[i])
                    j = first.setdefault(code, int(i))
                    if j != i:
                        self._fail(
                            "no-double-launch",
                            f"claim {ids.name(code)} backed by "
                            f"{tag_insts[j]} AND {tag_insts[i]}",
                        )

        # registered == launched: every Node is a real machine, uniquely
        node_names: List[str] = []
        node_codes: List[int] = []
        for node in kube.nodes.values():
            if node.provider_id:
                node_names.append(node.name)
                node_codes.append(ids.code(node.provider_id))
        npid = np.asarray(node_codes, dtype=np.int64)
        if npid.size:
            launched = np.asarray(
                [ids.code(iid) for iid in cloud.instances], dtype=np.int64
            )
            ghost = ~np.isin(npid, launched)
            uniq, inv, counts = np.unique(
                npid, return_inverse=True, return_counts=True
            )
            dup = counts[inv] > 1
            if ghost.any() or dup.any():
                first = {}
                for i in np.flatnonzero(ghost | dup):
                    code = int(npid[i])
                    if ghost[i]:
                        self._fail(
                            "registered-eq-launched",
                            f"node {node_names[i]} registered for "
                            f"{ids.name(code)}, which the cloud never "
                            "launched",
                        )
                    if dup[i]:
                        j = first.setdefault(code, int(i))
                        if j != i:
                            self._fail(
                                "registered-eq-launched",
                                f"nodes {node_names[j]} and {node_names[i]} "
                                f"share {ids.name(code)}",
                            )

        # bounded leak window: running instances not covered by ANY
        # claim's provider id (deleted claims still count as cover)
        claimed_codes = np.asarray(
            sorted(
                ids.code(c.provider_id)
                for c in kube.node_claims.values()
                if c.provider_id
            ),
            dtype=np.int64,
        )
        run = np.asarray(running_codes, dtype=np.int64)
        unclaimed = (
            run[~np.isin(run, claimed_codes)] if run.size else run
        )
        if unclaimed.size:
            for iid in sorted(ids.name(int(c)) for c in unclaimed):
                since = self._unclaimed_since.setdefault(iid, now)
                age = now - max(since, self.quiet_since)
                if age > MIN_INSTANCE_AGE + self.leak_slack_s:
                    self._fail(
                        "no-leaked-instances",
                        f"instance {iid} unclaimed for {age:.0f}s "
                        f"(> {MIN_INSTANCE_AGE + self.leak_slack_s:.0f}s)",
                    )
        if self._unclaimed_since:
            still = {ids.name(int(c)) for c in unclaimed}
            for iid in list(self._unclaimed_since):
                if iid not in still:
                    del self._unclaimed_since[iid]

        # scheduling deadline over the incremental pending mirror
        if self._pending:
            keys = sorted(self._pending)
            created = np.array(
                [self.pod_created.get(k, math.inf) for k in keys],
                dtype=np.float64,
            )
            # pods the sim never announced (inf) yield -inf waits: the
            # scalar plane's "created is None: continue"
            waited = now - np.maximum(created, self.quiet_since)
            for i in np.flatnonzero(waited > self.deadline_s):
                self._fail(
                    "schedule-deadline",
                    f"pod {keys[i]} pending {waited[i]:.0f}s after faults "
                    f"cleared (deadline {self.deadline_s:.0f}s)",
                )

        self._check_gangs()
        self._check_fastpath_convergence()
