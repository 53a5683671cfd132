"""Reusable cluster invariants for the simulator (and the chaos suites).

Promotes the survival assertions that used to live copy-pasted inside
`tests/test_chaos.py` / `tests/test_election_storm.py` into one checker
the scenario runner evaluates after EVERY tick, plus the strict final
set once a run has drained.

Per-tick (`check_tick`) — hold even mid-fault:

- **no double launch**: live NodeClaims map 1:1 onto instances, and no
  two non-terminated instances carry the same nodeclaim attribution tag.
- **registered == launched**: every Node is backed by an instance the
  cloud actually launched, and no two Nodes share a provider id.
- **disruption budgets never exceeded**: within one disruption pass, new
  VOLUNTARY disruptions (expiration/drift/emptiness/consolidation) per
  pool never exceed the remaining budget the controller saw at the start
  of that pass — checked by wrapping the disruption controller's
  reconcile with the very same `remaining_disruption_budgets` arithmetic
  it gates on.  Involuntary marks (interruption notices, rollbacks) are
  exempt, exactly like the reference's budgets.
- **bounded leak window**: an instance running with no claim is only
  tolerable while the GC grace (MIN_INSTANCE_AGE) plus slack runs; past
  that — counted from the last disruptive moment, since a blackout can
  legitimately blind the GC sweep — it is a leak.
- **no pod pending past its deadline after faults clear**: every pod must
  schedule within `deadline_s` of max(its creation, the last disruptive
  moment) — the sim's scheduling SLO, sized to outlast the ICE mask TTL.

Final (`check_final`) — after drain + settle:

- no pending pods, running instances all claimed, every live claim's
  node registered, no controller wedged in backoff, all health gauges up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from karpenter_tpu_torch.controllers.disruption import remaining_disruption_budgets
from karpenter_tpu_torch.controllers.garbagecollection import MIN_INSTANCE_AGE

# pods carrying GANG_LABEL form an atomic gang (a multi-host TPU slice):
# at the end of any tick, either zero members or ALL of them (per
# GANG_SIZE_LABEL) must be placed — bound or holding a nomination.
# A partial slice is a wedged slice.
GANG_LABEL = "sim/gang"
GANG_SIZE_LABEL = "sim/gang-size"

# reasons that consume pool.disruption.budgets; everything else a
# "Disrupting" event can carry (interruption kinds, consolidation
# rollback) is involuntary or corrective and budget-exempt
_VOLUNTARY_BASES = frozenset({"expired", "drifted", "emptiness"})
_VOLUNTARY_EXACT = frozenset({"consolidation/delete", "consolidation/multi"})


def is_voluntary_disruption(reason: str) -> bool:
    return reason.split("/")[0] in _VOLUNTARY_BASES or reason in _VOLUNTARY_EXACT


@dataclass
class Violation:
    tick: int
    invariant: str
    detail: str

    def __str__(self) -> str:
        return f"tick {self.tick}: [{self.invariant}] {self.detail}"


class InvariantChecker:
    def __init__(
        self,
        env,
        deadline_s: float = 420.0,
        leak_slack_s: float = 90.0,
    ):
        self.env = env
        self.deadline_s = deadline_s
        self.leak_slack_s = leak_slack_s
        self.violations: List[Violation] = []
        self.checked_ticks = 0
        self.tick = -1
        # clock time a pending pod was created (runner feeds pod_create)
        self.pod_created: Dict[str, float] = {}
        # instance id -> clock time first seen running-but-unclaimed
        self._unclaimed_since: Dict[str, float] = {}
        # the last simulated moment anything disruptive was true (chaos
        # schedule active, interruption/kill/AZ event applied); deadline
        # and leak windows measure from here, not from absolute creation
        self.quiet_since: float = env.clock.now()
        # gang membership (GANG_LABEL pods), maintained from the same
        # watch: key -> (gang name, declared size)
        self._gang_pods: Dict[str, tuple] = {}
        # high-water mark of the admission fast path's mismatch counter:
        # the convergence contract says it stays 0, and the invariant
        # plane fails the run the tick it first moves
        self._fastpath_mismatch_seen = 0.0
        # a pod evicted (consolidation, drain) or re-pended by a node
        # deletion starts a FRESH scheduling wait — without re-arming, a
        # long-lived pod evicted late in a long run would instantly
        # "exceed" a deadline measured from its original creation
        env.kube.watch(self._on_kube_event)

    def _on_kube_event(self, kind: str, verb: str, obj) -> None:
        if kind != "Pod":
            return
        key = obj.key()
        if verb == "delete":
            self._gang_pods.pop(key, None)
            return
        if verb not in ("put", "evict"):
            return
        gang = getattr(obj, "labels", {}).get(GANG_LABEL)
        if gang:
            size = int(obj.labels.get(GANG_SIZE_LABEL, "0") or "0")
            self._gang_pods[key] = (gang, size)
        if getattr(obj, "phase", None) != "Pending" or obj.node_name:
            return
        if key in self.pod_created:
            self.pod_created[key] = self.env.clock.now()

    # ----------------------------------------------------------- wiring
    def attach(self, operator) -> None:
        """Wrap the disruption controller's reconcile so the budget
        invariant sees the EXACT pre-pass remaining budgets the
        controller itself computes from (same function, same moment)."""
        inner = operator.disruption.reconcile
        kube, cluster = operator.kube, operator.cluster

        def wrapped():
            pre = remaining_disruption_budgets(kube, cluster)
            pools = {c.name: c.pool_name for c in kube.node_claims.values()}
            n_events = len(kube.events)
            inner()
            marks: Dict[str, int] = {}
            for kind, reason_name, obj, msg in [
                (e[0], e[1], e[2], e[3]) for e in kube.events[n_events:]
            ]:
                if kind != "NodeClaim" or reason_name != "Disrupting":
                    continue
                if not is_voluntary_disruption(msg):
                    continue
                pool = pools.get(obj) or (
                    kube.node_claims[obj].pool_name
                    if obj in kube.node_claims
                    else ""
                )
                marks[pool] = marks.get(pool, 0) + 1
            for pool, n in marks.items():
                allowed = max(0, pre.get(pool, 0))
                if n > allowed:
                    self._fail(
                        "budgets",
                        f"pool {pool}: {n} voluntary disruptions in one "
                        f"pass, budget allowed {allowed}",
                    )

        operator.disruption.reconcile = wrapped

    def note_disruption(self, until: Optional[float] = None) -> None:
        """A disruptive event was applied (or a chaos window scheduled
        through `until`); pushes the quiet horizon forward."""
        now = self.env.clock.now()
        self.quiet_since = max(self.quiet_since, until if until else now)

    def note_pod(self, key: str) -> None:
        self.pod_created[key] = self.env.clock.now()

    def forget_pod(self, key: str) -> None:
        self.pod_created.pop(key, None)

    def _fail(self, invariant: str, detail: str) -> None:
        self.violations.append(Violation(self.tick, invariant, detail))
        self.env.registry.inc(
            "karpenter_sim_invariant_violations_total",
            {"invariant": invariant},
        )

    # ------------------------------------------------------------ checks
    def check_tick(self, tick: int) -> None:
        self.tick = tick
        self.checked_ticks += 1
        env = self.env
        kube, cloud = env.kube, env.cloud
        now = env.clock.now()

        # no double launch: live claims -> instances is injective ...
        seen: Dict[str, str] = {}
        for c in kube.node_claims.values():
            if not c.provider_id or c.deleted_at is not None:
                continue
            if c.provider_id in seen:
                self._fail(
                    "no-double-launch",
                    f"claims {seen[c.provider_id]} and {c.name} both "
                    f"backed by {c.provider_id}",
                )
            seen[c.provider_id] = c.name
        # ... and no two live instances claim the same NodeClaim tag
        by_tag: Dict[str, str] = {}
        for inst in cloud.instances.values():
            if inst.state == "terminated":
                continue
            tag = inst.tags.get("karpenter.sh/nodeclaim")
            if not tag:
                continue
            if by_tag.setdefault(tag, inst.id) != inst.id:
                self._fail(
                    "no-double-launch",
                    f"claim {tag} backed by {by_tag[tag]} AND {inst.id}",
                )

        # registered == launched: every Node is a real machine, uniquely
        by_pid: Dict[str, str] = {}
        for node in kube.nodes.values():
            if not node.provider_id:
                continue
            if node.provider_id not in cloud.instances:
                self._fail(
                    "registered-eq-launched",
                    f"node {node.name} registered for {node.provider_id}, "
                    "which the cloud never launched",
                )
            if by_pid.setdefault(node.provider_id, node.name) != node.name:
                self._fail(
                    "registered-eq-launched",
                    f"nodes {by_pid[node.provider_id]} and {node.name} "
                    f"share {node.provider_id}",
                )

        # bounded leak window (GC grace + slack, measured from quiet)
        claimed = {
            c.provider_id for c in kube.node_claims.values() if c.provider_id
        }
        running = {
            i.id for i in cloud.instances.values() if i.state == "running"
        }
        # sorted: violation order must not depend on set iteration order
        # (the vectorized plane in load/invariants.py emits the same
        # strings in the same order — cross-plane parity is tested)
        for iid in sorted(running - claimed):
            since = self._unclaimed_since.setdefault(iid, now)
            age = now - max(since, self.quiet_since)
            if age > MIN_INSTANCE_AGE + self.leak_slack_s:
                self._fail(
                    "no-leaked-instances",
                    f"instance {iid} unclaimed for {age:.0f}s "
                    f"(> {MIN_INSTANCE_AGE + self.leak_slack_s:.0f}s)",
                )
        for iid in list(self._unclaimed_since):
            if iid in claimed or iid not in running:
                del self._unclaimed_since[iid]

        # scheduling deadline, armed once the weather is quiet (sorted,
        # same cross-plane parity rule as the leak window above)
        pending = {p.key() for p in kube.pending_pods()}
        for key in sorted(pending):
            created = self.pod_created.get(key)
            if created is None:
                continue
            waited = now - max(created, self.quiet_since)
            if waited > self.deadline_s:
                self._fail(
                    "schedule-deadline",
                    f"pod {key} pending {waited:.0f}s after faults cleared "
                    f"(deadline {self.deadline_s:.0f}s)",
                )
        for key in list(self.pod_created):
            if key not in kube.pods:
                del self.pod_created[key]

        self._check_gangs()
        self._check_fastpath_convergence()

    def _check_fastpath_convergence(self) -> None:
        """The admission fast path's convergence contract: the device
        admit score must never disagree with the sequential host oracle
        (karpenter_admission_fastpath_mismatch_total stays 0).  Shared
        verbatim by the vectorized plane — one counter read, nothing to
        vectorize."""
        seen = self.env.registry.counter(
            "karpenter_admission_fastpath_mismatch_total"
        )
        if seen > self._fastpath_mismatch_seen:
            self._fail(
                "fastpath-convergence",
                f"karpenter_admission_fastpath_mismatch_total rose to "
                f"{int(seen)}: the admit dispatch disagreed with the "
                "sequential host oracle",
            )
            self._fastpath_mismatch_seen = seen

    def _check_gangs(self) -> None:
        """Gang atomicity: every gang must end the tick with zero or ALL
        members placed (bound to a node, or holding a nomination the
        kubelet will bind next step).  Shared verbatim by the vectorized
        plane — gangs are few, so there is nothing to vectorize."""
        if not self._gang_pods:
            return
        kube = self.env.kube
        cluster = self.env.cluster
        tally: Dict[str, List[int]] = {}
        for key, (gang, size) in sorted(self._gang_pods.items()):
            pod = kube.pods.get(key)
            if pod is None:
                continue
            placed = bool(pod.node_name) or (
                cluster.nominated_node(key) is not None
            )
            t = tally.setdefault(gang, [0, 0, size])
            t[0] += 1
            t[1] += int(placed)
            t[2] = max(t[2], size)
        for gang, (total, placed, size) in sorted(tally.items()):
            want = max(size, total)
            if 0 < placed < want:
                self._fail(
                    "gang-atomic",
                    f"gang {gang}: {placed}/{want} members placed "
                    "(slices land all-or-nothing)",
                )

    def check_final(self, controller_names) -> None:
        env = self.env
        self.tick = -2  # sentinel: final checks
        kube, cloud, op = env.kube, env.cloud, env.operator

        pending = [p.key() for p in kube.pending_pods()]
        if pending:
            self._fail("all-pods-scheduled", f"still pending: {pending}")

        running = {
            i.id for i in cloud.instances.values() if i.state == "running"
        }
        claimed = {
            c.provider_id for c in kube.node_claims.values() if c.provider_id
        }
        if not running <= claimed:
            self._fail(
                "no-leaked-instances", f"leaked: {sorted(running - claimed)}"
            )

        for c in kube.node_claims.values():
            if c.provider_id and c.deleted_at is None:
                if kube.node_by_provider_id(c.provider_id) is None:
                    self._fail(
                        "registered-eq-launched",
                        f"claim {c.name} launched {c.provider_id} but no "
                        "node ever registered",
                    )

        if op._ctrl_backoff:
            self._fail(
                "no-wedged-controller",
                f"still in requeue backoff: {sorted(op._ctrl_backoff)}",
            )
        for name in controller_names:
            healthy = env.registry.gauge(
                "karpenter_tpu_controller_healthy", {"controller": name}
            )
            # a missing gauge means the controller never completed a clean
            # reconcile at all — as wedged as an explicit 0
            if healthy != 1.0:
                self._fail(
                    "no-wedged-controller",
                    f"controller {name} unhealthy after recovery "
                    f"(gauge={healthy})",
                )

    def raise_on_violations(self) -> None:
        if self.violations:
            raise AssertionError(
                "invariant violations:\n"
                + "\n".join(str(v) for v in self.violations)
            )
