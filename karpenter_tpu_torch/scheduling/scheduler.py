"""The reference scheduling oracle: first-fit-decreasing simulation.

Re-derivation of karpenter-core's provisioning scheduler (reference
designs/bin-packing.md:18-42; website v0.31 concepts/scheduling.md): sort
pending pods by descending size, place each onto (a) an existing/in-flight
node, else (b) an open virtual node whose feasible instance-type set narrows
as pods accumulate, else (c) a new virtual node from the highest-weight
compatible NodePool.  Taints/tolerations, label requirements, zonal
offerings, topology spread, and pod (anti-)affinity all constrain placement.

This pure-Python packer is the correctness oracle and the <= node-count
baseline for the batched solver (scheduling/solver.py; port copy of
``karpenter_tpu/scheduling/scheduler.py``); it is also what
consolidation reuses to simulate evicted-pod rescheduling.
"""

from __future__ import annotations

import itertools

import numpy as np
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from karpenter_tpu_torch.api import (
    InstanceType,
    NodePool,
    Pod,
    Requirement,
    Requirements,
    Resources,
)
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import tolerates_all
from karpenter_tpu_torch.api.requirements import Op
from karpenter_tpu_torch.scheduling.topology import HOSTNAME, NEW_DOMAIN, ZONE, TopologyTracker
from karpenter_tpu_torch.state.cluster import StateNode

_vnode_seq = itertools.count()

# sentinel `_headroom_key`: the decode attached a headroom bound computed
# from the compiled alloc tensor while the node's widen_thunk is pending
PENDING_WIDEN = object()


def _zone_constrained(pod: Pod, include_soft: bool = True) -> bool:
    """Pod carries a zone-keyed topology constraint (spread or affinity).

    ScheduleAnyway spreads count only while ``include_soft`` — karpenter
    honors them as required until the pod proves unschedulable, then
    relaxes (the same two-phase walk preferences ride)."""
    return any(
        c.topology_key == ZONE
        and c.selects(pod)
        and (include_soft or c.when_unsatisfiable == "DoNotSchedule")
        for c in pod.topology_spread
    ) or any(t.topology_key == ZONE for t in pod.pod_affinity)


_NO_KEYS: tuple = ((), ())


def _spread_pin_keys(pod: Pod, topology: TopologyTracker, preferred: bool):
    """(own, counted) CUSTOM topology keys a placement must pin/record:
    ``own`` — keys of the pod's active spread constraints (missing node
    label = invalid domain, reject); ``counted`` — keys of registered
    groups that merely COUNT this pod (record if the node has the label,
    never reject).  The no-custom-keys case (virtually every workload)
    exits on two cheap checks — this runs per try_add probe."""
    tracked = topology.custom_spread_keys()
    if not tracked and not pod.topology_spread:
        return _NO_KEYS
    own = [
        c.topology_key
        for c in pod.topology_spread
        if c.topology_key not in (HOSTNAME, ZONE) and c.selects(pod)
        and (preferred or c.when_unsatisfiable == "DoNotSchedule")
    ]
    if not tracked and not own:
        return _NO_KEYS
    counted = [
        key
        for key in tracked
        if key not in own and topology.selected_by_group(pod, key)
    ]
    return own, counted


def pod_sort_key(pod: Pod) -> Tuple:
    """Descending-size FFD order; most-constrained (affinity/topology) pods
    first so their narrow placements aren't crowded out."""
    constrained = bool(pod.pod_affinity or pod.topology_spread)
    return (
        not constrained,
        -pod.priority,
        -(pod.requests.cpu + pod.requests.memory / (4 * 2**30)),
    )


@dataclass
class VirtualNode:
    """A node being composed during the solve (karpenter-core's inflight
    scheduling.Node)."""

    pool: NodePool
    requirements: Requirements
    feasible_types: List[InstanceType]
    daemon_overhead: Resources
    name: str = ""
    pods: List[Pod] = field(default_factory=list)
    used: Resources = field(default_factory=Resources)
    # deferred launch-flexibility widening (tensor decode attaches it): the
    # full price-ordered alternate-type list is only needed per LAUNCHED
    # node, so computing it inside the solve would tax every decoded node
    # on the 200ms critical path
    widen_thunk: Optional[object] = None
    # (pod constraint shape, zone choice) -> types passing the label /
    # offering compatibility scan.  The scan result is per pod SHAPE, not
    # per pod — cleared whenever a commit narrows this node's requirements
    _fit_cache: Dict = field(default_factory=dict)
    # per-axis max allocatable over feasible_types, keyed by list identity
    # (commits replace the list): the O(axes) headroom gate that rejects
    # probes against full nodes before any Requirements work.  The tensor
    # decode attaches `_headroom_thunk` instead of the dict (lazy, like
    # the widen): the first probe materializes it
    _headroom: Optional[Dict[str, float]] = None
    _headroom_key: Optional[object] = None
    _headroom_thunk: Optional[object] = None
    # cross-NODE scan memo (Scheduler-owned, attached at node creation):
    # (feasible-list identity, requirements snapshot) -> candidate entry.
    # Fresh nodes share the pool template list, and all-fit commits keep
    # the list identity (see the no-copy return below), so the label scan
    # for a recurring (list, reqs) pair runs once per SOLVER lifetime
    # instead of once per (node, shape)
    _scan_memo: Optional[Dict] = None

    def __post_init__(self):
        if not self.name:
            self.name = f"vnode-{next(_vnode_seq)}"
        self.used = self.used + self.daemon_overhead

    def _headroom_admits(self, requests: Resources) -> bool:
        """Cheap upper-bound check: could ANY feasible type hold this
        node's load plus `requests`?  A miss here is definitive (the full
        scan compares against the same allocatable vectors), and in a
        continued solve most probes hit nodes the tensor pass already
        filled — rejecting them without touching Requirements is the
        oracle loop's hottest shortcut."""
        if self.widen_thunk is not None and self._headroom_key is PENDING_WIDEN:
            # decode attached a vectorized upper bound over the yet-unwidened
            # type set, so a failing probe doesn't force the widen; it may
            # only OVER-admit (the full scan still decides), and only covers
            # the compiled axes — anything else falls through to the thunk
            hi = self._headroom
            if hi is None and self._headroom_thunk is not None:
                hi = self._headroom = self._headroom_thunk()
                # drop the closure either way: it pins the per-node
                # class_feas row and the compile arrays
                self._headroom_thunk = None
                if hi is None:  # no openable config admits this node's mix
                    self._headroom_key = None
            if hi is not None and all(a in hi for a, _ in requests.items()):
                for axis, v in requests.items():
                    if v + self.used.get(axis) > hi[axis] + 1e-9:
                        return False
                return True
        ft = self.feasible_types
        if self._headroom_key is not ft:
            # raw dict pass, not Resources.merge_max: the rebuild runs on
            # every commit (feasible_types is replaced), and one Resources
            # allocation per type measurably taxes the oracle's hot loop
            hi: Dict[str, float] = {}
            for t in ft:
                for axis, v in t.allocatable().items():
                    if v > hi.get(axis, 0.0):
                        hi[axis] = v
            self._headroom = hi
            self._headroom_key = ft
        hi = self._headroom
        for axis, v in requests.items():
            if v + self.used.get(axis) > hi.get(axis, 0.0) + 1e-9:
                return False
        return True

    # (hi_cpu, hi_mem, hi_pods) computed once per node: a STALE upper
    # bound (type narrowing only shrinks the true value), so the inline
    # prefilter in _schedule_open_vnode may over-admit — try_add still
    # decides — but never wrongly rejects.  The pods axis matters: a
    # dense pack fills node POD SLOTS before cpu/memory, and a
    # cpu/mem-only prefilter would pass every slot-full node through to
    # try_add
    _hi2: Optional[Tuple[float, float, float]] = None

    def hi_cpu_mem(self) -> Tuple[float, float, float]:
        if self._hi2 is None:
            if (
                self.widen_thunk is not None
                and self._headroom is None
                and self._headroom_thunk is not None
            ):
                self._headroom = self._headroom_thunk()
                self._headroom_thunk = None
                if self._headroom is None:
                    self._headroom_key = None
            if self.widen_thunk is None:
                # materialized list: the tight bound (and commits narrow
                # it, so rebuilding here is what invalidation buys)
                cpu = mem = pods = 0.0
                for t in self.feasible_types:
                    a = t.allocatable()
                    if (c := a.get("cpu")) > cpu:
                        cpu = c
                    if (v := a.get("memory")) > mem:
                        mem = v
                    if (p := a.get("pods")) > pods:
                        pods = p
                self._hi2 = (cpu, mem, pods)
            elif self._headroom:
                hi = self._headroom
                self._hi2 = (
                    hi.get("cpu", float("inf")),
                    hi.get("memory", float("inf")),
                    hi.get("pods", float("inf")),
                )
            else:  # no decode hint and a pending widen: stay permissive
                self._hi2 = (float("inf"), float("inf"), float("inf"))
        return self._hi2

    # -- helpers -------------------------------------------------------------
    def zone_options(self) -> Set[str]:
        """Zones this node could still land in: zone requirement x available
        offerings of the still-feasible types."""
        zr = self.requirements.get(ZONE)
        zones: Set[str] = set()
        for t in self.feasible_types:
            for o in t.offerings.available():
                if zr is None or zr.has(o.zone):
                    zones.add(o.zone)
        return zones

    def _fits_some_type(
        self,
        reqs: Requirements,
        used: Resources,
        cache_key: Optional[Tuple] = None,
    ) -> List[InstanceType]:
        ent = self._fit_cache.get(cache_key) if cache_key is not None else None
        if ent is None:
            memo = self._scan_memo
            mkey = None
            if memo is not None:
                # CONTENT key: commits replace the list object, but the
                # narrowed lists repeat identically across solves (the
                # pack is deterministic), so keying on the member type
                # identities lets a later solve reuse this scan.  The
                # reqs half is an immutable snapshot so an in-place
                # mutation of a Requirements object can never corrupt
                # the memo; the value pins the list (and so the types),
                # keeping both id sets stable.
                mkey = (
                    tuple(map(id, self.feasible_types)),
                    frozenset(reqs._reqs.items()),
                )
                got = memo.get(mkey)
                if got is not None:
                    ent = got[1]
        if ent is None:
            # offering admission with the zone/capacity-type requirements
            # hoisted OUT of the per-type loop: the old per-type
            # `offerings.available().compatible(reqs)` built two list
            # objects and re-fetched both requirements per type, which
            # dominated the oracle continuation's cache-miss scans
            zr = reqs.get(ZONE)
            cr = reqs.get(L.LABEL_CAPACITY_TYPE)
            if zr is None and cr is None:
                cand = [
                    t
                    for t in self.feasible_types
                    if any(o.available for o in t.offerings)
                    and t.requirements.compatible(reqs, allow_undefined=True)
                ]
            else:
                cand = [
                    t
                    for t in self.feasible_types
                    if any(
                        o.available
                        and (zr is None or zr.has(o.zone))
                        and (cr is None or cr.has(o.capacity_type))
                        for o in t.offerings
                    )
                    and t.requirements.compatible(reqs, allow_undefined=True)
                ]
            ent = (cand, {})
            if mkey is not None:
                if len(memo) > 20_000:
                    memo.clear()  # unbounded-workload backstop
                memo[mkey] = (self.feasible_types, ent)
        if cache_key is not None:
            self._fit_cache[cache_key] = ent
        cand, mats = ent
        if not cand:
            return []
        # one vectorized compare over the candidate list's allocatable
        # matrix instead of a per-type Resources.fits walk
        items = sorted(used._q.items())
        axes = tuple(k for k, _ in items)
        mat = mats.get(axes)
        if mat is None:
            mats[axes] = mat = np.array(
                [[t.allocatable().get(a) for a in axes] for t in cand],
                dtype=np.float64,
            )
        vec = np.array([v for _, v in items])
        mask = (vec <= mat + 1e-9).all(axis=1)
        if mask.all():
            # no copy: commits replace feasible_types wholesale and no
            # caller mutates the returned list in place
            return cand
        return [t for t, ok in zip(cand, mask) if ok]

    def try_add(
        self,
        pod: Pod,
        topology: TopologyTracker,
        preferred: bool = True,
        term: int = 0,
        reserve: Optional[Resources] = None,
        keep_prefs: Optional[int] = None,
    ) -> bool:
        """``reserve``: a co-location ANCHOR reserves its whole group's
        total — the node must admit the sum (and its type set narrows to
        types that hold it) while only the anchor's own requests commit.
        Prevents anchoring a group on a nearly-full node that strands the
        followers (kube-scheduler would strand them too, but a fresh node
        that holds everyone is the better pack when one exists).
        ``keep_prefs``: the preference-peel attempt (see
        Pod.scheduling_requirements)."""
        if not tolerates_all(pod.tolerations, self.pool.taints):
            return False
        if not self._headroom_admits(reserve if reserve is not None else pod.requests):
            return False
        # topology next: hostname-keyed constraints treat this node as a
        # domain; a node with no pods yet is a fresh domain (NEW_DOMAIN).
        # Checked before the Requirements merge because, after the
        # headroom gate, it is the cheapest remaining rejection — a
        # co-location follower probes every open node and all but its
        # anchor fail here.
        host_allowed = topology.allowed_domains(pod, HOSTNAME, preferred, term)
        if host_allowed is not None and self.name not in host_allowed:
            if not (NEW_DOMAIN in host_allowed and not self.pods):
                return False
        reqs = Requirements(iter(self.requirements))
        for r in pod.scheduling_requirements(
            preferred=preferred, term=term, keep_prefs=keep_prefs
        ):
            reqs.add(r)
        if reqs.is_unsatisfiable():
            return False
        # CUSTOM topology keys (any node label beyond zone/hostname,
        # reference scheduling.md:319-331): the node's candidate values
        # come from its merged requirements (pool templates carry the
        # label), the pod pins the least-loaded allowed value, and the
        # placement records the domain so group counts stay exact.  A
        # node whose pool doesn't define the label is not a valid domain.
        custom_pins: Tuple = ()
        own_keys, counted_keys = _spread_pin_keys(pod, topology, preferred)
        if own_keys or counted_keys:
            pins = []
            for key in own_keys + counted_keys:
                allowed = topology.allowed_domains(pod, key, preferred, term)
                vr = reqs.get(key)
                options = (
                    set(vr.values)
                    if vr is not None and not vr.complement
                    else set()
                )
                if allowed is not None:
                    options &= allowed
                if not options:
                    if key in counted_keys:
                        # counted-only pod on a node without the label:
                        # valid placement, just not in any domain
                        continue
                    return False
                choice = topology.preferred_domains(pod, key, options)[0]
                reqs.add(Requirement(key, Op.IN, [choice]))
                pins.append((key, choice))
            custom_pins = tuple(pins)
        # zone-keyed constraints narrow the node's zone choice; any pod
        # carrying one must PIN a zone so the placement is counted/anchored
        # (first affinity pod anchors the domain for followers).  Allowed
        # zones are walked balanced-first: a zone whose offerings have no
        # fitting type falls through to the next allowed zone instead of
        # wedging the pod on the balance-optimal pick.
        zone_order: List[Optional[str]] = [None]
        if _zone_constrained(pod, preferred) or topology.selected_by_group(pod, ZONE):
            zone_allowed = topology.allowed_domains(pod, ZONE, preferred, term)
            options = self.zone_options()
            if zone_allowed is not None:
                options &= zone_allowed
            zr = reqs.get(ZONE)
            if zr is not None:
                options = {z for z in options if zr.has(z)}
            if not options:
                return False
            zone_order = topology.preferred_domains(pod, ZONE, options)

        new_used = self.used + pod.requests
        base_reqs = reqs
        zone_choice: Optional[str] = None
        feasible: List[InstanceType] = []
        same = False
        for zc in zone_order:
            if zc is None:
                reqs = base_reqs
            else:
                reqs = Requirements(iter(base_reqs))
                reqs.add(Requirement(ZONE, Op.IN, [zc]))
            same = reqs == self.requirements
            if same:
                # the merged reqs add nothing: every probing shape that
                # folds into this node's requirements shares ONE cache
                # entry, so a cross-node scan (e.g. gang anchors probing
                # each open node) costs one label scan per NODE, not one
                # per (shape, node)
                cache_key = ("__same__",)
            else:
                sig = pod.constraint_signature()
                # the key must cover every sig component that feeds the
                # merged requirements: node_selector, required affinity,
                # preferences, volume-derived reqs, OR-terms — plus which
                # attempt (term, peel step) this is
                cache_key = (
                    sig[0], sig[1], sig[7], sig[8], sig[9],
                    preferred, term, keep_prefs, zc, custom_pins,
                )
            # the cached half (label-compatible candidate types) depends
            # only on the merged reqs, so a reserving anchor shares the
            # same entry — the group-total `used` vector is applied per
            # call like any other
            feasible = self._fits_some_type(
                reqs,
                self.used + reserve if reserve is not None else new_used,
                cache_key=cache_key,
            )
            if feasible:
                zone_choice = zc
                break
        if not feasible:
            return False

        # commit: shape-keyed label scans go stale only when the merge
        # actually NARROWED requirements.  Co-location followers (and any
        # same-shape batch) merge idempotently, so keeping the cache
        # turns their scans into dict hits; the resource narrowing of
        # `feasible_types` below stays safe because every probe re-applies
        # the allocatable mask against its own `used` vector.
        if not same:
            self._fit_cache.clear()
            self.requirements = reqs
        self.feasible_types = feasible
        if self._headroom is not None:
            # keep the stale headroom across the narrowing: the true bound
            # only shrinks, and the gate needs only an upper bound to make
            # rejects definitive — recomputing ~all-types allocatable on
            # every commit was the continued solve's hottest loop
            self._headroom_key = feasible
        self.used = new_used
        self.pods.append(pod)
        domains = {HOSTNAME: self.name}
        if zone_choice is not None:
            domains[ZONE] = zone_choice
        for key, choice in custom_pins:
            domains[key] = choice
        # pods that reach this point unpinned are neither zone-constrained
        # nor selected by any zone-keyed group (the zone_choice branch
        # catches both, and constrained-first sort guarantees every group
        # that could select this pod already exists), so recording a zone
        # domain for them would serve no group — skip the offering scan
        # that used to compute it on every commit
        topology.record(pod, domains)
        return True

    def cheapest_price(self) -> float:
        return min(
            (t.cheapest_price(self.requirements) for t in self.feasible_types),
            default=float("inf"),
        )

    def final_instance_types(self) -> List[InstanceType]:
        """Feasible types, price-ascending (reference
        pkg/providers/instance/instance.go:391-408)."""
        return sorted(self.feasible_types, key=lambda t: t.cheapest_price(self.requirements))


def _feasible_types_get(self: VirtualNode) -> List[InstanceType]:
    if self.widen_thunk is not None:
        thunk, self.widen_thunk = self.widen_thunk, None
        self.__dict__["_ftypes"] = thunk()
    return self.__dict__["_ftypes"]


def _feasible_types_set(self: VirtualNode, value: List[InstanceType]) -> None:
    self.__dict__["_ftypes"] = value


# `feasible_types` is a property (attached post-dataclass so the dataclass
# machinery still generates the __init__ parameter): reading it consumes a
# pending widen_thunk, so EVERY consumer — including direct attribute reads
# — observes the fully widened list, never the narrow committed-type one.
VirtualNode.feasible_types = property(_feasible_types_get, _feasible_types_set)


@dataclass
class ExistingNode:
    """An already-running (or in-flight) node considered for placements."""

    state: StateNode
    used: Resources
    pods: List[Pod] = field(default_factory=list)
    # node labels are immutable for the solve: build the Requirements view
    # once per node instead of once per (pod, node) probe
    _label_reqs: Optional[Requirements] = None

    @property
    def name(self) -> str:
        return self.state.name

    def try_add(
        self,
        pod: Pod,
        topology: TopologyTracker,
        preferred: bool = True,
        term: int = 0,
        reserve: Optional[Resources] = None,
        keep_prefs: Optional[int] = None,
    ) -> bool:
        if self.state.marked_for_deletion() or (
            self.state.node is not None and self.state.node.cordoned
        ):
            return False
        # resources first: the cheapest definitive rejection, and most
        # probes in a big solve hit already-full nodes; an anchor's
        # `reserve` (its group total) must fit so followers can join
        if not (
            self.used + (reserve if reserve is not None else pod.requests)
        ).fits(self.state.allocatable):
            return False
        if not tolerates_all(pod.tolerations, self.state.taints):
            return False
        if self._label_reqs is None:
            self._label_reqs = Requirements.from_labels(self.state.labels)
        if not self._label_reqs.compatible(
            pod.scheduling_requirements(
                preferred=preferred, term=term, keep_prefs=keep_prefs
            )
        ):
            return False
        host_allowed = topology.allowed_domains(pod, HOSTNAME, preferred, term)
        if host_allowed is not None and self.name not in host_allowed:
            return False
        zone_allowed = topology.allowed_domains(pod, ZONE, preferred, term)
        zone = self.state.zone
        if zone_allowed is not None and zone and zone not in zone_allowed:
            return False
        # custom topology keys: the node's label IS its domain; a node
        # lacking the label is not a valid domain for the constraint
        domains = {HOSTNAME: self.name}
        if zone:
            domains[ZONE] = zone
        own_keys, counted_keys = _spread_pin_keys(pod, topology, preferred)
        for key in own_keys + counted_keys:
            domain = self.state.labels.get(key)
            if domain is None:
                if key in counted_keys:
                    continue  # counted-only: valid, just not in a domain
                return False
            allowed = topology.allowed_domains(pod, key, preferred, term)
            if allowed is not None and domain not in allowed:
                return False
            domains[key] = domain
        self.used = self.used + pod.requests
        self.pods.append(pod)
        topology.record(pod, domains)
        return True


@dataclass
class SchedulingResult:
    new_nodes: List[VirtualNode] = field(default_factory=list)
    existing_placements: Dict[str, str] = field(default_factory=dict)  # pod -> node
    unschedulable: Dict[str, str] = field(default_factory=dict)  # pod -> reason

    def node_count(self) -> int:
        return len(self.new_nodes)

    def total_price(self) -> float:
        return sum(n.cheapest_price() for n in self.new_nodes)


class Scheduler:
    """One scheduling solve over a pod batch (the oracle path)."""

    def __init__(
        self,
        pools: Sequence[NodePool],
        instance_types: Dict[str, List[InstanceType]],  # pool name -> types
        existing: Sequence[StateNode] = (),
        daemonsets: Sequence[Pod] = (),
        zones: Sequence[str] = (),
        scan_memo: Optional[Dict] = None,
    ):
        # cross-node label-scan memo (see VirtualNode._scan_memo); a
        # long-lived caller (TensorScheduler's oracle continuation) passes
        # its own dict so entries survive per-solve Scheduler recreation
        self._scan_memo: Dict = scan_memo if scan_memo is not None else {}
        # open-node scan list, (re)seeded per solve() and pruned of
        # slot-full nodes as the solve proceeds
        self._scan_nodes: List[VirtualNode] = []
        # highest weight first (reference designs/provisioner-priority.md)
        self.pools = sorted(
            (p for p in pools if not p.deleted), key=lambda p: -p.weight
        )
        self.instance_types = instance_types
        self.daemonsets = list(daemonsets)
        # topology domains are the zones some pool could actually create
        # nodes in — offering zones INTERSECTED with the pool's template
        # zone requirement (karpenter-core builds spread domains from the
        # provisioner requirements; an all-offerings universe would count
        # zones a zone-restricted pool can never serve, wedging
        # DoNotSchedule spreads) — plus the zones of live nodes
        zones = set(zones)
        for pool in self.pools:
            zr = pool.template_requirements().get(ZONE)
            for t in instance_types.get(pool.name, []):
                for o in t.offerings:
                    if zr is None or zr.has(o.zone):
                        zones.add(o.zone)
        zones.update(sn.zone for sn in existing if sn.zone)
        self.topology = TopologyTracker(sorted(zones))
        self.existing = [ExistingNode(sn, used=sn.used) for sn in existing]
        # every existing node is a hostname domain even while empty
        self.topology.universe.setdefault(HOSTNAME, set()).update(
            en.name for en in self.existing
        )
        # seed topology with already-bound pods; ALL node labels record as
        # domains (not just zone) so custom-topology-key spread groups see
        # live counts when they lazily replay the placement log
        for en in self.existing:
            for pod in en.state.pods:
                domains = {**en.state.labels, HOSTNAME: en.name}
                if en.state.zone:
                    domains[ZONE] = en.state.zone
                self.topology.record(pod, domains)

    # ------------------------------------------------------------------ solve
    def solve(
        self, pods: Iterable[Pod], result: Optional[SchedulingResult] = None
    ) -> SchedulingResult:
        """Schedule `pods`; pass a pre-populated `result` to CONTINUE a
        solve — its new_nodes participate as open virtual nodes (the hybrid
        tensor+oracle path seeds the tensor half's placements this way)."""
        if result is None:
            result = SchedulingResult()
        pods = list(pods)
        self._seed_custom_domains(pods)
        gangs = self._gang_components(pods)
        # the open-node scan list: starts as the (possibly seeded)
        # new_nodes and is PRUNED as nodes fill their pod slots — every
        # pod needs >= 1 slot, so a slot-full node can never admit
        # anything again, and a continued solve over a dense tensor pack
        # would otherwise re-probe hundreds of full nodes per placement
        self._scan_nodes = list(result.new_nodes)
        done: Set[int] = set()
        for pod in sorted(pods, key=pod_sort_key):
            if id(pod) in done:
                continue  # placed ahead of order by its gang's anchor pass
            self._place_one(pod, result, gangs, done)
        return result

    def _place_one(
        self,
        pod: Pod,
        result: SchedulingResult,
        gangs: Dict[int, list],
        done: Set[int],
    ) -> None:
        # a co-location ANCHOR (first member of its gang to place, no
        # live/prior matching placement) reserves the gang total so it
        # only anchors where the whole group fits; if no node admits
        # the total, fall back to per-pod placement (kube-scheduler's
        # greedy partial semantics)
        gang = gangs.get(id(pod))
        reserve = None
        if gang is not None and not gang[1] and not self._gang_anchored(pod):
            reserve = gang[0]
        reason = self._attempt_ladder(pod, result, reserve)
        done.add(id(pod))
        if reason is not None:
            result.unschedulable[pod.key()] = reason
            if gang is not None:
                # a dead member must stop inflating the reserve the next
                # anchor candidate will carry
                gang[0] = gang[0] - pod.requests
            return
        if gang is None:
            return
        gang[1].append(pod)
        if reserve is not None:
            # anchored with the whole group reserved: place every other
            # member NOW, before any interleaved pod (another gang's
            # anchor, a plain pod) can consume the reserved headroom —
            # the reservation exists only as this contiguous pass
            for member in sorted(gang[2], key=pod_sort_key):
                if id(member) in done:
                    continue
                r2 = self._attempt_ladder(member, result, None)
                done.add(id(member))
                if r2 is not None:
                    result.unschedulable[member.key()] = r2
                    gang[0] = gang[0] - member.requests
                else:
                    gang[1].append(member)

    def _attempt_ladder(
        self, pod: Pod, result: SchedulingResult, reserve: Optional[Resources]
    ) -> Optional[str]:
        """Node-affinity OR-terms go in order, first that works (reference
        scheduling.md:230-259).  Within each term, every soft input is
        REQUIRED on the first attempt, then relaxed incrementally —
        karpenter-core's RelaxMinimal: preferences peel ONE AT A TIME from
        the lowest priority (list tail), so a pod with one unsatisfiable
        and one satisfiable preference keeps the satisfiable one;
        ScheduleAnyway spreads drop last, after every preference.  With a
        gang reserve, every reserved attempt runs BEFORE the plain
        fallbacks: hostname affinity is a HARD constraint, so keeping the
        gang whole on a relaxed placement beats satisfying a soft
        preference and stranding the followers."""
        n_prefs = len(pod.preferred_affinity)
        relax_spreads = any(
            c.when_unsatisfiable != "DoNotSchedule"
            for c in pod.topology_spread
        )
        # (preferred, keep_prefs) per attempt: strict, then peel one
        # preference per step, then (only when soft spreads exist —
        # keep_prefs=0 already covers "no preferences") the fully-relaxed
        # attempt that also drops ScheduleAnyway spreads
        attempts = [(True, None)]
        attempts += [(True, k) for k in range(n_prefs - 1, -1, -1)]
        if relax_spreads:
            attempts += [(False, None)]
        reason = None
        n_terms = len(pod.node_affinity_terms())
        if reserve is not None:
            # every reserved attempt — all OR-terms, the full relax walk —
            # before ANY plain fallback: a later term that holds the whole
            # gang beats an earlier term that strands followers
            for ti in range(n_terms):
                for preferred, keep in attempts:
                    if self._place(pod, result, preferred, ti, reserve, keep) is None:
                        return None
        for ti in range(n_terms):
            for preferred, keep in attempts:
                reason = self._place(pod, result, preferred, ti, None, keep)
                if reason is None:
                    return None
        return reason

    def _seed_custom_domains(self, pods: Sequence[Pod]) -> None:
        """Topology domains for CUSTOM spread keys (any node label beyond
        zone/hostname, scheduling.md:319-331): like zones, the universe is
        what some pool could actually create — the pool templates' values
        for the key — plus the labels of live nodes.  karpenter-core
        builds spread domains from provisioner requirements the same
        way."""
        seeded = getattr(self, "_custom_seeded", None)
        if seeded is None:
            seeded = self._custom_seeded = set()
        for pod in pods:
            for c in pod.topology_spread:
                key = c.topology_key
                if key in (HOSTNAME, ZONE) or key in seeded:
                    continue
                seeded.add(key)
                domains: Set[str] = set()
                for pool in self.pools:
                    vr = pool.template_requirements().get(key)
                    if vr is not None and not vr.complement:
                        domains.update(vr.values)
                for en in self.existing:
                    v = en.state.labels.get(key)
                    if v:
                        domains.add(v)
                self.topology.universe.setdefault(key, set()).update(domains)

    def _gang_components(self, pods: Sequence[Pod]) -> Dict[int, list]:
        """Connected components over hostname co-location carriers in the
        batch: id(pod) -> shared ``[total_requests, placed_members,
        members]``.  An anchor uses the total as its placement reserve and
        then places the remaining members contiguously (see _place_one)."""
        carriers = [
            p
            for p in pods
            if any(
                not t.anti and t.topology_key == HOSTNAME
                for t in p.pod_affinity
            )
        ]
        if not carriers:
            return {}
        # inverted label index: selector matching runs as set intersection
        by_label: Dict[Tuple[str, str], Set[int]] = {}
        for i, p in enumerate(carriers):
            for kv in p.labels.items():
                by_label.setdefault(kv, set()).add(i)
        parent = list(range(len(carriers)))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i, p in enumerate(carriers):
            for t in p.pod_affinity:
                if t.anti or t.topology_key != HOSTNAME:
                    continue
                cand: Optional[Set[int]] = None
                for kv in t.label_selector:
                    hit = by_label.get(kv, set())
                    cand = set(hit) if cand is None else (cand & hit)
                    if not cand:
                        break
                if cand is None:
                    cand = set(range(len(carriers)))
                for j in cand:
                    if t.selects(carriers[j]):
                        ri, rj = find(i), find(j)
                        if ri != rj:
                            parent[rj] = ri
        comps: Dict[int, list] = {}
        for i, p in enumerate(carriers):
            root = find(i)
            ent = comps.get(root)
            if ent is None:
                ent = comps[root] = [Resources(), [], []]
            ent[0] = ent[0] + p.requests
            ent[2].append(p)
        return {id(p): comps[find(i)] for i, p in enumerate(carriers)}

    def _gang_anchored(self, pod: Pod) -> bool:
        """Whether some placement already anchors this pod's affinity terms
        (a live member or an earlier matched pod): then the pod must JOIN,
        and reserving a fresh-node total would be wrong."""
        for t in pod.pod_affinity:
            if t.anti or t.topology_key != HOSTNAME:
                continue
            if self.topology._affinity_group(t).domains:
                return True
        return False

    def _place(
        self,
        pod: Pod,
        result: SchedulingResult,
        preferred: bool,
        term: int = 0,
        reserve: Optional[Resources] = None,
        keep_prefs: Optional[int] = None,
    ) -> Optional[str]:
        """One placement attempt; None on success, else the reason."""
        if self._schedule_existing(pod, result, preferred, term, reserve, keep_prefs):
            return None
        if self._schedule_open_vnode(pod, result, preferred, term, reserve, keep_prefs):
            return None
        return self._schedule_new_vnode(pod, result, preferred, term, reserve, keep_prefs)

    def _schedule_existing(
        self,
        pod: Pod,
        result: SchedulingResult,
        preferred: bool = True,
        term: int = 0,
        reserve: Optional[Resources] = None,
        keep_prefs: Optional[int] = None,
    ) -> bool:
        host_allowed = self.topology.allowed_domains(pod, HOSTNAME, preferred, term)
        for en in self.existing:
            if host_allowed is not None and en.name not in host_allowed:
                continue
            if en.try_add(pod, self.topology, preferred, term, reserve, keep_prefs):
                result.existing_placements[pod.key()] = en.name
                return True
        return False

    def _schedule_open_vnode(
        self,
        pod: Pod,
        result: SchedulingResult,
        preferred: bool = True,
        term: int = 0,
        reserve: Optional[Resources] = None,
        keep_prefs: Optional[int] = None,
    ) -> bool:
        # two cheap prefilters before any try_add work: hostname-constrained
        # pods (co-location followers, anti-affinity singletons) admit only
        # their anchor domains, and every pod skips nodes whose cached
        # cpu/mem upper bound can't hold it — most probes in a big solve
        # hit already-full nodes
        host_allowed = self.topology.allowed_domains(pod, HOSTNAME, preferred, term)
        allow_new = host_allowed is None or NEW_DOMAIN in host_allowed
        need = reserve if reserve is not None else pod.requests
        cpu_need = need.get("cpu")
        mem_need = need.get("memory")
        pods_need = need.get("pods")
        scan = self._scan_nodes
        placed = False
        full: Optional[set] = None
        for vn in scan:
            used = vn.used
            hi_cpu, hi_mem, hi_pods = vn.hi_cpu_mem()
            if used.get("pods") + 1 > hi_pods + 1e-9:
                # slot-full: prune from the scan list for good (hi_pods
                # is an upper bound, so this never drops a usable node)
                if full is None:
                    full = set()
                full.add(id(vn))
                continue
            if (
                host_allowed is not None
                and vn.name not in host_allowed
                and not (allow_new and not vn.pods)
            ):
                continue
            if (
                used.get("cpu") + cpu_need > hi_cpu + 1e-9
                or used.get("memory") + mem_need > hi_mem + 1e-9
                or used.get("pods") + pods_need > hi_pods + 1e-9
            ):
                continue
            if vn.try_add(pod, self.topology, preferred, term, reserve, keep_prefs):
                placed = True
                break
        if full is not None:
            self._scan_nodes = [vn for vn in scan if id(vn) not in full]
        return placed

    def _schedule_new_vnode(
        self,
        pod: Pod,
        result: SchedulingResult,
        preferred: bool = True,
        term: int = 0,
        reserve: Optional[Resources] = None,
        keep_prefs: Optional[int] = None,
    ) -> Optional[str]:
        reason = "no nodepool matched pod constraints"
        for pool in self.pools:
            types = self.instance_types.get(pool.name, [])
            if not types:
                reason = f"nodepool {pool.name} has no instance types"
                continue
            vn = self._new_vnode(pool, types)
            if vn.try_add(pod, self.topology, preferred, term, reserve, keep_prefs):
                result.new_nodes.append(vn)
                self._scan_nodes.append(vn)
                return None
            reason = "pod incompatible with every instance type / offering"
        return reason

    def _new_vnode(self, pool: NodePool, types: List[InstanceType]) -> VirtualNode:
        # the template parts (pool requirements, label-feasible type list,
        # daemonset overhead) are pool-constant while the caller's type
        # lists are; a big batch opens hundreds of nodes and re-deriving
        # them per node was a measurable slice of the oracle continuation.
        # Stored in the (possibly cross-solve) scan memo so the template
        # LIST IDENTITY is stable across continuations — that identity is
        # what keys the cross-node label-scan memo entries.  Validity is
        # identity-based over EVERY input the template derives from —
        # types list, pool object, daemonset objects — mirroring the
        # solver's catalog key: the provider can return the same cached
        # types list while the pool template or daemonsets changed.
        tkey = ("__vnode_tpl__", pool.name)
        ds = tuple(self.daemonsets)
        ent = self._scan_memo.get(tkey)
        if (
            ent is None
            or ent[0] is not types
            or ent[1] is not pool
            or len(ent[2]) != len(ds)
            or any(a is not b for a, b in zip(ent[2], ds))
        ):
            reqs = pool.template_requirements()
            feasible = [
                t
                for t in types
                if t.requirements.compatible(reqs, allow_undefined=True)
            ]
            hi: Dict[str, float] = {}
            for t in feasible:
                for axis, v in t.allocatable().items():
                    if v > hi.get(axis, 0.0):
                        hi[axis] = v
            ent = (
                types,
                pool,
                ds,
                reqs,
                feasible,
                self._daemon_overhead(pool, reqs),
                hi,
                (hi.get("cpu", 0.0), hi.get("memory", 0.0), hi.get("pods", 0.0)),
            )
            self._scan_memo[tkey] = ent
        _, _, _, reqs, feasible, overhead, hi, hi2 = ent
        vn = VirtualNode(
            pool=pool,
            requirements=Requirements(iter(reqs)),
            feasible_types=feasible,
            daemon_overhead=overhead,
        )
        # seed the headroom caches from the template (shared, never
        # mutated in place): a failed probe on a fresh node must not pay
        # a full allocatable walk per attempt
        vn._headroom = hi
        vn._headroom_key = feasible
        vn._hi2 = hi2
        vn._scan_memo = self._scan_memo
        return vn

    def _daemon_overhead(self, pool: NodePool, reqs: Requirements) -> Resources:
        """Daemonset pods that will land on any node of this pool charge
        their requests up front (karpenter-core does the same per-node
        daemonset overhead computation)."""
        out = Resources()
        for d in self.daemonsets:
            if not tolerates_all(d.tolerations, pool.taints):
                continue
            if not reqs.compatible(d.scheduling_requirements()):
                continue
            out = out + d.requests
        return out
