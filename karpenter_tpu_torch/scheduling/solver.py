"""The tensor scheduling solver: compile -> pack -> decode, with oracle fallback.

Port of ``karpenter_tpu/scheduling/solver.py:TensorScheduler``'s provisioning
solve.  `TorchScheduler` presents the oracle's interface
(scheduling/scheduler.py) but runs the solve as tensors: constraint
compilation (ops/tensorize.py, numpy) followed by the FFD pack on the card
(ops/fused_packer.py, hand-written CUDA) or, for ``device="cpu"``, its plain
PyTorch version.  Constraint shapes the pack cannot express fall back to the
oracle for their coupled closure only (hybrid solve), so callers always get
a correct answer.

The warm reconcile tick is the reference's too: a compile cache keyed on
pod identity + mutation epoch and on live-node content re-serves an earlier
compile, and on a miss the device-resident tensors (ops/resident.py) absorb
the tick's diff as one gather + scatter step, so a warm solve packs with no
partition, compile or upload.  Decoded output is the oracle's
`SchedulingResult`.  The reference's consolidation verdicts and mesh are
later slices of the port.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import InstanceType, NodePool, Pod, Requirement
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import selector_matches
from karpenter_tpu_torch.api.requirements import Op
from karpenter_tpu_torch.api.resources import Resources
from karpenter_tpu_torch.ops.packer import (
    dispatch_pack,
    fetch_pack,
    last_kernel_name,
    resolve_device,
)
from karpenter_tpu_torch.ops.resident import ResidentCache
from karpenter_tpu_torch.ops.tensorize import (
    _SCALE,
    CompiledProblem,
    ConfigMeta,
    _axes_for_requests,
    _fits_existing,
    build_catalog,
    compile_problem,
    partition_groups,
)
from karpenter_tpu_torch.scheduling.scheduler import (
    PENDING_WIDEN,
    Scheduler,
    SchedulingResult,
    VirtualNode,
)
from karpenter_tpu_torch.scheduling.topology import HOSTNAME, ZONE, TopologyTracker
from karpenter_tpu_torch.state.cluster import StateNode
from karpenter_tpu_torch.utils.trace import TRACER, phase, phase_collect


class TorchScheduler:
    """Drop-in replacement for the oracle `Scheduler` backed by the pack
    kernel.  ``device`` defaults to the card; tests pass ``"cpu"``."""

    def __init__(
        self,
        pools: Sequence[NodePool],
        instance_types: Dict[str, List[InstanceType]],
        existing: Sequence[StateNode] = (),
        daemonsets: Sequence[Pod] = (),
        zones: Sequence[str] = (),
        objective: str = "nodes",
        device=None,
    ):
        self.pools = list(pools)
        self.instance_types = instance_types
        self.existing = list(existing)
        self.daemonsets = list(daemonsets)
        self.zones = list(zones)
        self.objective = objective
        self.device = resolve_device(device)
        self.last_path = ""  # "tensor" | "oracle" | "hybrid"
        self.last_kernel = ""  # "cuda_ffd" | "reference" | "" (oracle)
        self.last_compile_relaxed = 0  # pods relaxed on the compiled rows
        # prebuilt config-axis tensors, keyed by the identities of every
        # input (the instance-type provider returns NEW lists on change);
        # `_catalog_pins` keeps the keyed objects alive so ids cannot recycle
        self._catalog_key: tuple = ()
        self._catalog = None
        self._catalog_pins: tuple = ()
        # cross-solve label-scan memo handed to every oracle Scheduler
        self._scan_memo: dict = {}
        self._input_key: tuple = ()
        # incremental compile cache: a tick that re-solves a pending set it
        # has seen (same pod objects and epochs, same catalog snapshot,
        # same live-node content) reuses the prior partition +
        # CompiledProblem + live-join reservations.  Every entry PINS the
        # objects its ids reference, so id reuse cannot alias.
        self._compile_cache: dict = {}
        self._last_fp = None
        self.compile_cache_hits = 0
        self.compile_cache_misses = 0
        # device-resident incremental tensors (ops/resident.py): warm ticks
        # skip re-tensorize AND the upload.  `resident_hits` counts solves
        # packed from the resident tensors (delta or no change),
        # `resident_rebuilds` full compiles that seeded a state.
        self._resident = ResidentCache()
        self.resident_hits = 0
        self.resident_rebuilds = 0
        self.last_resident = False  # this solve packed from resident tensors
        self.last_delta_rows = -1  # scattered rows+cols on a delta tick
        # per-solve observability: disjoint wall-time phases (seconds) and
        # which continuation handled the oracle half ("join" | "oracle")
        self.last_phases: Dict[str, float] = {}
        self.last_continuation = ""

    def update(
        self,
        pools: Sequence[NodePool],
        instance_types: Dict[str, List[InstanceType]],
        existing: Sequence[StateNode] = (),
        daemonsets: Sequence[Pod] = (),
        objective: str = "",
    ) -> "TorchScheduler":
        """Refresh per-solve inputs on a long-lived scheduler; the catalog
        is reused while the pools / type lists / daemonsets are the same
        objects."""
        key = (
            tuple(map(id, pools)),
            tuple(sorted((k, id(v)) for k, v in instance_types.items())),
            tuple(map(id, daemonsets)),
        )
        if key != self._input_key:
            self._input_key = key
            self._scan_memo.clear()
            # rolled inputs also obsolete every cached compilation
            self._compile_cache.clear()
        self.pools = list(pools)
        self.instance_types = instance_types
        self.existing = list(existing)
        self.daemonsets = list(daemonsets)
        if objective:
            self.objective = objective
        return self

    # ------------------------------------------------------------------ solve
    def solve(self, pods: Iterable[Pod]) -> SchedulingResult:
        """Solve a batch: tensor path for everything the pack expresses,
        oracle CONTINUATION for the remainder (hybrid).

        Every solve records a wall-time phase breakdown in ``last_phases``
        (delta / partition / compile / pad / dispatch / device_block /
        oracle / decode / other — disjoint self-times that sum to the wall
        clock)."""
        self.last_phases = phases = {}
        with phase_collect(phases), phase("other"):
            return self._solve(list(pods))

    def _solve(self, pods: List[Pod]) -> SchedulingResult:
        self.last_compile_relaxed = 0
        self.last_continuation = ""
        self.last_kernel = ""
        self.last_resident = False
        self.last_delta_rows = -1
        resident = None
        cached = self._cache_lookup(pods)
        if cached is None:
            self.compile_cache_misses += 1
            # the resident delta path: an already-seeded device problem
            # absorbs this tick's diff as one gather + scatter step
            with phase("delta"), TRACER.span("solver.delta"):
                resident = self._resident.refresh(self, pods)
            if resident is not None:
                self.resident_hits += 1
                self.last_delta_rows = resident.last_delta_rows
                prob = resident.problem()
                sup_groups = resident.groups()
                unsupported, join_assign = [], ()
                # proven, not assumed: resident eligibility keeps every
                # batch pod free of spread/affinity selectors and refuses
                # carriers on ANY existing node, so both _compact_guard
                # clauses are vacuous
                compact_ok = True
                self._cache_store(pods, sup_groups, [], prob, (), compact_ok)
            else:
                with phase("partition"), TRACER.span("solver.partition"):
                    sup_groups, unsupported, _reason = partition_groups(
                        pods, existing=self.existing, pools=self.pools
                    )
                if sup_groups:
                    # live-member co-location closures must JOIN specific
                    # live nodes: compile against SHADOW nodes with the
                    # groups' totals reserved, so the tensor half cannot
                    # fill that capacity first
                    with phase("partition"):
                        shadow, join_assign = self._reserve_live_capacity(
                            unsupported
                        )
                    prob = self._compile_tensor(
                        [p for _, members in sup_groups for p in members],
                        sup_groups,
                        existing=shadow,
                    )
                else:
                    prob, join_assign = None, ()
                compact_ok = self._compact_guard(pods)
                self._cache_store(
                    pods, sup_groups, unsupported, prob, join_assign,
                    compact_ok,
                )
                # a full compile happened: seed a resident state so the
                # NEXT delta applies on the device (ineligible shapes leave
                # the layer empty and recompile next time)
                if prob is not None and prob.supported and not unsupported:
                    resident = self._resident.rebuild(
                        self, pods, prob, self._catalog, consumer="solve"
                    )
                    if resident is not None:
                        self.resident_rebuilds += 1
        else:
            self.compile_cache_hits += 1
            sup_groups, unsupported, prob, join_assign, compact_ok = cached
            # a hit re-serving the resident snapshot packs straight from
            # the device tensors, no delta needed
            resident = (
                self._resident.match(prob, self.device)
                if prob is not None
                else None
            )
            if resident is not None:
                self.resident_hits += 1
                self.last_delta_rows = 0
        if prob is None or not prob.supported:
            with phase("oracle"), TRACER.span("solver.oracle", pods=len(pods)):
                return self._oracle(pods)
        self.last_resident = resident is not None
        self.last_path = "tensor"
        self.last_compile_relaxed = prob.compile_relaxed

        # the pack launch only ENQUEUES device work, so the host plans the
        # oracle-only pods' live-node joins while the card packs
        join_plan = None

        def overlap() -> None:
            nonlocal join_plan
            with phase("oracle"), TRACER.span(
                "solver.join_plan", pods=len(unsupported)
            ):
                join_plan = self._plan_live_join(unsupported, join_assign)

        result = self._pack_decode(
            prob,
            overlap=overlap if unsupported else None,
            pack_fn=resident.pack if resident is not None else None,
        )
        if unsupported:
            self.last_path = "hybrid"
            if join_plan is not None:
                # every oracle-only pod joins its reserved anchor; the plan
                # was validated against capacity the tensor half could not
                # touch, so it cannot conflict with the decoded placements
                self.last_continuation = "join"
                for members, sn in join_plan:
                    for p in members:
                        result.existing_placements[p.key()] = sn.name
            else:
                self.last_continuation = "oracle"
                with phase("oracle"), TRACER.span(
                    "solver.oracle_continue", pods=len(unsupported)
                ):
                    supported = [
                        p for _, members in sup_groups for p in members
                    ]
                    result = self._oracle_continue(
                        unsupported, supported, result
                    )
        # preference / OR-term relaxation: the tensor path compiles
        # preferred node affinity as REQUIRED and only a pod's FIRST
        # nodeSelectorTerm, so a pod whose preferences or first term cannot
        # be met decodes unschedulable — give it the oracle's relax-and-retry
        relax = [
            p
            for p in pods
            if p.key() in result.unschedulable
            and (
                p.preferred_affinity
                or len(p.node_affinity_terms()) > 1
                or any(
                    c.when_unsatisfiable != "DoNotSchedule"
                    for c in p.topology_spread
                )
            )
        ] if result.unschedulable else []
        if relax:
            relax_keys = {p.key() for p in relax}
            # a relax-eligible CO-LOCATION member brings its whole closure
            coloc_relax = [
                p
                for p in relax
                if any(
                    not t.anti and t.topology_key == L.LABEL_HOSTNAME
                    for t in p.pod_affinity
                )
            ]
            if coloc_relax:
                # fixed point over selector adjacency
                frontier = list(coloc_relax)
                while frontier:
                    grabbed = []
                    for p in pods:
                        if (
                            p.key() in relax_keys
                            or p.key() not in result.unschedulable
                        ):
                            continue
                        terms = [
                            t
                            for t in p.pod_affinity
                            if not t.anti
                            and t.topology_key == L.LABEL_HOSTNAME
                        ]
                        if any(
                            t.selects(q) for q in frontier for t in terms
                        ) or any(
                            t.selects(p)
                            for q in frontier
                            for t in q.pod_affinity
                            if not t.anti
                            and t.topology_key == L.LABEL_HOSTNAME
                        ):
                            relax.append(p)
                            relax_keys.add(p.key())
                            grabbed.append(p)
                    frontier = grabbed
            for k in relax_keys:
                del result.unschedulable[k]
            others = [p for p in pods if p.key() not in relax_keys]
            self.last_path = "hybrid"
            with phase("oracle"), TRACER.span("solver.relax", pods=len(relax)):
                result = self._oracle_continue(
                    relax, others, result, seed_topology=True
                )
        if compact_ok:
            with TRACER.span("solver.compact"):
                self._compact_small_nodes(result)
        return result

    def _compact_guard(self, pods: List[Pod]) -> bool:
        """Whether decode compaction is safe for this batch: a selector that
        matches UNLABELED pods leaves no pod safely untracked; live bound
        pods' symmetric anti-affinity counts too."""
        return not any(
            selector_matches({}, c.label_selector, c.match_expressions)
            for p in pods
            for c in (*p.topology_spread, *p.pod_affinity)
        ) and not any(
            selector_matches({}, t.label_selector, t.match_expressions)
            for sn in self.existing
            for bp in sn.pods
            for t in bp.pod_affinity
            if t.anti
        )

    def _compact_small_nodes(self, result: SchedulingResult) -> None:
        """Decode post-pass: re-home topology-free pods off nearly-empty new
        nodes into other new nodes, dropping nodes that empty out.  Only pods
        with no labels and no pod-level topology constraints move (plus
        hostname anti-affinity singletons under an exact ban check)."""

        def plain(p: Pod) -> bool:
            return not (
                p.labels or p.pod_affinity or p.topology_spread
                or p.preferred_affinity
            )

        def singleton(p: Pod) -> bool:
            return (
                not p.topology_spread
                and not p.preferred_affinity
                and bool(p.pod_affinity)
                and all(
                    t.anti and t.topology_key == L.LABEL_HOSTNAME
                    for t in p.pod_affinity
                )
            )

        donors = sorted(
            (
                vn
                for vn in result.new_nodes
                if len(vn.pods) <= 8
                and all(plain(p) or singleton(p) for p in vn.pods)
            ),
            key=lambda vn: len(vn.pods),
        )
        if not donors:
            return
        donor_ids = {id(d) for d in donors}
        scratch = TopologyTracker(self.zones)
        # seed hostname domains so anti-affinity bans are exact for moved
        # singletons
        for o in result.new_nodes:
            scratch.universe.setdefault(HOSTNAME, set()).add(o.name)
            for p in o.pods:
                if p.labels or p.pod_affinity:
                    scratch.record(p, {HOSTNAME: o.name})
        for vn in donors:
            targets = [
                o
                for o in result.new_nodes
                if o is not vn and id(o) not in donor_ids
            ] + [o for o in donors if o is not vn and o.pods]
            remaining = []
            for p in vn.pods:
                moved = False
                for o in sorted(targets, key=lambda o: -len(o.pods)):
                    if o.try_add(p, scratch):
                        moved = True
                        break
                if not moved:
                    remaining.append(p)
            if remaining and len(remaining) != len(vn.pods):
                # partial move: rebuild the donor's used vector
                vn.used = vn.daemon_overhead
                for p in remaining:
                    vn.used = vn.used + p.requests
            vn.pods = remaining
        result.new_nodes = [vn for vn in result.new_nodes if vn.pods]

    def _reserve_live_capacity(self, unsupported: List[Pod]):
        """Shadow `self.existing` with oracle-bound co-location groups'
        totals charged against their anchor nodes, so the tensor compile
        sees the capacity the continuation will consume.

        Returns ``(shadow_existing, assignments)``: (members, anchor
        StateNode) pairs, the join plan's input.  Anchors are memoized per
        class (pods of one class carry identical affinity terms)."""
        if not unsupported or not self.existing:
            return self.existing, ()
        by_class: Dict[object, List[Pod]] = {}
        for p in unsupported:
            by_class.setdefault(p.class_key(), []).append(p)
        reserve: Dict[str, Resources] = {}
        assignments: List[Tuple[List[Pod], StateNode]] = []
        for members in by_class.values():
            rep = members[0]
            terms = [
                t
                for t in rep.pod_affinity
                if not t.anti and t.topology_key == L.LABEL_HOSTNAME
            ]
            if not terms:
                continue
            anchor = None
            for sn in self.existing:
                # EVERY term must find a matching bound pod on the node
                if all(any(t.selects(bp) for bp in sn.pods) for t in terms):
                    anchor = sn
                    break
            if anchor is None:
                continue
            reserve[anchor.name] = reserve.get(
                anchor.name, Resources()
            ) + rep.requests.scaled(len(members))
            assignments.append((members, anchor))
        if not reserve:
            return self.existing, ()
        out = []
        for sn in self.existing:
            r = reserve.get(sn.name)
            if r is None:
                out.append(sn)
            else:
                shadow = copy.copy(sn)
                shadow.used = sn.used + r
                out.append(shadow)
        return out, tuple(assignments)

    def _compile_tensor(
        self, pods: List[Pod], groups, existing=None
    ) -> CompiledProblem:
        axes = _axes_for_requests([key[1] for key, _ in groups])
        key = (
            axes,
            tuple(id(p) for p in self.pools),
            tuple(sorted((k, id(v)) for k, v in self.instance_types.items())),
            tuple(id(d) for d in self.daemonsets),
        )
        if key != self._catalog_key:
            self._catalog = build_catalog(
                self.pools, self.instance_types, self.daemonsets, axes
            )
            self._catalog_key = key
            # a catalog roll makes every id-keyed scan-memo entry dead
            self._scan_memo.clear()
            self._catalog_pins = (
                tuple(self.pools),
                tuple(self.instance_types.values()),
                tuple(self.daemonsets),
            )
        with phase("compile"), TRACER.span("solver.compile", pods=len(pods)):
            return compile_problem(
                pods,
                self.pools,
                self.instance_types,
                existing=self.existing if existing is None else existing,
                daemonsets=self.daemonsets,
                catalog=self._catalog,
                presplit=True,
                groups=groups,
            )

    def _upload_pack(
        self, prob: CompiledProblem, k_slots: int = 0, objective: str = "nodes"
    ):
        """The cold pack: pad, upload and launch (ops/packer.dispatch_pack)."""
        return dispatch_pack(prob, k_slots, objective, self.device)

    def _pack_decode(self, prob: CompiledProblem, overlap=None, pack_fn=None):
        """Launch the pack, run `overlap` host work while the card executes
        (launches are asynchronous — only the fetch waits), then fetch,
        retry on slot overflow with a doubled slot bucket, and decode.

        ``pack_fn`` overrides the upload pack for this one solve: the
        resident path passes its pack over the device tensors, whose
        overflow retry falls back to the upload path."""
        eff_pack = pack_fn if pack_fn is not None else self._upload_pack
        with phase("dispatch"), TRACER.span("solver.pack"):
            outs = eff_pack(prob, objective=self.objective)
        self.last_kernel = last_kernel_name(self.device)
        if overlap is not None:
            overlap()
        with phase("device_block"), TRACER.span("solver.fetch"):
            res = fetch_pack(outs)
        # grow the slot bucket if the solve ran out of node slots while
        # feasible configs remained
        k = int(res.node_cfg.shape[0])
        max_k = len(prob.used0) + prob.total_pods()
        while self._overflowed(prob, res.leftover) and k < max_k:
            k *= 2
            with phase("dispatch"), TRACER.span("solver.pack", retry_k=k):
                outs = eff_pack(prob, k_slots=k, objective=self.objective)
            with phase("device_block"), TRACER.span("solver.fetch", retry_k=k):
                res = fetch_pack(outs)
        with phase("decode"), TRACER.span("solver.decode"):
            return self._decode(prob, res.take, res.node_cfg, res.node_used)

    # ------------------------------------------------------- compile cache
    _COMPILE_CACHE_CAP = 8

    def _solve_fingerprint(self, pods: List[Pod]) -> Optional[tuple]:
        """Fingerprint of everything the compile reads.

        Batch and catalog inputs key by object identity + mutation epoch
        (providers return NEW list objects on change; the Pod / NodePool
        ``__setattr__`` epochs catch in-place field reassignment).  Live
        nodes key by CONTENT (name, used / allocatable / labels / taints,
        schedulability flags, bound-pod identities), because a cluster
        snapshot builds fresh StateNode wrappers every tick, and decode
        refers to live nodes by name, so content-equal wrappers are
        interchangeable."""
        try:
            # direct __dict__ access: this loop runs over the whole batch
            # per solve ("_mut" exists from field init; KeyError falls
            # through to the except)
            pods_fp = tuple((id(p), p.__dict__["_mut"]) for p in pods)
            pools_fp = tuple(
                (id(p), p.__dict__.get("_mut", 0)) for p in self.pools
            )
            types_fp = tuple(
                sorted((k, id(v)) for k, v in self.instance_types.items())
            )
            ds_fp = tuple(
                (id(d), d.__dict__.get("_mut", 0)) for d in self.daemonsets
            )
            ex_fp = tuple(
                (
                    sn.name,
                    tuple(sorted(sn.used.items())),
                    tuple(sorted(sn.allocatable.items())),
                    tuple(sorted(sn.labels.items())),
                    tuple(map(repr, sn.taints)),
                    sn.marked_for_deletion(),
                    sn.node is not None and sn.node.cordoned,
                    tuple(
                        (id(bp), bp.__dict__.get("_mut", 0))
                        for bp in sn.pods
                    ),
                )
                for sn in self.existing
            )
        except Exception:  # exotic duck-typed inputs: skip caching
            return None
        return (pools_fp, types_fp, ds_fp, pods_fp, ex_fp)

    def _cache_lookup(self, pods: List[Pod]):
        fp = self._solve_fingerprint(pods)
        self._last_fp = fp
        if fp is None:
            return None
        ent = self._compile_cache.get(fp)
        if ent is None:
            return None
        return ent[0]

    def _cache_store(
        self, pods, sup_groups, unsupported, prob, join_assign, compact_ok
    ):
        fp = self._last_fp
        if fp is None:
            return
        # pins: every object an id in the fingerprint refers to (batch
        # pods, pools, type lists, daemonsets, live nodes' BOUND pods; live
        # nodes themselves key by content) stays allocated for the entry's
        # lifetime, or a recycled id could alias
        pins = (
            list(pods),
            [list(sn.pods) for sn in self.existing],
            tuple(self.pools),
            tuple(self.instance_types.values()),
            tuple(self.daemonsets),
        )
        if len(self._compile_cache) >= self._COMPILE_CACHE_CAP:
            self._compile_cache.pop(next(iter(self._compile_cache)))
        self._compile_cache[fp] = (
            (sup_groups, unsupported, prob, join_assign, compact_ok),
            pins,
        )

    # ------------------------------------------------------------ live join
    def _plan_live_join(self, unsupported: List[Pod], assignments):
        """Validated placement plan for the oracle-only half when EVERY pod
        is a live-member co-location joiner: each pod lands on the anchor
        `_reserve_live_capacity` charged its requests to.  Returns None (the
        sequential oracle continuation) whenever any pod is unanchored,
        carries other constraint shapes, is repelled by a live anti
        carrier, fails the anchor's admission, or the anchor lacks real
        capacity."""
        if not assignments or sum(
            len(members) for members, _ in assignments
        ) != len(unsupported):
            return None
        live_anti = [
            t
            for sn in self.existing
            for bp in sn.pods
            for t in bp.pod_affinity
            if t.anti
        ]
        totals: Dict[str, Resources] = {}
        node_of: Dict[str, StateNode] = {}
        for members, sn in assignments:
            rep = members[0]
            if not self._join_class_eligible(rep, sn, live_anti):
                return None
            totals[sn.name] = totals.get(
                sn.name, Resources()
            ) + rep.requests.scaled(len(members))
            node_of[sn.name] = sn
        for name, tot in totals.items():
            sn = node_of[name]
            if not (sn.used + tot).fits(sn.allocatable):
                return None
        return assignments

    def _join_class_eligible(self, rep: Pod, sn: StateNode, live_anti) -> bool:
        if (
            rep.topology_spread
            or rep.preferred_affinity
            or len(rep.node_affinity_terms()) > 1
            or any(
                t.anti or t.topology_key != L.LABEL_HOSTNAME
                for t in rep.pod_affinity
            )
        ):
            return False
        if any(t.selects(rep) for t in live_anti):
            return False
        if sn.marked_for_deletion() or (
            sn.node is not None and sn.node.cordoned
        ):
            return False
        return _fits_existing(
            rep, rep.scheduling_requirements(preferred=True), sn
        )

    # ---------------------------------------------------------------- oracle
    def _oracle(self, pods: List[Pod]) -> SchedulingResult:
        self.last_path = "oracle"
        return Scheduler(
            self.pools,
            self.instance_types,
            existing=self.existing,
            daemonsets=self.daemonsets,
            zones=self.zones,
            scan_memo=self._scan_memo,
        ).solve(pods)

    def _oracle_continue(
        self,
        unsupported: List[Pod],
        supported: List[Pod],
        result: SchedulingResult,
        seed_topology: bool = False,
    ) -> SchedulingResult:
        """Continue the tensor result with the oracle for the oracle-only
        pods, seeded with the tensor half's placements (capacity, and with
        ``seed_topology`` every topology domain — needed only by the
        preference-relaxation pass)."""
        sch = Scheduler(
            self.pools,
            self.instance_types,
            existing=self.existing,
            daemonsets=self.daemonsets,
            zones=self.zones,
            scan_memo=self._scan_memo,
        )
        by_key = {p.key(): p for p in supported}
        en_by_name = {en.name: en for en in sch.existing}
        for pod_key, node_name in result.existing_placements.items():
            pod = by_key.get(pod_key)
            en = en_by_name.get(node_name)
            if pod is None or en is None:
                continue
            en.used = en.used + pod.requests
            en.pods.append(pod)
            if seed_topology:
                domains = {**en.state.labels, HOSTNAME: node_name}
                if en.state.zone:
                    domains[ZONE] = en.state.zone
                sch.topology.record(pod, domains)
        for vn in result.new_nodes:
            sch.topology.universe.setdefault(HOSTNAME, set()).add(vn.name)
            if seed_topology:
                opts = vn.zone_options()
                zone = next(iter(opts)) if len(opts) == 1 else None
                # custom-topology-key pins are single-valued node
                # requirements — replay them for relax-pass siblings
                extra = {}
                for r in vn.requirements:
                    if r.key in (HOSTNAME, ZONE):
                        continue
                    v = r.single_value()
                    if v is not None:
                        extra[r.key] = v
                for pod in vn.pods:
                    domains = {**extra, HOSTNAME: vn.name}
                    if zone:
                        domains[ZONE] = zone
                    sch.topology.record(pod, domains)
        return sch.solve(unsupported, result=result)

    # ------------------------------------------------------------- internals
    @staticmethod
    def _overflowed(prob: CompiledProblem, leftover: np.ndarray) -> bool:
        """Leftover pods whose class has an openable config that would truly
        HOLD them mean the solve ran out of node slots — only then is a
        bigger-K retry worthwhile."""
        G = len(prob.classes)
        if not leftover[:G].any():
            return False
        fits = (prob.req[:, None, :] <= prob.alloc[None, :, :] + 1e-6).all(
            axis=2
        )  # [G, C]
        placeable = (prob.feas & prob.openable[None, :] & fits).any(axis=1)
        return bool((leftover[:G] > 0)[placeable].any())

    def _decode(
        self,
        prob: CompiledProblem,
        take: np.ndarray,
        node_cfg: np.ndarray,
        node_used: np.ndarray,
    ) -> SchedulingResult:
        out = SchedulingResult()
        # slot -> decoded node (lazily created so empty slots cost nothing)
        vnodes: Dict[int, VirtualNode] = {}
        slot_classes: Dict[int, List[int]] = {}

        def vnode_for(k: int) -> VirtualNode:
            vn = vnodes.get(k)
            if vn is None:
                cfg = prob.configs[node_cfg[k]]
                vn = _make_vnode(
                    cfg, prob.pool_daemon_overhead.get(cfg.pool.name, Resources())
                )
                vnodes[k] = vn
                out.new_nodes.append(vn)
            return vn

        for g, cm in enumerate(prob.classes):
            cursor = 0
            for k in np.nonzero(take[g])[0]:
                n = int(take[g, k])
                if cm.group_size:
                    # co-location macro: one take unit = the WHOLE group
                    batch = cm.pods
                    cursor = len(cm.pods)
                    added = cm.requests
                else:
                    batch = cm.pods[cursor : cursor + n]
                    cursor += n
                    added = cm.requests.scaled(len(batch))
                cfg = prob.configs[node_cfg[k]]
                if cfg.existing is not None:
                    for p in batch:
                        out.existing_placements[p.key()] = cfg.existing.name
                else:
                    vn = vnode_for(int(k))
                    vn.pods.extend(batch)
                    vn.used = vn.used + added
                    slot_classes.setdefault(int(k), []).append(g)
            for p in cm.pods[cursor:]:
                out.unschedulable[p.key()] = self._why_unschedulable(prob, g)

        self._add_alternate_types(prob, node_cfg, node_used, vnodes, slot_classes)
        return out

    @staticmethod
    def _add_alternate_types(
        prob: CompiledProblem,
        node_cfg: np.ndarray,
        node_used: np.ndarray,
        vnodes: Dict[int, VirtualNode],
        slot_classes: Dict[int, List[int]],
    ) -> None:
        """Launch flexibility: widen each decoded node's feasible-type list
        to every config that every class on the node admits, that holds the
        node's usage, and that shares the committed pool, zone and capacity
        type.  Attached LAZILY (VirtualNode.widen_thunk), with a lazy
        headroom hint for continued solves."""
        C = len(prob.configs)
        configs = prob.configs
        alloc = prob.alloc
        openable = prob.openable

        def widen(committed, class_feas: np.ndarray, used_row: np.ndarray):
            def thunk() -> List:
                mask = openable & class_feas
                mask = mask & (used_row[None, :] <= alloc + 1e-6).all(axis=1)
                seen = {committed.instance_type.name}
                alts = []
                for c in np.nonzero(mask[:C])[0]:
                    cfg = configs[c]
                    if (
                        cfg.zone != committed.zone
                        or cfg.capacity_type != committed.capacity_type
                        or cfg.pool is not committed.pool
                    ):
                        continue
                    name = cfg.instance_type.name
                    if name in seen:
                        continue
                    seen.add(name)
                    alts.append((cfg.price, cfg.instance_type))
                alts.sort(key=lambda pair: pair[0])
                return [committed.instance_type] + [it for _, it in alts]

            return thunk

        axes = prob.axes
        # alloc rows are scaled per axis and daemonset-overhead-subtracted;
        # undo both so the hint bounds every type's raw allocatable
        scale = np.array([_SCALE.get(a, 1.0) for a in axes], np.float64)
        overhead_hi = np.zeros(len(axes), np.float64)
        for r in prob.pool_daemon_overhead.values():
            for ai, a in enumerate(axes):
                v = r.get(a)
                if v > overhead_hi[ai]:
                    overhead_hi[ai] = v

        def hint(class_feas: np.ndarray):
            def thunk():
                mask = openable & class_feas
                if not mask.any():
                    return None
                hi = alloc[mask].max(axis=0) * scale + overhead_hi
                return dict(zip(axes, hi.tolist()))

            return thunk

        for k, vn in vnodes.items():
            classes = slot_classes.get(k, ())
            class_feas = (
                prob.feas[list(classes)].all(axis=0)
                if classes
                else np.ones(prob.feas.shape[1], bool)
            )
            vn.widen_thunk = widen(
                configs[node_cfg[k]], class_feas, node_used[k].copy()
            )
            vn._headroom_thunk = hint(class_feas)
            vn._headroom_key = PENDING_WIDEN

    @staticmethod
    def _why_unschedulable(prob: CompiledProblem, g: int) -> str:
        if prob.classes[g].unsched_reason:
            return prob.classes[g].unsched_reason
        row = prob.feas[g]
        if not row.any():
            return "pod incompatible with every instance type / offering"
        return "no node with remaining capacity fits the pod"


def _make_vnode(cfg: ConfigMeta, daemon_overhead: Resources) -> VirtualNode:
    """Materialize a decoded slot as the oracle's VirtualNode: requirements
    carry the committed zone / capacity-type pins, `used` starts at the
    pool's daemonset overhead like the oracle's nodes."""
    it = cfg.instance_type
    reqs = cfg.pool.template_requirements()
    reqs.add(Requirement(L.LABEL_ZONE, Op.IN, [cfg.zone]))
    reqs.add(Requirement(L.LABEL_CAPACITY_TYPE, Op.IN, [cfg.capacity_type]))
    return VirtualNode(
        pool=cfg.pool,
        requirements=reqs,
        feasible_types=[it],
        daemon_overhead=daemon_overhead,
    )
