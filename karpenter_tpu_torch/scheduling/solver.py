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
`SchedulingResult`.

Consolidation asks the solver many what-if questions at once ("if these
nodes went away, would their pods fit on the rest of the cluster plus at
most one new node, and at what price?"): `evaluate_removals` (a batch of
candidate subsets) and `evaluate_population` / `dispatch_population` /
`fetch_population` (a population of removal masks) answer them as the
reference does, over one compiled base problem per candidate universe, on
the card as one batched scan (ops/fused_packer.py: `removal_verdicts`,
`population_verdicts`).

The device half has three backends, as the reference's (`default_pack_fn`):
the in-process pack on one device (``pack_fn`` None, the default), the pack
sharded over a device mesh (parallel/mesh.py `mesh_pack_fn`, passed as
``pack_fn`` or chosen by ``KARPENTER_TPU_SHARDED=1``), and a solver
sidecar's (service/client.py).  The resident tensors serve the first two.
Unlike the reference, a machine with more than one card keeps the
one-device pack unless asked: the mesh's shard kernels are not yet faster
than it (PERF.md).
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.api import InstanceType, NodePool, Pod, Requirement
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import selector_matches
from karpenter_tpu_torch.api.requirements import Op
from karpenter_tpu_torch.api.resources import Resources
from karpenter_tpu_torch.ops.packer import (
    POP_KEY_ABSENT,
    POP_OCC_ABSENT,
    RV_C_MIN,
    RV_C_STAR,
    RV_LEFTOVER,
    RV_MERGE,
    RV_MIN_PRICE,
    RV_NEW_COUNT,
    _bucket,
    dispatch_pack,
    dispatch_population_verdicts,
    fetch_pack,
    fetch_verdict_rows,
    last_kernel_name,
    pad_problem,
    resolve_device,
    run_removal_verdicts,
    to_device,
)
from karpenter_tpu_torch.ops.resident import ResidentCache, resident_capable
from karpenter_tpu_torch.ops.tensorize import (
    _SCALE,
    BIG,
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
from karpenter_tpu_torch.utils.trace import TRACER, device_trace, phase, phase_collect


class RemovalCandidate(NamedTuple):
    """One consolidation candidate as the solver sees it: the live node's
    name plus the pods a removal would have to reschedule."""

    node_name: str
    pods: Tuple[Pod, ...]


class RemovalVerdict(NamedTuple):
    """The answer to one what-if removal: do the subset's pods fit on the
    remaining cluster plus at most ONE new node?

    ``replacement_price`` is 0.0 when pure deletion suffices; when
    ``needs_host`` is set the batched path could not answer bit-identically
    and the caller must run the sequential simulation for this element."""

    fits: bool
    replacement_price: float
    needs_host: bool = False
    reason: str = ""


class _PendingPopulation:
    """An in-flight population scoring dispatch: the launched rows plus
    everything the blocking half needs to decode them.  ``ready`` is set
    when the host guards answered without any device work (base refused /
    empty universe); ``phases`` accumulates the per-phase self-times across
    BOTH halves so the completed dict matches the one-call form's."""

    __slots__ = ("P", "base", "out", "ready", "phases")

    def __init__(self, P: int):
        self.P = P
        self.base: Optional["_RemovalBase"] = None
        self.out = None
        self.ready: Optional[List[RemovalVerdict]] = None
        self.phases: Dict[str, float] = {}


class _RemovalBase:
    """One compiled-and-padded base problem for a consolidation pass:
    classes over the candidate-universe pods, existing rows over the FULL
    remaining cluster.  Every candidate subset then evaluates as a removal
    mask + count vector over this ONE compile (or records the fallback
    `reason` that sends the whole pass to the sequential path)."""

    __slots__ = (
        "reason", "empty", "prob", "args", "k_slots", "n_live",
        "slot_of", "class_of", "pool_id", "zone_id", "ct_id",
        "compactable", "compact_ok", "price_py", "gp", "kp", "sort_key",
        # population-search extras: per-candidate tensors the mask scoring
        # derives each subset's counts / removed slots / class order from
        # on the device
        "pop_reason", "n_universe", "cand_cnt", "cand_slot", "cand_occ",
        "sort_rank", "occ_span",
    )

    def __init__(self, reason: str = "", empty: bool = False):
        self.reason = reason
        self.empty = empty
        self.prob = None
        self.args: tuple = ()
        self.k_slots = 0
        self.n_live = 0
        self.slot_of: Dict[str, int] = {}
        self.class_of: Dict[int, int] = {}
        self.pool_id = None
        self.zone_id = None
        self.ct_id = None
        self.compactable = None
        self.compact_ok = False
        self.price_py: List[float] = []
        self.gp = 0
        self.kp = 0
        self.sort_key: Dict[int, float] = {}
        self.pop_reason = ""
        self.n_universe = 0
        self.cand_cnt = None
        self.cand_slot = None
        self.cand_occ = None
        self.sort_rank = None
        self.occ_span = 0


def default_pack_fn(device: torch.device):
    """Backend selection for the device half of the solve.

    - ``KARPENTER_TPU_SHARDED=1``: the mesh-sharded pack (parallel/mesh.py)
      over every card, the node-slot state over "data", the [G, C]
      passes' configs over "model" (for a scheduler on the CPU: a (1, 1)
      mesh of its device);
    - otherwise: None, the in-process pack on the scheduler's one device.
      The reference also takes the mesh on a multi-device TPU, where GSPMD
      makes it the faster backend; the port's shard kernels are slower
      than its one-device pack (PERF.md), so more cards alone do not pick
      it.
    """
    import os

    if os.environ.get("KARPENTER_TPU_SHARDED", "") != "1":
        return None
    from karpenter_tpu_torch.parallel.mesh import make_mesh, mesh_pack_fn

    if device.type == "cpu":
        return mesh_pack_fn(make_mesh(devices=[device]))
    return mesh_pack_fn()


class TorchScheduler:
    """Drop-in replacement for the oracle `Scheduler` backed by the pack
    kernel.  ``device`` defaults to the card; tests pass ``"cpu"``.

    ``pack_fn`` moves the device half of every solve elsewhere: a callable
    with `ops.packer.run_pack`'s signature and result, such as a solver
    sidecar's `RemoteSolver.pack_problem` (service/client.py).  With one
    set, the resident tensors neither seed nor serve a solve (their
    transfer contract is the in-process pack's), unless it is a mesh's
    (parallel/mesh.py `mesh_pack_fn`), whose resident tensors are sharded
    over the mesh.  Left None, the first solve picks the backend
    (`default_pack_fn`)."""

    def __init__(
        self,
        pools: Sequence[NodePool],
        instance_types: Dict[str, List[InstanceType]],
        existing: Sequence[StateNode] = (),
        daemonsets: Sequence[Pod] = (),
        zones: Sequence[str] = (),
        objective: str = "nodes",
        device=None,
        pack_fn=None,
    ):
        self.pools = list(pools)
        self.instance_types = instance_types
        self.existing = list(existing)
        self.daemonsets = list(daemonsets)
        self.zones = list(zones)
        self.objective = objective
        self.device = resolve_device(device)
        # the device half of the solve: None packs in this process on
        # `device`; a sidecar's RemoteSolver.pack_problem solves remotely
        self.pack_fn = pack_fn
        self._backend_picked = pack_fn is not None
        self.last_path = ""  # "tensor" | "oracle" | "hybrid"
        # "cuda_ffd" | "reference" | a pack_fn's kernel_name ("custom") |
        # "" (oracle)
        self.last_kernel = ""
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
        # batched consolidation what-ifs: one compiled base problem per
        # candidate universe, keyed like the compile cache, so a pass over
        # an unchanged cluster re-serves the prior compile
        self._removal_cache: dict = {}
        self.last_removal_batch = 0  # elements in the last batched dispatch

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
            self._removal_cache.clear()
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

    def _pick_backend(self) -> None:
        """Pick the default backend once, before the first resident seed
        or pack (the reference picks it at the same points)."""
        if not self._backend_picked:
            self._backend_picked = True
            if self.pack_fn is None:
                self.pack_fn = default_pack_fn(self.device)

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
                    self._pick_backend()
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
                self._resident.match(prob, self.device, self.pack_fn)
                if prob is not None and resident_capable(self.pack_fn)
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
        overflow retry falls back to the upload path.  The scheduler's own
        ``pack_fn`` (a mesh's, a sidecar's) takes every solve, retries
        included."""
        self._pick_backend()
        eff_pack = (
            pack_fn if pack_fn is not None
            else self.pack_fn if self.pack_fn is not None
            else self._upload_pack
        )
        # the profiler's timeline (under enable_profiling and profile_dir)
        # stays open through the last fetch: the launches only enqueue
        # work, and closing it before the fetch would miss the kernels
        with device_trace(TRACER):
            with phase("dispatch"), TRACER.span("solver.pack"):
                outs = eff_pack(prob, objective=self.objective)
            self.last_kernel = (
                last_kernel_name(self.device) if self.pack_fn is None
                else getattr(self.pack_fn, "kernel_name", "custom")
            )
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

    # ------------------------------------------------- batched removals
    _REMOVAL_CACHE_CAP = 4
    # below this many fresh elements a batched dispatch cannot beat the
    # sequential path's (cached-compile) solve
    MIN_REMOVAL_BATCH = 2

    def evaluate_removals(
        self,
        subsets: Sequence[Sequence[RemovalCandidate]],
        universe: Sequence[RemovalCandidate],
    ) -> List[RemovalVerdict]:
        """Answer N consolidation what-ifs with ONE compile + ONE batched
        launch.

        ``universe`` is the pass's full candidate set in RANK ORDER (every
        subset must be an order-preserving selection from it); the base
        problem compiles once against the solver's current ``existing``
        (the full remaining cluster) and is cached across calls by the
        compile cache's fingerprint.  Each subset is a removal mask over
        the live-node axis plus its pods' per-class counts in the subset's
        own class order, scanned in one batched launch; only per-element
        verdicts are decoded (fits / new-node count / replacement price).
        Elements the batch cannot answer bit-identically to the sequential
        simulation come back ``needs_host``.  Records the per-phase
        breakdown in ``last_phases``."""
        self.last_phases = phases = {}
        with phase_collect(phases), phase("other"):
            return self._evaluate_removals(
                [list(s) for s in subsets], tuple(universe)
            )

    def _evaluate_removals(
        self, subsets: List[List[RemovalCandidate]], universe: tuple
    ) -> List[RemovalVerdict]:
        self.last_removal_batch = 0  # only a real dispatch sets it
        base = self._removal_base(universe)
        if base.reason:
            return [
                RemovalVerdict(False, 0.0, True, base.reason) for _ in subsets
            ]
        if base.empty:
            # no reschedulable pods anywhere in the universe: every subset
            # trivially fits by pure deletion
            return [RemovalVerdict(True, 0.0) for _ in subsets]
        B = len(subsets)
        with phase("pad"):
            cnt_b, rm_b, perm_b, bad = self._subset_batch(base, subsets)
        verd = run_removal_verdicts(
            base.args, base.k_slots,
            base.pool_id, base.zone_id, base.ct_id, base.compactable,
            cnt_b, rm_b, perm_b, objective=self.objective,
        )
        self.last_removal_batch = B
        out: List[RemovalVerdict] = []
        with phase("decode"):
            for i in range(B):
                if i in bad:
                    out.append(RemovalVerdict(False, 0.0, True, bad[i]))
                    continue
                out.append(self._verdict_from_row(verd[i], base))
        return out

    def _subset_batch(self, base: _RemovalBase, subsets: List[List[RemovalCandidate]]):
        """Each subset's ``(counts in its class order, removed slots, class
        order)`` over the base, padded to a power-of-two batch: numpy
        ``cnt_b [Bp, Gp]``, ``rm_b [Bp, Kp]``, ``perm_b [Bp, Gp]``, and the
        elements the base cannot express (index -> reason)."""
        B = len(subsets)
        Bp = _bucket(max(B, 1), floor=self.MIN_REMOVAL_BATCH)
        gp, kp = base.gp, base.kp
        cnt_b = np.zeros((Bp, gp), np.int32)
        rm_b = np.zeros((Bp, kp), bool)
        perm_b = np.tile(np.arange(gp, dtype=np.int32), (Bp, 1))
        bad: Dict[int, str] = {}
        for i, subset in enumerate(subsets):
            order: List[int] = []
            seen = set()
            counts: Dict[int, int] = {}
            for cand in subset:
                slot = base.slot_of.get(cand.node_name)
                if slot is not None:
                    rm_b[i, slot] = True
                # a candidate absent from the live rows was cordoned away
                # by the compile on BOTH paths — nothing to mask
                for p in cand.pods:
                    g = base.class_of.get(id(p))
                    if g is None:
                        bad[i] = "pod outside the compiled universe"
                        break
                    if g not in seen:
                        seen.add(g)
                        order.append(g)
                    counts[g] = counts.get(g, 0) + 1
                if i in bad:
                    break
            if i in bad:
                continue
            # the subset's own compile orders classes by the FFD sort key
            # with ties in first-occurrence order over its pod list: replay
            # that order exactly, the scan is order-sensitive
            first_idx = {g: j for j, g in enumerate(order)}
            order.sort(key=lambda g: (base.sort_key[g], first_idx[g]))
            perm = order + [g for g in range(gp) if g not in seen]
            perm_b[i] = np.asarray(perm, np.int32)
            cnt_b[i] = np.asarray([counts.get(g, 0) for g in perm], np.int32)
        return cnt_b, rm_b, perm_b, bad

    @staticmethod
    def _verdict_from_row(row: np.ndarray, base: _RemovalBase) -> RemovalVerdict:
        """Decode ONE verdict row (RV_* layout) — shared by the per-subset
        batch and the population search, so a mask scored either way
        decodes to the identical RemovalVerdict."""
        if row[RV_LEFTOVER] > 0:
            # unschedulable — exact: the base guards exclude every
            # relax-eligible constraint shape
            return RemovalVerdict(False, 0.0)
        new_count = int(row[RV_NEW_COUNT])
        if new_count == 0:
            return RemovalVerdict(True, 0.0)
        if new_count == 1:
            # widen-equivalent price: committed config, improved by the
            # cheapest alternate — read back as PYTHON floats so the price
            # equals the sequential decode's
            price = base.price_py[int(row[RV_C_STAR])]
            if np.isfinite(row[RV_MIN_PRICE]):
                price = min(price, base.price_py[int(row[RV_C_MIN])])
            return RemovalVerdict(True, float(price))
        if row[RV_MERGE] > 0 and base.compact_ok:
            # >= 2 new nodes that decode compaction might merge to one —
            # the only decode step the verdict cannot replay
            return RemovalVerdict(False, 0.0, True, "compaction")
        return RemovalVerdict(False, 0.0)

    def evaluate_population(
        self,
        masks: np.ndarray,
        universe: Sequence[RemovalCandidate],
    ) -> List[RemovalVerdict]:
        """Score a POPULATION of removal masks in one batched launch.

        ``masks`` is a [P, U'] bool matrix over a rank-order PREFIX of
        ``universe`` (column j selects universe[j]); unlike
        :meth:`evaluate_removals`, the per-subset counts, removed slots and
        class orders are derived on the device from the mask
        (`population_verdicts`), so the host cost per round is one mask
        upload.  The base problem and the per-candidate population tensors
        come from the SAME cached removal base the subset batch uses, and
        each row decodes through the same `_verdict_from_row`, so a mask
        scored here equals the same subset scored per element.

        :meth:`dispatch_population` + :meth:`fetch_population` back to
        back."""
        return self.fetch_population(self.dispatch_population(masks, universe))

    def dispatch_population(
        self,
        masks: np.ndarray,
        universe: Sequence[RemovalCandidate],
    ) -> _PendingPopulation:
        """The ENQUEUE half of :meth:`evaluate_population`: build (or
        cache-hit) the removal base, pad the mask matrix and launch the
        population scoring on the current stream — NO device read.  Bases
        the host guards refuse resolve immediately (``ready`` verdicts on
        the handle) with no device work."""
        masks = np.asarray(masks, bool)
        pend = _PendingPopulation(P=int(masks.shape[0]))
        with phase_collect(pend.phases), phase("other"):
            base = self._removal_base(tuple(universe))
            P = pend.P
            if base.reason:
                pend.ready = [
                    RemovalVerdict(False, 0.0, True, base.reason)
                    for _ in range(P)
                ]
            elif base.empty:
                pend.ready = [RemovalVerdict(True, 0.0) for _ in range(P)]
            elif base.pop_reason:
                pend.ready = [
                    RemovalVerdict(False, 0.0, True, base.pop_reason)
                    for _ in range(P)
                ]
            else:
                with phase("pad"):
                    up = int(base.cand_slot.shape[0])
                    pp = _bucket(max(P, 1), floor=self.MIN_REMOVAL_BATCH)
                    mb = np.zeros((pp, up), bool)
                    mb[:P, : masks.shape[1]] = masks
                pend.base = base
                pend.out = dispatch_population_verdicts(
                    base.args, base.k_slots,
                    base.pool_id, base.zone_id, base.ct_id,
                    base.compactable, base.cand_cnt, base.cand_slot,
                    base.cand_occ, base.sort_rank, base.occ_span, mb,
                    objective=self.objective,
                )
        return pend

    def fetch_population(self, pend: _PendingPopulation) -> List[RemovalVerdict]:
        """The BLOCKING half: one read of the whole population's rows,
        decoded through `_verdict_from_row`.  Leaves ``last_phases`` /
        ``last_removal_batch`` as the one-call form does — the handle's
        phase dict accumulated across both halves."""
        self.last_phases = phases = pend.phases
        self.last_removal_batch = 0
        with phase_collect(phases), phase("other"):
            if pend.ready is not None:
                return pend.ready
            verd = fetch_verdict_rows(pend.out, "population_verdicts")
            self.last_removal_batch = pend.P
            out: List[RemovalVerdict] = []
            with phase("decode"):
                for i in range(pend.P):
                    out.append(self._verdict_from_row(verd[i], pend.base))
        return out

    def _removal_base(self, universe: tuple) -> _RemovalBase:
        pods = [p for cand in universe for p in cand.pods]
        fp = self._solve_fingerprint(pods)
        if fp is not None:
            ent = self._removal_cache.get(fp)
            if ent is not None:
                return ent[0]
        with phase("partition"):
            base = self._build_removal_base(universe, pods)
        if fp is not None:
            # pin every object the fingerprint's ids refer to (the compile
            # cache's aliasing contract)
            pins = (
                list(pods),
                [list(sn.pods) for sn in self.existing],
                tuple(self.pools),
                tuple(self.instance_types.values()),
                tuple(self.daemonsets),
            )
            if len(self._removal_cache) >= self._REMOVAL_CACHE_CAP:
                self._removal_cache.pop(next(iter(self._removal_cache)))
            self._removal_cache[fp] = (base, pins)
        return base

    @staticmethod
    def removal_search_guard(
        universe: Sequence[RemovalCandidate],
        existing: Sequence[StateNode],
    ) -> str:
        """The HOST-ONLY pre-compile guards of the removal base: the
        constraint shapes whose per-subset behavior the mask batch cannot
        replay bit-identically — pod-level topology coupling,
        preference/OR-term carriers, volume claims, and live (anti-)
        affinity carriers ON a candidate node.  A pure function of
        (universe, remaining nodes): returns the fallback reason, or ""
        when the mask encoding is sound."""
        for cand in universe:
            for p in cand.pods:
                if (
                    p.pod_affinity
                    or p.topology_spread
                    or p.preferred_affinity
                    or len(p.node_affinity_terms()) > 1
                ):
                    return "constraint-shape"
                if p.volume_claims:
                    return "volume-claims"
        names = {cand.node_name for cand in universe}
        for sn in existing:
            if sn.name in names and any(bp.pod_affinity for bp in sn.pods):
                return "live-carrier-on-candidate"
        return ""

    def _build_removal_base(self, universe: tuple, pods: List[Pod]) -> _RemovalBase:
        if not pods:
            return _RemovalBase(empty=True)
        why = self.removal_search_guard(universe, self.existing)
        if why:
            return _RemovalBase(reason=why)
        # the base's guards are a superset of the resident layer's
        # eligibility (ops/resident.py), so a resident hit serves tensors
        # the base could have compiled itself and a warm consolidation pass
        # skips the universe re-tensorize
        with phase("delta"), TRACER.span("solver.delta"):
            resident = self._resident.refresh(self, pods)
        if resident is not None:
            self.resident_hits += 1
            prob = resident.problem()
        else:
            sup_groups, unsupported, _why = partition_groups(
                pods, existing=self.existing, pools=self.pools
            )
            if unsupported:
                return _RemovalBase(reason="oracle-pods")
            prob = self._compile_tensor(
                [p for _, members in sup_groups for p in members], sup_groups
            )
            if not prob.supported:
                return _RemovalBase(reason="compile-unsupported")
            if prob.compile_relaxed:
                return _RemovalBase(reason="compile-relaxed")
            for cm in prob.classes:
                if (
                    cm.group_size
                    or cm.zone_pin
                    or cm.rep_override is not None
                    or cm.pool_allow is not None
                ):
                    return _RemovalBase(reason="macro-class")
            if len(prob.cnt) and (prob.maxper < BIG).any():
                return _RemovalBase(reason="tracked-signature")
            self._pick_backend()
            if self._resident.rebuild(
                self, pods, prob, self._catalog, consumer="removal"
            ) is not None:
                self.resident_rebuilds += 1
        base = _RemovalBase()
        base.prob = prob
        base.n_live = len(prob.used0)
        # worst case every pod of the largest subset needs its own node;
        # the universe total bounds every subset, so one padded K serves
        # the whole pass and slot overflow is impossible
        base.args, base.k_slots = pad_problem(
            prob, k_slots=base.n_live + max(prob.total_pods(), 1)
        )
        base.gp = base.args[0].shape[0]
        cp = base.args[5].shape[0]
        base.kp = base.k_slots
        base.slot_of = {
            prob.configs[prob.cfg0[i]].existing.name: i
            for i in range(base.n_live)
        }
        base.class_of = {
            id(p): g for g, cm in enumerate(prob.classes) for p in cm.pods
        }
        pool_idx: Dict[str, int] = {}
        zone_idx: Dict[str, int] = {}
        ct_idx: Dict[str, int] = {}
        pool_id = np.full(cp, -1, np.int32)
        zone_id = np.full(cp, -1, np.int32)
        ct_id = np.full(cp, -1, np.int32)
        for c, cfg in enumerate(prob.configs):
            if cfg.existing is not None:
                continue
            pool_id[c] = pool_idx.setdefault(cfg.pool.name, len(pool_idx))
            zone_id[c] = zone_idx.setdefault(cfg.zone, len(zone_idx))
            ct_id[c] = ct_idx.setdefault(cfg.capacity_type, len(ct_idx))
        compactable = np.zeros(base.gp, bool)
        for g, cm in enumerate(prob.classes):
            # decode compaction moves only label-less pods
            compactable[g] = not cm.pods[0].labels
            # the compile's FFD sort key (`constrained` always False under
            # the guards above): a subset's own compile re-sorts its
            # classes by this key, ties in first-occurrence order
            r = cm.requests
            base.sort_key[g] = -(r.cpu + r.memory / (4 * 2**30))
        # the base's tensors go to the device ONCE: every verdict batch and
        # population round of the pass reads them there (the one full
        # upload a consolidation pass pays per base, counted as
        # ``removal_base``)
        base.args = to_device(base.args, self.device, "removal_base")
        base.pool_id, base.zone_id, base.ct_id, base.compactable = to_device(
            (pool_id, zone_id, ct_id, compactable), self.device, "removal_base"
        )
        base.compact_ok = self._compact_guard(pods)
        base.price_py = [float(cfg.price) for cfg in prob.configs]
        self._build_population_tensors(base, universe, self.device)
        return base

    @staticmethod
    def _build_population_tensors(
        base: _RemovalBase, universe: tuple, device: torch.device
    ) -> None:
        """Per-candidate tensors for the population scoring: counts per
        class, live-column index, and the first-occurrence composite that
        lets the device replay each subset's FFD class order.

        The composite for class g in candidate j is ``j * max_pods +
        first_pos`` — candidates concatenate in universe rank order, so the
        min over a mask's selected rows IS the subset's first occurrence;
        sorting ``sort_rank * occ_span + occ`` reproduces the host's
        ``(sort_key, first_idx)`` sort exactly.  Everything is int32: the
        host guard refuses (``pop_reason``) where the composite key space
        could touch the sentinels."""
        u = len(universe)
        base.n_universe = u
        if u == 0:
            base.pop_reason = "empty-universe"
            return
        maxp = max((len(cand.pods) for cand in universe), default=0) + 1
        occ_span = u * maxp + 1
        ranks = {v: i for i, v in enumerate(sorted(set(base.sort_key.values())))}
        max_rank = max(ranks.values(), default=0)
        if (max_rank + 2) * occ_span >= min(POP_KEY_ABSENT, 2 * POP_OCC_ABSENT):
            base.pop_reason = "occ-composite-overflow"
            return
        up = _bucket(max(u, 1))
        cand_cnt = np.zeros((up, base.gp), np.int32)
        cand_slot = np.full(up, base.k_slots, np.int32)
        cand_occ = np.full((up, base.gp), POP_OCC_ABSENT, np.int32)
        for j, cand in enumerate(universe):
            s = base.slot_of.get(cand.node_name)
            if s is not None:
                cand_slot[j] = s
            for pos, p in enumerate(cand.pods):
                g = base.class_of[id(p)]
                cand_cnt[j, g] += 1
                if cand_occ[j, g] == POP_OCC_ABSENT:
                    cand_occ[j, g] = j * maxp + pos
        sort_rank = np.zeros(base.gp, np.int32)
        for g, v in base.sort_key.items():
            sort_rank[g] = ranks[v]
        # on the device like base.args (counted as ``population_tensors``):
        # a population round uploads only its masks
        base.cand_cnt, base.cand_slot, base.cand_occ, base.sort_rank = to_device(
            (cand_cnt, cand_slot, cand_occ, sort_rank), device,
            "population_tensors",
        )
        base.occ_span = occ_span

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
