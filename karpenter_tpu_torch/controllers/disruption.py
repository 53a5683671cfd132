"""Deprovisioning controller: expiration -> drift -> emptiness -> consolidation.

Re-derivation of karpenter-core's deprovisioning loop (reference website
v0.31 concepts/deprovisioning.md:14-24 ordering; designs/consolidation.md):

- **expiration**: nodes older than pool.disruption.expire_after are
  replaced (pods reschedule via the provisioner).
- **drift**: the CloudProvider's drift reasons (feature-gated).
- **emptiness**: pools with consolidationPolicy=WhenEmpty delete nodes
  holding no reschedulable pods after consolidate_after quiet time.
- **consolidation** (WhenUnderutilized): candidates ranked by disruption
  cost — fewest pods, soonest-expiring, lowest priority
  (designs/consolidation.md:23-40) — validated by a scheduling SIMULATION:
  a candidate may be deleted when its pods fit on the remaining nodes, or
  replaced when they fit with one strictly-cheaper new node.  Multi-node
  consolidation deletes a whole candidate subset with a single (optional)
  replacement.  Spot nodes are delete-only (deprovisioning.md:83-110).
- **replacement pre-spin**: a consolidation that needs a replacement
  LAUNCHES it first, waits for it to register + initialize, and only then
  cordons/deletes the candidates (deprovisioning.md:83-110 "Karpenter
  launches the replacement and waits for it to become ready before
  terminating"); a replacement that never comes up within the timeout is
  rolled back and the candidates stay untouched.
- **budgets**: pool.disruption.budgets caps concurrent disruptions per
  pool ("10%" or an absolute count).

Every mechanism funnels into the termination controller's graceful
cordon-and-drain.  Blockers (do-not-evict pods, already-disrupting nodes,
pods without controllers) follow designs/consolidation.md:46-53.

Port of ``karpenter_tpu/controllers/disruption.py`` with the imports
rewritten to this package.  The simulation scheduler is a `TorchScheduler`
on ``device`` (the card unless the caller asks for the CPU): the batched
what-ifs launch the batched FFD scan and the verdict kernels there, and the
sequential `_simulate` solves launch `choose_config` and the scan.
"""

from __future__ import annotations

import copy
import logging
import math
from dataclasses import dataclass
from time import perf_counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import NodeClaim, NodePool, Pod
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.provider import CloudProvider
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.metrics.registry import (
    REGISTRY,
    Registry,
    export_compile_cache_counters,
    export_resident_counters,
)
from karpenter_tpu_torch.scheduling.popsearch import SearchPlan
from karpenter_tpu_torch.scheduling.solver import RemovalCandidate, TorchScheduler
from karpenter_tpu_torch.state.cluster import Cluster, StateNode
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.locks import note_access

log = logging.getLogger(__name__)

# how many top-ranked candidates the LEGACY drop-one descent considers
# per pass (the population search replaces this with SEARCH_UNIVERSE_CAP)
MULTI_NODE_CANDIDATES = 10

# DEPRECATED alias: the pre-population sequential simulation budget.
# With the batched path it counted batch ELEMENTS, which the population
# search would either trivially exhaust (one round is a whole population)
# or ignore — so the search is sized by Settings.consolidation_search_rounds ×
# consolidation_population_size instead (budget ≈ rounds × population is
# the mapping), and this constant caps only the legacy descent kept
# behind ``use_population_search = False``.
MULTI_NODE_SIM_BUDGET = 24

# population-search defaults; Settings.consolidation_search_rounds /
# consolidation_population_size override them through the operator
SEARCH_ROUNDS = 2
POPULATION_SIZE = 128

# removal masks are dense over the candidate universe axis; cap it so the
# [population, universe] tensors stay bounded (rank order means the cap
# drops only the least-attractive candidates)
SEARCH_UNIVERSE_CAP = 128

# how long a consolidation replacement may take to register+initialize
# before the action is rolled back (the reference's machine liveness bound
# is 15m; consolidation aborts much sooner when validation fails)
REPLACEMENT_TIMEOUT = 600.0


@dataclass
class _PendingReplacement:
    """A launched-but-not-yet-ready consolidation replacement."""

    claim_name: str
    candidate_names: List[str]  # claims to delete once the replacement is up
    pod_keys: List[str]  # pods the SIMULATION placed on the replacement
    created_at: float
    reason: str


@dataclass
class _PendingMasks:
    """One population round mid-flight between its dispatch and join
    halves: the proposed keys/subsets, which of them went to the device
    (``fresh`` rows of the in-flight ``pending`` handle), or nothing —
    a round below the batch floor resolves fully sequentially at join."""

    keys: List[tuple]
    subsets: List[List["Candidate"]]
    fresh: List[int] = None  # type: ignore[assignment]
    pending: Optional[object] = None  # solver _PendingPopulation


@dataclass
class _Speculation:
    """A consolidation search speculatively started at a tick boundary
    (docs/designs/pipelined-reconcile.md).

    Everything here was computed from the cluster state fingerprinted in
    ``fp``; the authoritative pass ADOPTS it only when its own freshly
    computed fingerprint is identical — the verdicts are pure functions
    of that state, so an adopted search is bit-identical to the
    synchronous search the sequential schedule would have run, and a
    mismatch discards the whole object (verdicts, plan, memo) unused.
    ``seed`` is the pass seed the speculation assumed
    (``_search_seq + 1`` — never consumed until the authoritative pass
    increments it)."""

    fp: tuple
    seed: int
    cands: List["Candidate"]  # the capped search universe, rank order
    pool_candidates: List["Candidate"]  # the full ranked pass list
    pool_inventory: Tuple
    ev: "_RemovalEvaluator"
    plan: SearchPlan
    observed: int = 0  # rounds already observed into the plan
    pending_keys: Optional[List[tuple]] = None  # the in-flight round
    pending: Optional[_PendingMasks] = None
    t_enqueued: float = 0.0  # perf_counter at the last async enqueue
    overlap_s: float = 0.0  # host wall time the device worked under


class _Nomination(NamedTuple):
    """A pod evicted off a consolidated candidate, waiting to be steered
    onto its replacement once it re-pends."""

    target: str  # replacement claim/node name
    candidate_names: Tuple[str, ...]  # nodes it is draining off of
    since: float  # reap timestamp; entries age out (permanently PDB-blocked
    # pods must not protect their target forever)


@dataclass
class Candidate:
    claim: NodeClaim
    state: StateNode
    pool: NodePool
    reschedulable: List[Pod]
    price: float

    def disruption_cost(self) -> Tuple:
        """Rank: fewest pods first, then lowest pod priority, then price
        (designs/consolidation.md:23-40)."""
        prio = max((p.priority for p in self.reschedulable), default=0)
        cost = sum(p.deletion_cost() for p in self.reschedulable)
        return (len(self.reschedulable), prio, cost, -self.price)


class _RemovalEvaluator:
    """Memoizing evaluation front-end for one consolidation pass.

    Turns the pass's candidate what-ifs into batched device dispatches
    (`TorchScheduler.evaluate_removals` — one compile + one batched pack
    per batch) while preserving the sequential path's semantics exactly:

    - memoization by candidate-name set, shared between the drop-one
      descent, its prefix-scan floor, and the single-node scan;
    - the evaluation BUDGET counts batch elements: every fresh element —
      batched or sequential — bumps ``sims`` by one, so
      MULTI_NODE_SIM_BUDGET means the same thing on both paths;
    - elements the batch cannot answer bit-identically (`needs_host`
      verdicts, or a whole-pass fallback reason) evaluate LAZILY through
      the sequential `_simulate`, keeping the old early-exit behavior;
    - the full decode (the replacement VirtualNode) runs host-side only
      for the chosen winner (`vnode_for`), never per element.
    """

    def __init__(
        self,
        dc: "DisruptionController",
        candidates: Sequence[Candidate],
        pool_inventory: Tuple,
    ):
        self.dc = dc
        self.pool_inventory = pool_inventory
        self.sims = 0  # fresh evaluations, in batch ELEMENTS
        # key -> (fits, price, vnode, authoritative) — authoritative
        # entries came from the sequential decode; batched verdicts carry
        # False and are re-confirmed before any ACTION (vnode_for)
        self._memo: Dict[
            frozenset, Tuple[bool, float, Optional[object], bool]
        ] = {}
        # the pass's candidate universe in RANK ORDER — every subset the
        # controller evaluates is an order-preserving selection from it,
        # which is what lets the batch replay each subset's compile order
        self._universe = tuple(
            RemovalCandidate(c.state.name, tuple(c.reschedulable))
            for c in candidates
        )

    def _key(self, subset: Sequence[Candidate]) -> frozenset:
        return frozenset(c.claim.name for c in subset)

    def known(self, subset: Sequence[Candidate]) -> bool:
        return self._key(subset) in self._memo

    def _sync_scheduler(self) -> None:
        """Point the simulation scheduler at the FULL remaining cluster
        (sequential fallbacks re-aim it at per-subset remainders; the
        batched base must always compile against the full set).  The
        snapshot comes from the SAME helper `_simulate` uses, so the two
        paths cannot silently diverge on what counts as remaining."""
        dc = self.dc
        pools, inventory = self.pool_inventory
        dc._scheduler.update(
            pools,
            inventory,
            existing=dc._remaining_snapshot(frozenset()),
            daemonsets=dc.kube.daemonset_pods(),
        )

    def prefetch(self, subsets: Sequence[Sequence[Candidate]]) -> None:
        """Batch-evaluate every not-yet-memoized subset in ONE device
        dispatch.  `needs_host` elements stay unmemoized and resolve
        lazily (sequentially) on their first `result` call.

        Deliberately eager over the WHOLE set: in the dominant
        steady-state pass nothing is acceptable and every subset gets
        consumed anyway, so one full dispatch is strictly cheaper than
        any evaluate-top-first hybrid, which would add a sequential host
        solve to every no-action tick to save one dispatch on the rarer
        accept tick."""
        fresh_keys = set()
        fresh: List[Sequence[Candidate]] = []
        for s in subsets:
            k = self._key(s)
            if k in self._memo or k in fresh_keys:
                continue
            fresh_keys.add(k)
            fresh.append(s)
        if not fresh or not self.dc.use_batched_consolidation:
            return
        sched = self.dc._scheduler
        if len(fresh) < sched.MIN_REMOVAL_BATCH:
            return
        self._sync_scheduler()
        elements = [
            [
                RemovalCandidate(c.state.name, tuple(c.reschedulable))
                for c in s
            ]
            for s in fresh
        ]
        verdicts = sched.evaluate_removals(elements, self._universe)
        reg = self.dc.registry
        if sched.last_removal_batch:
            reg.observe(
                "karpenter_consolidation_eval_batch_size",
                sched.last_removal_batch,
            )
            # a SEPARATE family from karpenter_solver_phase_seconds: that
            # histogram is the provisioner's per-solve anatomy, and mixing
            # 60-element verdict batches into the same distribution would
            # skew its percentiles (the sim wall-profile reads it too)
            for phase_name, seconds in sched.last_phases.items():
                reg.observe(
                    "karpenter_consolidation_phase_seconds",
                    seconds,
                    {"phase": phase_name},
                )
        answered = 0
        for s, v in zip(fresh, verdicts):
            if v.needs_host:
                continue
            self._memo[self._key(s)] = (
                v.fits, v.replacement_price, None, False,
            )
            self.sims += 1
            answered += 1
        if answered:
            reg.inc(
                "karpenter_consolidation_evals_total",
                {"path": "batched"},
                by=answered,
            )

    def dispatch_masks(
        self, cands: Sequence[Candidate], keys: Sequence[tuple]
    ) -> "_PendingMasks":
        """The ENQUEUE half of :meth:`evaluate_masks`: when the batched
        backend is on and the round carries enough fresh masks, aim the
        scheduler at the full remaining cluster and DISPATCH the
        population kernel as an async JAX enqueue — no device read, so
        the caller (the pipelined reconcile's dispatch/advance stages)
        can run host work while the device scores the round."""
        subsets = [[cands[i] for i in key] for key in keys]
        pm = _PendingMasks(keys=list(keys), subsets=subsets)
        dc = self.dc
        if dc.use_batched_consolidation:
            fresh = [
                i
                for i, s in enumerate(subsets)
                if self._key(s) not in self._memo
            ]
            sched = dc._scheduler
            if len(fresh) >= sched.MIN_REMOVAL_BATCH:
                self._sync_scheduler()
                # the base compiles over the CAPPED search universe —
                # the same scope the controller's pre-check guarded — so
                # the mask width, the population tensors, and the slot
                # bound are all sized by the cap, and a constraint
                # carrier BEYOND the cap can neither refuse the base nor
                # widen the device work (the full-universe base remains
                # the single scan's, via evaluate_removals)
                universe = self._universe[: len(cands)]
                masks = np.zeros((len(fresh), len(universe)), bool)
                for r, i in enumerate(fresh):
                    masks[r, list(keys[i])] = True
                pm.fresh = fresh
                pm.pending = sched.dispatch_population(masks, universe)
        return pm

    def complete_masks(
        self, pm: "_PendingMasks"
    ) -> List[Tuple[bool, float]]:
        """The JOIN half: fetch the in-flight verdicts (the hard barrier
        before any of them can influence an action), memoize what the
        kernel answered, and resolve the rest — and everything, when no
        dispatch happened — through the sequential `result`."""
        dc = self.dc
        if pm.pending is not None:
            sched = dc._scheduler
            verdicts = sched.fetch_population(pm.pending)
            reg = dc.registry
            if sched.last_removal_batch:
                reg.observe(
                    "karpenter_consolidation_eval_batch_size",
                    sched.last_removal_batch,
                )
                for phase_name, seconds in sched.last_phases.items():
                    reg.observe(
                        "karpenter_consolidation_search_phase_seconds",
                        seconds,
                        {"phase": phase_name},
                    )
            answered = 0
            for r, i in zip(range(len(pm.fresh)), pm.fresh):
                v = verdicts[r]
                if v.needs_host:
                    continue
                self._memo[self._key(pm.subsets[i])] = (
                    v.fits, v.replacement_price, None, False,
                )
                self.sims += 1
                answered += 1
            if answered:
                reg.inc(
                    "karpenter_consolidation_evals_total",
                    {"path": "batched"},
                    by=answered,
                )
        return [self.result(s) for s in pm.subsets]

    def evaluate_masks(
        self, cands: Sequence[Candidate], keys: Sequence[tuple]
    ) -> List[Tuple[bool, float]]:
        """Score one population round: ``keys`` are sorted index tuples
        into ``cands`` (a rank-order prefix of the pass's universe).  On
        the batched path every not-yet-memoized mask is scored in ONE
        batched device dispatch (`TorchScheduler.evaluate_population` —
        counts, removed slots, and class order derived on device from the
        mask); elements the kernel cannot answer bit-identically — and
        everything, when ``use_batched_consolidation`` is off — resolve
        through the sequential `result`.  The (fits, price) pairs are
        therefore IDENTICAL whichever backend answered, which is what
        lets the two modes take the same actions tick for tick.

        Dispatch + join back to back — the sequential schedule; the
        pipelined reconcile calls the same two halves at different
        points of the tick, so the verdicts cannot differ between the
        schedules."""
        return self.complete_masks(self.dispatch_masks(cands, keys))

    def result(self, subset: Sequence[Candidate]) -> Tuple[bool, float]:
        """(fits, replacement_price) for one subset — memoized; evaluates
        sequentially when the batch did not answer it."""
        key = self._key(subset)
        got = self._memo.get(key)
        if got is None:
            if self.dc.use_batched_consolidation:
                # a what-if the batched dispatch could not answer
                # bit-identically (needs_host element, whole-pass
                # fallback reason, or a below-threshold batch) resolves
                # through the sequential solver — ledgered so "why was
                # this tick's consolidation slow?" is answerable
                self.dc.registry.event(
                    "VerdictFallback", subset_size=len(subset)
                )
            fits, price, vnode = self.dc._simulate(
                list(subset), self.pool_inventory
            )
            got = self._memo[key] = (fits, price, vnode, True)
            self.sims += 1
            self.dc.registry.inc(
                "karpenter_consolidation_evals_total",
                {"path": "sequential"},
            )
        return got[0], got[1]

    def vnode_for(
        self, subset: Sequence[Candidate]
    ) -> Tuple[bool, float, Optional[object]]:
        """Full host-side decode for the CHOSEN subset — the result every
        ACTION (delete or replace) must be derived from.  Sequential memo
        entries are already authoritative; a batched verdict makes the
        winner (and only the winner) re-run the sequential simulation,
        with any disagreement counted and the sequential answer kept."""
        key = self._key(subset)
        got = self._memo.get(key)
        if got is not None and got[3]:
            return got[0], got[1], got[2]
        full = self.dc._simulate(list(subset), self.pool_inventory)
        if got is not None and (
            got[0] != full[0] or abs(got[1] - full[1]) > 1e-9
        ):
            # a parity break between the batched verdict and the
            # sequential decode — must never happen (the parity suite
            # enforces it); act on the sequential result and surface it
            log.warning(
                "batched consolidation verdict mismatch for %s: "
                "batched=%s sequential=%s",
                sorted(key), got[:2], full[:2],
            )
            self.dc.registry.inc(
                "karpenter_consolidation_verdict_mismatch_total"
            )
        self._memo[key] = (full[0], full[1], full[2], True)
        return full


class DisruptionController:
    # batched what-if evaluation for consolidation (one compile + one
    # batched device dispatch per candidate batch / population round);
    # False forces every simulation down the sequential per-subset path.
    # Decisions are bit-identical either way
    # (tests/test_consolidation_batch.py, tests/test_consolidation_search
    # .py) — the flag switches the VERDICT backend, never the search.
    use_batched_consolidation = True
    # population-annealing subset search over removal masks
    # (scheduling/popsearch.py + TorchScheduler.evaluate_population);
    # False reverts to the legacy budget-capped drop-one descent
    # (_consolidate_multi_descent)
    use_population_search = True

    def __init__(
        self,
        kube: KubeStore,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        termination: TerminationController,
        clock: Clock,
        feature_gate_drift: bool = True,
        registry: Registry = REGISTRY,
        search_rounds: int = SEARCH_ROUNDS,
        population_size: int = POPULATION_SIZE,
        device=None,
    ):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.termination = termination
        self.clock = clock
        self.feature_gate_drift = feature_gate_drift
        self.registry = registry
        # population-search sizing (Settings.consolidation_search_rounds /
        # consolidation_population_size) and the per-pass seed sequence:
        # seeds derive from a pass COUNTER, not the clock, so twin runs
        # and record/replay propose identical mask schedules
        self.search_rounds = max(int(search_rounds), 1)
        self.search_population = max(int(population_size), 4)
        self._search_seq = 0
        self._last_non_empty: Dict[str, float] = {}  # claim -> last busy ts
        self._budgets: Dict[str, int] = {}  # per-pool allowance, per pass
        # long-lived simulation scheduler (catalog cache shared across
        # candidate evaluations and reconciles), on the card unless the
        # caller asks for the CPU
        self._scheduler = TorchScheduler(
            [], {}, objective="cost", device=device
        )
        # replacement pre-spin state
        self._pending: Dict[str, _PendingReplacement] = {}
        self._nominate_later: Dict[str, _Nomination] = {}
        # compile-cache counter values already exported to the registry
        self._cc_exported = (0, 0)
        self._res_exported = (0, 0)  # resident hit/rebuild, same contract
        # pod key -> (orig pod, its epoch, resolved reqs, simulation copy):
        # a pod whose stored volume requirements differ from the fresh
        # resolution gets ONE stable copy reused across simulations and
        # passes, instead of a new object (= new id churning the solver's
        # id-keyed caches) per _simulate call
        self._volume_copies: Dict[str, Tuple] = {}
        # pipelined reconcile (pipeline.py): the speculative search the
        # dispatch/advance stages built at tick boundaries, adopted by
        # the authoritative pass only on a fingerprint match; and the
        # cross-pass annealing warm start — the previous pass's
        # surviving masks keyed by its universe fingerprint
        self._speculation: Optional[_Speculation] = None
        self._warm_store: Optional[Tuple[tuple, List[tuple]]] = None

    # ------------------------------------------------------------- reconcile
    def reconcile(self) -> None:
        """One pass in the reference's mechanism order; at most one
        disruption action per pass per mechanism keeps the cluster
        observable between steps (the reference serializes the same way).

        Under the pipelined schedule this is also the JOIN: the pass
        adopts the boundary-dispatched speculation inside `_consolidate`
        (fingerprint-guarded), and any speculation still unconsumed when
        the pass ends — an earlier mechanism acted, so consolidation
        never ran — is dropped here, never carried across ticks."""
        with self.registry.time(
            "karpenter_deprovisioning_evaluation_duration_seconds"
        ):
            try:
                self._reconcile_pass()
            finally:
                if self._speculation is not None:
                    self._drop_speculation("unused")
                self._cc_exported = export_compile_cache_counters(
                    self.registry, self._scheduler, "disruption",
                    self._cc_exported,
                )
                self._res_exported = export_resident_counters(
                    self.registry, self._scheduler, "disruption",
                    self._res_exported,
                )

    # ------------------------------------------------- pipelined stages
    def reconcile_dispatch(self) -> None:
        """The pipelined DISPATCH stage, run read-only at the END of a
        tick: compute the consolidation pass the next tick would run,
        propose its round-0 masks (seed ``_search_seq + 1``, warm-
        started like the authoritative pass would), and enqueue the
        device scoring asynchronously — so the device works through the
        tick tail, the inter-tick sleep, and the next tick's host
        phases.  Mutates NOTHING a decision reads: the plan/evaluator
        live on the speculation object, the pass seed is not consumed,
        and the authoritative pass discards everything unless its own
        fingerprint of the same inputs is identical."""
        if self._speculation is not None:
            # the previous speculation was never consumed (reconcile
            # skipped by backoff / abdication): stale by construction
            self._drop_speculation("unused")
        if not (self.use_population_search and self.use_batched_consolidation):
            return  # nothing to overlap: the pass would run host-side
        budgets = self._remaining_budgets()
        pool_candidates = self._ranked_consolidatables(budgets)
        cands = list(pool_candidates[:SEARCH_UNIVERSE_CAP])
        if len(cands) < 2:
            return
        inv = self._pool_inventory()
        ev = _RemovalEvaluator(self, pool_candidates, inv)
        if TorchScheduler.removal_search_guard(
            ev._universe[: len(cands)],
            self._remaining_snapshot(frozenset()),
        ):
            return  # the pass would take the legacy descent: host-bound
        fp = self._pass_fingerprint(pool_candidates, inv)
        if fp is None:
            # exotic inputs the fingerprint refuses to cover: no
            # speculation is POSSIBLE — counted so a fingerprint bug
            # (every tick refusing) is visible on a dashboard instead
            # of reading as a quiet cluster
            self.registry.inc(
                "karpenter_pipeline_speculation_total",
                {"controller": "disruption", "outcome": "refused"},
            )
            return
        plan = SearchPlan(
            n=len(cands),
            prices=[c.price for c in cands],
            spot=[
                c.claim.capacity_type == L.CAPACITY_TYPE_SPOT for c in cands
            ],
            population=self.search_population,
            rounds=self.search_rounds,
            seed=self._search_seq + 1,
            warm=self._warm_masks(cands),
        )
        keys = plan.propose()
        if not keys:
            return
        spec = _Speculation(
            fp=fp, seed=self._search_seq + 1, cands=cands,
            pool_candidates=pool_candidates, pool_inventory=inv,
            ev=ev, plan=plan,
        )
        spec.pending_keys = keys
        spec.pending = ev.dispatch_masks(cands, keys)
        spec.t_enqueued = perf_counter()
        # Eraser lockset annotation (analysis/sanitizer.py): the
        # speculation slot is single-threaded BY DESIGN (dispatch/
        # advance run on the tick thread); a future threaded
        # pipeline touching it unprotected becomes an rt-race
        note_access("DisruptionController._speculation")
        self._speculation = spec

    def reconcile_advance(self) -> None:
        """The pipelined ADVANCE stage, run at the START of the next
        tick: if the speculation's inputs are still fingerprint-current,
        join the in-flight round (the device had the whole tick tail to
        score it) and chain the next round's async dispatch — which then
        overlaps the provisioning solve and every other host phase up to
        the disruption slot.  Any drift discards the speculation here,
        before a single verdict is read."""
        spec = self._speculation
        if spec is None:
            return
        # freshly fetched inventory (cached provider lists — cheap), so
        # an ICE-masked or rolled type list fails the check here instead
        # of wasting a round-1 dispatch the join would discard anyway
        if self._pass_fingerprint(
            self._ranked_consolidatables(self._remaining_budgets()),
            self._pool_inventory(),
        ) != spec.fp:
            self._drop_speculation("stale")
            return
        if spec.pending_keys is None:
            return  # every round already observed; nothing in flight
        spec.overlap_s += perf_counter() - spec.t_enqueued
        results = spec.ev.complete_masks(spec.pending)
        spec.plan.observe(spec.pending_keys, results)
        spec.observed += 1
        keys = spec.plan.propose()
        if keys:
            spec.pending_keys = keys
            spec.pending = spec.ev.dispatch_masks(spec.cands, keys)
            spec.t_enqueued = perf_counter()
        else:
            spec.pending_keys = None
            spec.pending = None

    def _drop_speculation(self, outcome: str) -> None:
        self.registry.inc(
            "karpenter_pipeline_speculation_total",
            {"controller": "disruption", "outcome": outcome},
        )
        self._speculation = None

    def _take_speculation(
        self, pool_candidates: List["Candidate"], pool_inventory: Tuple
    ) -> Optional[_Speculation]:
        """The JOIN's fingerprint guard: hand the authoritative pass the
        speculation ONLY when the pass's own freshly computed inputs
        fingerprint-match what the speculation read — otherwise every
        speculative verdict is discarded and the pass recomputes
        synchronously, which is what keeps pipelining on/off
        action-identical tick for tick."""
        note_access("DisruptionController._speculation")
        spec = self._speculation
        if spec is None:
            return None
        self._speculation = None
        if spec.seed != self._search_seq + 1:
            self._drop_speculation("stale")
            return None
        if self._pass_fingerprint(pool_candidates, pool_inventory) != spec.fp:
            self._drop_speculation("stale")
            return None
        self.registry.inc(
            "karpenter_pipeline_speculation_total",
            {"controller": "disruption", "outcome": "adopted"},
        )
        return spec

    def _ranked_consolidatables(
        self, budgets: Dict[str, int]
    ) -> List["Candidate"]:
        """The consolidation pass's ranked candidate list — the ONE
        selection both the authoritative pass (`_reconcile_pass` →
        `_consolidate`) and the speculative dispatch compute, so the
        fingerprint comparison is between like and like."""
        reserved = {
            name
            for pr in self._pending.values()
            for name in pr.candidate_names
        }
        protected = {pr.claim_name for pr in self._pending.values()}
        protected |= {n.target for n in self._nominate_later.values()}
        out = [
            c
            for c in self._candidates(budgets)
            if c.claim.name not in reserved
            and c.claim.name not in protected
            and not c.state.nominated
            and c.pool.disruption.consolidation_policy == "WhenUnderutilized"
            and self._consolidatable(c)
        ]
        out.sort(key=lambda c: c.disruption_cost())
        return out

    def _pass_fingerprint(
        self, ranked: List["Candidate"], pool_inventory: Tuple
    ) -> Optional[tuple]:
        """Identity+epoch fingerprint of EVERYTHING a consolidation
        search reads (the same machinery as the solver's compile-cache
        fingerprints): the ranked candidates with their pods and pools,
        the remaining-cluster snapshot by content, the inventory list
        identities, daemonsets, and the search knobs.  None — which
        never matches — on exotic inputs."""
        try:
            pools, inventory = pool_inventory
            cand_fp = tuple(
                (
                    c.claim.name,
                    c.claim.capacity_type,
                    c.claim.deleted_at is None,
                    c.price,
                    tuple(sorted(c.claim.conditions.items())),
                    id(c.pool),
                    c.pool.__dict__.get("_mut", 0),
                    tuple(
                        (id(p), p.__dict__["_mut"]) for p in c.reschedulable
                    ),
                )
                for c in ranked
            )
            inv_fp = tuple(
                sorted((name, id(types)) for name, types in inventory.items())
            )
            pools_fp = tuple(
                (id(p), p.__dict__.get("_mut", 0)) for p in pools
            )
            ds_fp = tuple(
                (id(d), d.__dict__.get("_mut", 0))
                for d in self.kube.daemonset_pods()
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
                    sn.nominated,
                    tuple(
                        (id(bp), bp.__dict__.get("_mut", 0))
                        for bp in sn.pods
                    ),
                )
                for sn in self._remaining_snapshot(frozenset())
            )
        except Exception:  # exotic duck-typed inputs: never adoptable
            return None
        knobs = (
            self.search_rounds,
            self.search_population,
            SEARCH_UNIVERSE_CAP,
            self.use_batched_consolidation,
            self.use_population_search,
        )
        return (cand_fp, inv_fp, pools_fp, ds_fp, ex_fp, knobs)

    def _universe_fingerprint(self, cands: List["Candidate"]) -> tuple:
        """The warm-start validity key: mask index i must still mean the
        same node with the same reschedulable pods and price, or the
        previous pass's surviving masks are meaningless."""
        return tuple(
            (
                c.claim.name,
                c.price,
                c.claim.capacity_type,
                tuple(sorted(p.key() for p in c.reschedulable)),
            )
            for c in cands
        )

    def _warm_masks(self, cands: List["Candidate"]) -> List[tuple]:
        """The previous pass's surviving masks, when the candidate
        universe fingerprint is unchanged — otherwise nothing (the
        indices would name different nodes)."""
        if self._warm_store is None:
            return []
        ufp, masks = self._warm_store
        if ufp != self._universe_fingerprint(cands):
            return []
        return list(masks)

    def _reconcile_pass(self) -> None:
        if self._volume_copies:
            # drop simulation copies of pods that left the cluster
            self._volume_copies = {
                k: v for k, v in self._volume_copies.items()
                if k in self.kube.pods
            }
        self._nominate_evicted()
        # when a replacement just became ready (or rolled back), let the
        # candidate drain + pod rebinding settle before CONSOLIDATING
        # again — otherwise the just-ready, not-yet-populated
        # replacement looks like an empty candidate and consolidation
        # would delete the very node it pre-spun.  Expiration, drift and
        # emptiness are not at risk (the replacement and nomination
        # targets are in `protected`) and still run this pass.
        reaped = self._reap_replacements()
        self._budgets = self._remaining_budgets()
        reserved = {
            name
            for pr in self._pending.values()
            for name in pr.candidate_names
        }
        # protect in-flight replacements until their nominated pods
        # bind: the pre-spun claim itself, plus any node still the
        # target of a pending nomination
        protected = {pr.claim_name for pr in self._pending.values()}
        protected |= {n.target for n in self._nominate_later.values()}
        candidates = [
            c
            for c in self._candidates()
            if c.claim.name not in reserved
            and c.claim.name not in protected
        ]
        if self._expire(candidates):
            return
        if self.feature_gate_drift and self._drift(candidates):
            return
        if self._emptiness(candidates):
            return
        if reaped:
            return
        # consolidation only: a slow-registering replacement in pool A
        # must not freeze consolidation in pool B (_launch_replacement
        # enforces one in-flight replacement per TARGET pool), and a
        # node holding in-flight pod nominations is not consolidatable
        # (its usage is about to grow) — but it still expires/drifts.
        # The pass recomputes its own ranked list through
        # _ranked_consolidatables: the ONE selection the speculative
        # dispatch also computes, so the fingerprint guard compares
        # like with like by construction.
        self._consolidate()

    # ------------------------------------------------- replacement pre-spin
    def _nominate_evicted(self) -> None:
        """Steer pods evicted off consolidated candidates onto their
        replacement node as soon as they re-pend.  Eviction happens
        asynchronously in the termination controller and can stall on PDBs,
        so a pod still bound to a DRAINING candidate stays in the ledger."""
        now = self.clock.now()
        for pod_key, nom in list(self._nominate_later.items()):
            pod = self.kube.pods.get(pod_key)
            if pod is None:
                self._nominate_later.pop(pod_key, None)
                continue
            if pod.node_name:
                if pod.node_name in nom.candidate_names:
                    # still draining (e.g. PDB-blocked); keep waiting — but
                    # not forever: a permanently blocked pod must not
                    # protect its target / hide its capacity indefinitely.
                    # The age-out applies ONLY while the pod is stuck on a
                    # draining candidate, so a pod that finally drains
                    # after the deadline is still nominated below.
                    if now - nom.since > REPLACEMENT_TIMEOUT:
                        self._nominate_later.pop(pod_key, None)
                    continue
                # rebound somewhere else already
                self._nominate_later.pop(pod_key, None)
                continue
            if nom.target not in self.kube.node_claims and (
                self.kube.nodes.get(nom.target) is None
            ):
                self._nominate_later.pop(pod_key, None)
                continue
            self.cluster.nominate(pod_key, nom.target)
            self._nominate_later.pop(pod_key, None)

    def _reap_replacements(self) -> bool:
        """Progress in-flight replacements: ready -> delete the candidates;
        timed out / vanished -> roll back and keep the candidates.  Returns
        True when any replacement was resolved this pass (the reconcile
        then skips consolidation — only that mechanism — so the resulting
        evictions/rebinds settle before the next subset search)."""
        acted = False
        for name, pr in list(self._pending.items()):
            claim = self.kube.node_claims.get(name)
            if claim is None or claim.deleted_at is not None:
                # replacement died; abort the action, free the candidates
                self._uncordon_candidates(pr)
                self._pending.pop(name)
                acted = True
                continue
            if claim.registered and claim.initialized:
                cand_names = tuple(pr.candidate_names)
                for cand_name in pr.candidate_names:
                    cand = self.kube.node_claims.get(cand_name)
                    if cand is not None:
                        self.registry.event(
                            "NodeDisrupted", node=cand_name,
                            reason=pr.reason, replacement=claim.name,
                        )
                        self.termination.mark_for_deletion(
                            cand, reason=pr.reason
                        )
                now = self.clock.now()
                for pk in pr.pod_keys:
                    self._nominate_later[pk] = _Nomination(
                        claim.name, cand_names, now
                    )
                self._pending.pop(name)
                acted = True
                continue
            if self.clock.now() - pr.created_at > REPLACEMENT_TIMEOUT:
                # rollback: the replacement never came up; terminate it,
                # un-cordon the candidates, leave them untouched
                log.warning(
                    "consolidation replacement %s timed out; rolling back",
                    name,
                )
                self.kube.record_event(
                    "NodeClaim", "ReplacementTimeout", name, pr.reason
                )
                self.registry.inc(
                    "karpenter_deprovisioning_replacement_failed",
                    {"reason": "timeout"},
                )
                self.registry.event(
                    "NodeDisrupted", node=claim.name,
                    reason="consolidation/rollback",
                )
                self.termination.mark_for_deletion(
                    claim, reason="consolidation/rollback"
                )
                self._uncordon_candidates(pr)
                self._pending.pop(name)
                acted = True
        return acted

    def _launch_replacement(
        self, cands: Sequence[Candidate], vnode, reason: str
    ) -> bool:
        """Launch the simulation's replacement node BEFORE disrupting the
        candidates (deprovisioning.md:83-110)."""
        from karpenter_tpu_torch.controllers.provisioning import claim_from_vnode

        # one replacement in flight per TARGET pool — keyed on where the
        # replacement lands, not where the candidates live, so a cheapest
        # -in-pool-A vnode for pool-B candidates still respects pool A's
        # in-flight replacement
        pending_pools = {
            self.kube.node_claims[pr.claim_name].pool_name
            for pr in self._pending.values()
            if pr.claim_name in self.kube.node_claims
        }
        if vnode.pool.name in pending_pools:
            return False
        # check-and-consume budget per candidate (all-or-nothing)
        taken: List[str] = []
        for c in cands:
            b = self._budgets.get(c.pool.name, 1)
            if b <= 0:
                for pname in taken:
                    self._budgets[pname] += 1
                return False
            self._budgets[c.pool.name] = b - 1
            taken.append(c.pool.name)
        # pool limits: during the pre-spin overlap the replacement ADDS to
        # pool usage, so the projection must stay inside pool.limits — the
        # same admission the provisioner applies (designs/limits.md)
        pool = vnode.pool
        if not pool.limits.is_empty():
            it = next(iter(vnode.final_instance_types()), None)
            estimate = it.capacity if it is not None else vnode.used
            if (self.cluster.pool_usage(pool.name) + estimate).exceeds(
                pool.limits
            ):
                for pname in taken:
                    self._budgets[pname] += 1
                self.kube.record_event(
                    "NodePool", "LimitExceeded", pool.name,
                    "replacement deferred: pool at its limits",
                )
                return False
        claim = claim_from_vnode(vnode)
        try:
            self.cloud_provider.create(claim)
        except Exception as exc:
            log.warning("replacement launch failed: %s", exc)
            self.kube.record_event(
                "NodeClaim", "ReplacementLaunchFailed", claim.name, str(exc)
            )
            for pname in taken:
                self._budgets[pname] += 1
            return False
        self.kube.put_node_claim(claim)
        # cordon the candidates so nothing new lands on capacity that is
        # about to disappear (the reference taints karpenter.sh/disruption
        # before waiting on the replacement)
        for c in cands:
            self._cordon_candidate(c.claim)
        self.registry.inc(
            "karpenter_deprovisioning_actions",
            {"mechanism": "consolidation", "nodepool": cands[0].pool.name},
        )
        self._pending[claim.name] = _PendingReplacement(
            claim_name=claim.name,
            candidate_names=[c.claim.name for c in cands],
            pod_keys=[p.key() for p in vnode.pods],
            created_at=self.clock.now(),
            reason=reason,
        )
        return True

    def _cordon_candidate(self, claim: NodeClaim) -> None:
        node = (
            self.kube.node_by_provider_id(claim.provider_id)
            if claim.provider_id
            else None
        )
        if node is not None and not node.cordoned:
            node.cordoned = True
            if not any(
                t.key == L.TAINT_DISRUPTION_KEY for t in node.taints
            ):
                from karpenter_tpu_torch.controllers.termination import (
                    DISRUPTION_TAINT,
                )

                node.taints.append(DISRUPTION_TAINT)

    def _uncordon_candidates(self, pr: _PendingReplacement) -> None:
        for cand_name in pr.candidate_names:
            claim = self.kube.node_claims.get(cand_name)
            if claim is None or claim.deleted_at is not None:
                continue
            node = (
                self.kube.node_by_provider_id(claim.provider_id)
                if claim.provider_id
                else None
            )
            if node is not None and node.deleted_at is None:
                node.cordoned = False
                node.taints = [
                    t
                    for t in node.taints
                    if t.key != L.TAINT_DISRUPTION_KEY
                ]

    # ------------------------------------------------------------ candidates
    def _candidates(
        self, budgets: Optional[Dict[str, int]] = None
    ) -> List[Candidate]:
        """Disruptable nodes under `budgets` (default: the pass's own
        ``self._budgets``; the speculative dispatch passes a locally
        computed dict so a read-only stage never touches pass state)."""
        if budgets is None:
            budgets = self._budgets
        out = []
        for sn in self.cluster.snapshot():
            claim = sn.claim
            if claim is None or claim.deleted_at is not None:
                continue
            if not claim.initialized:
                continue  # only initialized nodes are disruptable
            pool = self.kube.node_pools.get(sn.pool_name)
            if pool is None or pool.deleted:
                continue
            if budgets.get(pool.name, 1) <= 0:
                continue
            reschedulable = [p for p in sn.pods if not p.is_daemonset]
            out.append(
                Candidate(
                    claim=claim,
                    state=sn,
                    pool=pool,
                    reschedulable=reschedulable,
                    price=claim.price,
                )
            )
        return out

    def _remaining_budgets(self) -> Dict[str, int]:
        return remaining_disruption_budgets(self.kube, self.cluster)

    # ------------------------------------------------------------ mechanisms
    def _expire(self, candidates: Sequence[Candidate]) -> bool:
        for c in candidates:
            ttl = c.pool.disruption.expire_after
            if ttl is None:
                continue
            if self.clock.now() - c.claim.created_at >= ttl:
                if self._disrupt(c, "expired"):
                    return True
        return False

    def _drift(self, candidates: Sequence[Candidate]) -> bool:
        for c in candidates:
            reason = self.cloud_provider.is_drifted(
                c.claim
            ) or self._pool_template_drift(c)
            if reason:
                c.claim.set_condition("Drifted")
                if self._disrupt(c, f"drifted/{reason}"):
                    return True
        return False

    @staticmethod
    def _pool_template_drift(c: Candidate) -> str:
        """Core-side drift: the claim no longer matches its pool's CURRENT
        template (karpenter-core's requirements/static drift — a pool whose
        requirements or taints changed rolls its nodes)."""
        from karpenter_tpu_torch.api.requirements import Requirements

        pool = c.pool
        if pool is None:
            return ""
        claim_reqs = Requirements.from_labels(c.claim.labels)
        if not claim_reqs.compatible(pool.template_requirements()):
            return "requirements"
        def taint_key(t):
            return (t.key, t.value, t.effect)
        if {taint_key(t) for t in c.claim.taints} != {
            taint_key(t) for t in pool.taints
        }:
            return "taints"
        return ""

    def _emptiness(self, candidates: Sequence[Candidate]) -> bool:
        """WhenEmpty pools: delete nodes quiet for consolidate_after
        (deprovisioning.md emptiness)."""
        now = self.clock.now()
        acted = False
        for c in candidates:
            if c.pool.disruption.consolidation_policy != "WhenEmpty":
                continue
            if c.reschedulable:
                self._last_non_empty[c.claim.name] = now
                continue
            quiet_since = self._last_non_empty.get(
                c.claim.name, c.claim.created_at
            )
            wait = c.pool.disruption.consolidate_after or 0.0
            if now - quiet_since >= wait:
                c.claim.set_condition("Empty")
                if self._disrupt(c, "emptiness"):
                    acted = True  # empty nodes delete in parallel, per budget
        return acted

    # --------------------------------------------------------- consolidation
    def _consolidate(self) -> bool:
        pool_candidates = self._ranked_consolidatables(self._budgets)
        if not pool_candidates:
            if self._speculation is not None:
                self._drop_speculation("stale")
            return False
        # one inventory fetch AND one evaluation context for the whole
        # pass: every simulation — multi-node descent, prefix floor,
        # single-node scan — shares the pools/types snapshot and the
        # memoized verdicts.  Under the pipelined schedule the
        # speculation's evaluator (and its boundary-dispatched verdicts)
        # is adopted in its place — ONLY behind the fingerprint guard.
        inv = self._pool_inventory()
        spec = self._take_speculation(pool_candidates, inv)
        if spec is not None:
            ev = spec.ev
        else:
            ev = _RemovalEvaluator(self, pool_candidates, inv)
        # multi-node first (bigger wins), then single-node scan — the
        # whole scan is ONE batched dispatch, answered lazily in rank
        # order so the first acceptable candidate still wins
        if self._consolidate_multi(pool_candidates, ev, spec=spec):
            return True
        ev.prefetch([[c] for c in pool_candidates])
        for c in pool_candidates:
            if self._consolidate_single(c, ev):
                return True
        return False

    def _consolidatable(self, c: Candidate) -> bool:
        """Blockers per designs/consolidation.md:46-53; the
        do-not-consolidate annotation exempts a node from consolidation
        only (expiration/drift/emptiness still apply)."""
        if c.claim.annotations.get(L.ANNOTATION_DO_NOT_CONSOLIDATE) == "true":
            return False
        if any(p.do_not_evict() for p in c.reschedulable):
            return False
        if any(not p.has_controller for p in c.reschedulable):
            return False
        wait = c.pool.disruption.consolidate_after
        if wait:
            age = self.clock.now() - c.claim.created_at
            if age < wait:
                return False
        return True

    def _consolidate_single(self, c: Candidate, ev: _RemovalEvaluator) -> bool:
        fits, replacement_price = ev.result([c])
        if not fits:
            return False
        # replacement must be strictly cheaper; spot nodes are delete-only
        # (deprovisioning.md:83-110)
        if replacement_price > 0.0 and (
            c.claim.capacity_type == L.CAPACITY_TYPE_SPOT
            or replacement_price >= c.price
        ):
            return False
        # the verdict accepted — but every ACTION derives from the
        # winner's AUTHORITATIVE full decode (vnode_for re-runs the
        # sequential simulation for batched verdicts and counts any
        # disagreement), so a batched parity break can neither delete a
        # node whose pods don't actually fit nor launch a replacement the
        # sequential predicate would have rejected
        fits2, price2, vnode = ev.vnode_for([c])
        if not fits2:
            return False
        if price2 == 0.0:
            return self._disrupt(c, "consolidation/delete")
        if (
            vnode is None
            or c.claim.capacity_type == L.CAPACITY_TYPE_SPOT
            or price2 >= c.price
        ):
            return False
        return self._launch_replacement([c], vnode, "consolidation/replace")

    def _consolidate_multi(
        self,
        ranked: Sequence[Candidate],
        ev: Optional[_RemovalEvaluator] = None,
        spec: Optional[_Speculation] = None,
    ) -> bool:
        """Multi-node consolidation: a population-annealing SEARCH over
        removal masks (docs/designs/consolidation-search.md).

        Each pass seeds a population of candidate subsets — structured
        masks covering everything the legacy descent could have visited
        (singletons, prefixes, drop-ones, the full set) plus seeded
        random diversity — and runs ``search_rounds`` rounds of
        propose → score → select: every round's masks are scored through
        the shared verdict kernel in ONE batched device dispatch
        (`_RemovalEvaluator.evaluate_masks`), survivors breed mutated
        children (grow / shrink / swap), and the best ACCEPTABLE subset
        across all rounds — max savings, spot delete-only, replacement
        strictly cheaper — wins.  A whole pass is therefore
        ``search_rounds`` dispatches (2 by default) over hundreds of
        subsets, instead of the old budget-capped host walk.

        The search only RANKS; it never acts on its own verdicts.  Every
        action still re-derives through the sequential oracle
        (`_act_multi` → ``vnode_for``), with disagreements counted in
        ``karpenter_consolidation_verdict_mismatch_total`` — and the
        proposal/selection schedule is a pure function of (pass seed,
        universe, verdicts), so forcing ``use_batched_consolidation``
        off changes which backend scores the masks, never which masks
        are proposed or which action is taken."""
        if ev is None:
            ev = _RemovalEvaluator(self, list(ranked), self._pool_inventory())
        if not self.use_population_search:
            return self._consolidate_multi_descent(ranked, ev)
        cands = list(ranked[:SEARCH_UNIVERSE_CAP])
        if len(cands) < 2:
            return False
        # the population-vs-descent choice must be HOST-decidable and
        # identical whichever verdict backend is active (the twin-run
        # contract): constraint shapes the mask encoding cannot replay
        # send the pass to the legacy descent up front, instead of
        # proposing a population the base would refuse and grinding
        # every mask through the sequential fallback
        if TorchScheduler.removal_search_guard(
            ev._universe[: len(cands)],
            self._remaining_snapshot(frozenset()),
        ):
            return self._consolidate_multi_descent(ranked, ev)
        plan = self._search_multi(cands, ev, spec=spec)
        reg = self.registry
        best = plan.best()
        if best is None:
            reg.inc(
                "karpenter_consolidation_search_winners_total",
                {"action": "none"},
            )
            return False
        subset = [cands[i] for i in best.indices]
        acted = self._act_multi(subset, best.price, ev)
        action = "none"
        if acted:
            action = "replace" if best.price > 0.0 else "delete"
        reg.inc(
            "karpenter_consolidation_search_winners_total",
            {"action": action},
        )
        return acted

    def _search_multi(
        self,
        cands: List[Candidate],
        ev: _RemovalEvaluator,
        spec: Optional[_Speculation] = None,
    ) -> SearchPlan:
        """The pure SEARCH half of a multi-node pass (no action taken):
        seed a plan, run propose → score → select rounds, record the
        search metrics, return the plan holding every verdict.  Split
        from `_consolidate_multi` so bench.py can measure the search
        without mutating the cluster.

        With an adopted speculation the already-proposed rounds are
        CONTINUED instead of re-proposed: the in-flight round joins here
        (its device work ran under the other controllers' host phases —
        the overlap the `karpenter_reconcile_overlap_seconds` histogram
        measures) and any rounds beyond it run synchronously as usual.
        The plan is the same object proposing the same masks from the
        same seed, so the search's verdicts and winner are identical to
        the sequential schedule's."""
        self._search_seq += 1
        reg = self.registry
        rounds_run = 0
        if spec is not None:
            plan = spec.plan
            rounds_run = spec.observed
            if spec.pending_keys:
                spec.overlap_s += perf_counter() - spec.t_enqueued
                results = ev.complete_masks(spec.pending)
                t0 = perf_counter()
                plan.observe(spec.pending_keys, results)
                reg.observe(
                    "karpenter_consolidation_search_phase_seconds",
                    perf_counter() - t0,
                    {"phase": "select"},
                )
                rounds_run += 1
            reg.observe(
                "karpenter_reconcile_overlap_seconds", spec.overlap_s
            )
        else:
            plan = SearchPlan(
                n=len(cands),
                prices=[c.price for c in cands],
                spot=[
                    c.claim.capacity_type == L.CAPACITY_TYPE_SPOT
                    for c in cands
                ],
                population=self.search_population,
                rounds=self.search_rounds,
                seed=self._search_seq,
                warm=self._warm_masks(cands),
            )
        while True:
            t0 = perf_counter()
            keys = plan.propose()
            reg.observe(
                "karpenter_consolidation_search_phase_seconds",
                perf_counter() - t0,
                {"phase": "propose"},
            )
            if not keys:
                break
            results = ev.evaluate_masks(cands, keys)
            t0 = perf_counter()
            plan.observe(keys, results)
            reg.observe(
                "karpenter_consolidation_search_phase_seconds",
                perf_counter() - t0,
                {"phase": "select"},
            )
            rounds_run += 1
        reg.observe("karpenter_consolidation_search_rounds", float(rounds_run))
        reg.observe(
            "karpenter_consolidation_population_size", float(len(plan.seen))
        )
        # cross-pass annealing warm start: the NEXT pass re-seeds from
        # this pass's surviving masks when its universe fingerprint is
        # unchanged — survivors are a pure function of (seed, universe,
        # verdicts), so twin runs and record/replay warm identically
        self._warm_store = (
            self._universe_fingerprint(cands), plan.survivors()
        )
        return plan

    def _consolidate_multi_descent(
        self,
        ranked: Sequence[Candidate],
        ev: _RemovalEvaluator,
    ) -> bool:
        """LEGACY bounded subset search (pre-population): drop-one
        refinement over the top cost-ranked candidates, kept reachable
        behind ``use_population_search = False`` and as the arithmetic
        the population path's structured seeds are a superset of.

        A pure prefix scan misses sets that are non-contiguous in cost
        order (one stubborn middle-ranked node — pinned pods, a full node
        — poisons every prefix containing it).  The search therefore
        descends by DROP-ONE refinement: evaluate the current set, then
        every child obtained by removing one member; take the feasible
        child with the largest savings, else trim the costliest member
        and repeat.  The descent is memoized and capped at
        MULTI_NODE_SIM_BUDGET simulations (the deprecated pre-population
        knob); the prefix-scan floor below may add up to
        MULTI_NODE_CANDIDATES-1 more on cache misses, so a pass is
        bounded by the sum of the two, not the budget alone.

        Each descent level — the current set plus all its drop-one
        children — evaluates as ONE batch (the budget counts batch
        ELEMENTS, and memoized subsets never re-enter a batch), but the
        results are consumed in the sequential order above, so the chosen
        action is identical to the per-subset loop's."""
        current = list(ranked[:MULTI_NODE_CANDIDATES])
        if len(current) < 2:
            return False

        def savings(subset: List[Candidate], rep_price: float) -> float:
            return sum(c.price for c in subset) - rep_price

        def acceptable(subset, fits, rep_price) -> bool:
            if not fits:
                return False
            if rep_price > 0 and any(
                c.claim.capacity_type == L.CAPACITY_TYPE_SPOT for c in subset
            ):
                return False  # spot nodes are delete-only
            return rep_price < sum(c.price for c in subset)

        while len(current) >= 2 and ev.sims < MULTI_NODE_SIM_BUDGET:
            # project the sequential path's budget walk — current first,
            # then children in drop-index order until the budget would
            # exhaust — so the batch holds exactly the subsets the
            # per-subset loop would have simulated
            consider: List[List[Candidate]] = []
            proj = ev.sims + (0 if ev.known(current) else 1)
            for i in range(len(current)):
                if proj >= MULTI_NODE_SIM_BUDGET:
                    break
                child = current[:i] + current[i + 1 :]
                if len(child) < 2:
                    continue  # size-1 is the single-node scan's job
                consider.append(child)
                if not ev.known(child):
                    proj += 1
            ev.prefetch([current] + consider)
            fits, rep_price = ev.result(current)
            if acceptable(current, fits, rep_price):
                return self._act_multi(current, rep_price, ev)
            best_child = None
            best_gain = 0.0
            best_price = 0.0
            for child in consider:
                c_fits, c_price = ev.result(child)
                if acceptable(child, c_fits, c_price):
                    gain = savings(child, c_price)
                    if best_child is None or gain > best_gain:
                        best_child = child
                        best_gain = gain
                        best_price = c_price
            if best_child is not None:
                return self._act_multi(best_child, best_price, ev)
            current = current[:-1]  # trim the costliest-to-disrupt member
        # guaranteed floor: the old prefix scan (<= MULTI_NODE_CANDIDATES-1
        # sims, memoized against the descent above) so small prefixes are
        # still found when the drop-one budget runs out at large sizes
        pool = list(ranked[:MULTI_NODE_CANDIDATES])
        prefixes = [pool[:size] for size in range(len(pool), 1, -1)]
        ev.prefetch(prefixes)
        for subset in prefixes:
            fits, rep_price = ev.result(subset)
            if acceptable(subset, fits, rep_price):
                return self._act_multi(subset, rep_price, ev)
        return False

    def _act_multi(
        self,
        subset: List[Candidate],
        rep_price: float,
        ev: _RemovalEvaluator,
    ) -> bool:
        # re-derive the whole action from the winner's AUTHORITATIVE full
        # decode (see _consolidate_single): a counted verdict mismatch
        # must neither delete nodes whose pods don't actually fit nor
        # launch what the sequential predicate — strictly cheaper, spot
        # delete-only — would have rejected
        fits, price2, vnode = ev.vnode_for(subset)
        if not fits:
            return False
        if price2 > 0:
            if vnode is None:
                return False
            if any(
                c.claim.capacity_type == L.CAPACITY_TYPE_SPOT
                for c in subset
            ):
                return False
            if price2 >= sum(c.price for c in subset):
                return False
            return self._launch_replacement(
                subset, vnode, "consolidation/multi"
            )
        acted = False
        for c in subset:
            if self._disrupt(c, "consolidation/multi"):
                acted = True
        return acted

    def _remaining_snapshot(self, removed_names: frozenset) -> List[StateNode]:
        """The cluster a removal simulation packs against: everything
        live, minus the removed candidates, minus capacity that is
        already spoken for — in-flight replacements and nomination
        targets that haven't absorbed their pods yet (counting them as
        free would let a second action double-book them).  The ONE
        definition of "remaining" shared by the sequential `_simulate`
        and the batched evaluator's base compile, so the two paths can
        never diverge on what the cluster looks like."""
        spoken_for = {pr.claim_name for pr in self._pending.values()}
        spoken_for |= {n.target for n in self._nominate_later.values()}
        return [
            sn
            for sn in self.cluster.snapshot()
            if sn.name not in removed_names
            and not sn.marked_for_deletion()
            and sn.name not in spoken_for
        ]

    def _pool_inventory(self):
        """(live pools, per-pool instance types) — fetched once per
        consolidation pass so repeated subset simulations share it."""
        pools = [p for p in self.kube.node_pools.values() if not p.deleted]
        inventory = {
            pool.name: self.cloud_provider.get_instance_types(pool)
            for pool in pools
        }
        return pools, inventory

    def _simulate(
        self, removed: Sequence[Candidate], pool_inventory=None
    ) -> Tuple[bool, float, Optional[object]]:
        """Scheduling simulation: do the removed nodes' pods fit on the
        remaining capacity plus at most ONE new (cheaper) node?

        Returns (fits, replacement_price, replacement_vnode) —
        replacement_price 0.0 means pure deletion suffices.  Reuses the
        tensor solver with the candidate nodes excluded from the snapshot
        (the same kernel the provisioner uses; SURVEY §7 step 7)."""
        remaining = self._remaining_snapshot(
            frozenset(c.state.name for c in removed)
        )
        pods = [p for c in removed for p in c.reschedulable]
        if not pods:
            return True, 0.0, None
        # a claim that bound since the pod last provisioned pins its zone;
        # the repack must not move the pod away from its volume.  Resolve
        # onto COPIES: these are shared LIVE pod objects, and writing the
        # refreshed requirement in place would bump their mutation epoch —
        # invalidating the PROVISIONER's compile cache from a pass that
        # changed nothing it can see (tests/test_consolidation_batch.py
        # asserts the cache stays warm across a consolidation pass)
        from karpenter_tpu_torch.controllers.provisioning import (
            volume_zone_requirements,
        )

        sim_pods = []
        for p in pods:
            new = volume_zone_requirements(p, self.kube)
            if new is None or new == p.volume_requirements:
                sim_pods.append(p)
                continue
            ent = self._volume_copies.get(p.key())
            if (
                ent is not None
                and ent[0] is p
                and ent[1] == p.mutation_epoch()
                and ent[2] == new
            ):
                sim_pods.append(ent[3])
                continue
            q = copy.copy(p)
            q.volume_requirements = new
            self._volume_copies[p.key()] = (p, p.mutation_epoch(), new, q)
            sim_pods.append(q)
        pods = sim_pods
        pools, inventory = pool_inventory or self._pool_inventory()
        scheduler = self._scheduler.update(
            pools,
            inventory,
            existing=remaining,
            daemonsets=self.kube.daemonset_pods(),
        )
        result = scheduler.solve(pods)
        if result.unschedulable:
            return False, 0.0, None
        if len(result.new_nodes) == 0:
            return True, 0.0, None
        if len(result.new_nodes) > 1:
            return False, 0.0, None
        vn = result.new_nodes[0]
        return True, vn.cheapest_price(), vn

    # ---------------------------------------------------------------- action
    def _disrupt(self, c: Candidate, reason: str) -> bool:
        """Disrupt within the pool's remaining budget for this pass."""
        if self._budgets.get(c.pool.name, 1) <= 0:
            return False
        self._budgets[c.pool.name] = self._budgets.get(c.pool.name, 1) - 1
        self.registry.inc(
            "karpenter_deprovisioning_actions",
            {"mechanism": reason.split("/")[0], "nodepool": c.pool.name},
        )
        self.registry.event(
            "NodeDisrupted", node=c.claim.name, pool=c.pool.name,
            reason=reason,
        )
        self.termination.mark_for_deletion(c.claim, reason=reason)
        return True


def remaining_disruption_budgets(kube: KubeStore, cluster: Cluster) -> Dict[str, int]:
    """Per-pool disruption allowance right now (pool.disruption.budgets:
    "10%" of nodes or an absolute count; nodes already marked for deletion
    consume the budget).

    Module-level because two consumers need the SAME arithmetic: the
    controller gates its voluntary disruptions on it each pass, and the
    simulator's invariant checker (sim/invariants.py) verifies from the
    outside that the controller never exceeded it."""
    counts: Dict[str, int] = {}
    disrupting: Dict[str, int] = {}
    for sn in cluster.snapshot():
        pool = sn.pool_name
        if not pool:
            continue
        counts[pool] = counts.get(pool, 0) + 1
        if sn.marked_for_deletion():
            disrupting[pool] = disrupting.get(pool, 0) + 1
    out: Dict[str, int] = {}
    for name, pool in kube.node_pools.items():
        total = counts.get(name, 0)
        allowed = total  # default: unbounded
        for b in pool.disruption.budgets:
            if b.endswith("%"):
                allowed = min(allowed, math.ceil(total * float(b[:-1]) / 100.0))
            else:
                allowed = min(allowed, int(b))
        out[name] = allowed - disrupting.get(name, 0)
    return out
