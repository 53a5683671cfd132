"""The port's disruption controller, decision for decision against the JAX
package's.

Each test is the twin of a consolidation test of the JAX package
(``tests/test_consolidation_batch.py``, ``test_consolidation_search.py``,
``test_multi_consolidation.py``; ``test_fuzz_consolidation.py``'s twins are
``test_torch_fuzz_consolidation.py``): the same
seeded scenario at the reference test's own size runs through the JAX
package's operator (on the CPU) and the port's (``device="cpu"``, the
plain versions of the kernels), and the two must agree exactly: the
verdicts and the sequential simulations (prices by their bits), the
search's proposals and pick, and tick for tick the whole operator state
(`torch_twins.state`: claims created, marked and replaced, bindings, cloud
calls, the ledger's ``NodeDisrupted`` and ``VerdictFallback`` events, the
disruption counters).  The port's side then also meets the reference
test's own assertions.  The tests marked ``sim`` in those files wait for
the port of the simulator (ROADMAP A3b).
"""

import functools
import random

import numpy as np
import pytest

from torch_twins import (
    PACKAGES,
    Twin,
    assert_equal_states,
    counter_by_path,
    fx,
    ranked_candidates,
    state,
    tick_digest,
    twins,
)


def _verdict(v) -> tuple:
    return (v.fits, fx(v.replacement_price), v.needs_host, v.reason)


def _sim(out) -> tuple:
    fits, price, _vn = out
    return (fits, fx(price))


# ------------------------------------------------- test_consolidation_batch
def _parity_subsets(cands):
    """The reference's subsets: the single-node scan, the prefix floor, and
    drop-one children of the top set."""
    subsets = [[c] for c in cands]
    subsets += [cands[:k] for k in range(2, min(len(cands), 8) + 1)]
    top = cands[:6]
    if len(top) > 2:
        subsets += [top[:i] + top[i + 1:] for i in range(len(top))]
    return subsets


def _removal_parity(t: Twin, seed: int, npods: int):
    env = t.build_env(seed, npods, cpus=(4, 8) if seed == 0 else (8, 16, 32))
    dc = env.operator.disruption
    cands = ranked_candidates(dc)
    inv = dc._pool_inventory()
    ev = t.disruption._RemovalEvaluator(dc, cands, inv)
    ev._sync_scheduler()
    subsets = _parity_subsets(cands)
    elements = [
        [t.solver.RemovalCandidate(c.state.name, tuple(c.reschedulable)) for c in s]
        for s in subsets
    ]
    verdicts = dc._scheduler.evaluate_removals(elements, ev._universe)
    rows = []
    for s, v in zip(subsets, verdicts):
        rows.append((tuple(c.claim.name for c in s), _verdict(v), _sim(dc._simulate(list(s), inv))))
    return rows


@pytest.mark.parametrize("seed,npods", [(0, 120), (2, 90)])
def test_parity_seeded_cluster(seed, npods):
    """Twin of ``test_consolidation_batch.test_parity_seeded_cluster``: the
    batched removal verdicts and the sequential simulations of the same
    subsets are equal in both packages, and in the port each answered
    verdict equals its simulation."""
    ref, port = (_removal_parity(t, seed, npods) for t in twins())
    assert ref == port
    assert len(port) >= 3
    answered = 0
    for names, (fits, price, needs_host, _reason), (sfits, sprice) in port:
        if needs_host:
            continue
        answered += 1
        assert (fits, price) == (sfits, sprice), names
    assert answered >= len(port) * 0.6, (answered, len(port))


def _scale_down_drive(t: Twin, seed: int, npods: int, rounds: int, population: int,
                      share, ticks: int, batched: bool = True, pipelined=None):
    """The reference's twin-action drive: a cluster of ``npods`` seeded
    pods, a seeded ``share`` of them deleted, then ``ticks`` ticks of 65 s
    + 2 s; the per-tick digests and operator states."""
    kw = {} if pipelined is None else {"enable_pipelined_reconcile": pipelined}
    env = t.build_env(seed, npods, **kw)
    dc = env.operator.disruption
    dc.use_batched_consolidation = batched
    dc.search_rounds = rounds
    dc.search_population = population
    rng = random.Random(99)
    keys = sorted(env.kube.pods.keys())
    for key in rng.sample(keys, share(keys)):
        env.kube.delete_pod(key)
    digests, states = [], []
    for _ in range(ticks):
        env.clock.step(65)
        env.step(2.0)
        digests.append(tick_digest(env, dc))
        states.append(state(env))
    return env, digests, states


@functools.lru_cache(maxsize=None)
def _reference_drive(name: str):
    """The JAX package's side of a twin drive, once per module."""
    args = DRIVES[name]
    _env, digests, states = _scale_down_drive(Twin(PACKAGES[0]), *args, batched=True)
    return digests, states


DRIVES = {
    # test_consolidation_batch.test_forced_fallback_identical_decisions
    "batch": (5, 110, 2, 12, lambda keys: len(keys) // 2, 25),
    # test_consolidation_search.test_forced_fallback_twin_actions
    "search": (5, 110, 2, 16, lambda keys: (keys and len(keys) * 3 // 5) or 0, 12),
}


def _twin_drive(name: str, batched: bool):
    digests, states = _reference_drive(name)
    env, p_digests, p_states = _scale_down_drive(Twin(PACKAGES[1]), *DRIVES[name],
                                                 batched=batched)
    assert p_digests == digests
    assert_equal_states(
        [{k: v for k, v in s.items() if k not in _BACKEND_KEYS} for s in states],
        [{k: v for k, v in s.items() if k not in _BACKEND_KEYS} for s in p_states],
    )
    if batched:
        assert_equal_states(states, p_states)
    return env


# what the verdict backend changes by design: which path answered the
# evaluations, and the ledger's record of the sequential fallbacks
_BACKEND_KEYS = ("counters", "events", "event_counts", "disruption")


@pytest.mark.parametrize("batched", [True, False])
def test_forced_fallback_identical_decisions(batched):
    """Twin of ``test_consolidation_batch.test_forced_fallback_identical_
    decisions``: the port's operator, batched or forced sequential, takes
    the JAX package's batched actions tick for tick (and, batched, matches
    its whole state: the evaluations by path and the ledger)."""
    env = _twin_drive("batch", batched)
    by_path = counter_by_path(env)
    if batched:
        assert by_path.get("batched", 0) > 0, by_path
    assert env.registry.counter("karpenter_consolidation_verdict_mismatch_total") == 0


def _cache_warm(t: Twin):
    """``test_consolidation_pass_leaves_provisioner_cache_warm`` on one
    package: returns what it observed."""
    a = t.api
    t.objects.reset_name_sequences()
    env = t.env(t.catalog(generations=(1, 2), cpus=(4, 8)))
    env.default_node_class()
    env.default_node_pool(disruption=a.Disruption(consolidation_policy="WhenUnderutilized"))
    env.kube.pvcs["default/pvc-1"] = a.PersistentVolumeClaim(name="pvc-1")
    pods = [a.Pod(requests=t.resources(1, "2Gi")) for _ in range(30)]
    pods[0].volume_claims = ["pvc-1"]
    for p in pods:
        env.kube.put_pod(p)
    env.settle(max_rounds=40)
    assert not env.kube.pending_pods()
    bound = env.kube.pods[pods[0].key()]
    zone = env.kube.nodes[bound.node_name].labels.get("topology.kubernetes.io/zone", "zone-a")
    env.kube.pvcs["default/pvc-1"].bound_zone = zone
    dc = env.operator.disruption
    epochs = {p.key(): p.mutation_epoch() for p in env.kube.pods.values()}
    stored = list(bound.volume_requirements)
    cands = ranked_candidates(dc)
    inv = dc._pool_inventory()
    sims = [_sim(dc._simulate([c], inv)) for c in cands] + [_sim(dc._simulate(cands, inv))]
    untouched = (
        {p.key(): p.mutation_epoch() for p in env.kube.pods.values()} == epochs
        and list(bound.volume_requirements) == stored
    )
    prov = env.operator.provisioner
    blocker = a.Pod(requests=a.Resources(cpu=10_000))
    env.kube.put_pod(blocker)
    prov.provision([blocker])
    hits0 = prov.scheduler.compile_cache_hits
    misses0 = prov.scheduler.compile_cache_misses
    dc.reconcile()
    prov.provision([blocker])
    warm = (prov.scheduler.compile_cache_hits - hits0, prov.scheduler.compile_cache_misses - misses0)
    carried = any(any(q.key() == bound.key() for q in c.reschedulable) for c in cands)
    return [c.claim.name for c in cands], sims, untouched, warm, carried


def test_consolidation_pass_leaves_provisioner_cache_warm():
    """Twin of the reference test of that name: the simulations of a
    volume-pinned pod's node are equal in both packages, run on copies
    (no shared pod's epoch or requirements move), and a full disruption
    reconcile leaves the port Provisioner's compile cache warm."""
    ref, port = (_cache_warm(t) for t in twins())
    assert ref == port
    _names, _sims, untouched, warm, carried = port
    assert carried and untouched
    assert warm == (1, 0)


def _base_cache(t: Twin):
    env = t.build_env(1, 80)
    dc = env.operator.disruption
    cands = ranked_candidates(dc)
    ev = t.disruption._RemovalEvaluator(dc, cands, dc._pool_inventory())
    ev._sync_scheduler()
    sched = dc._scheduler
    base1 = sched._removal_base(ev._universe)
    base2 = sched._removal_base(ev._universe)
    cands[0].reschedulable[0].labels = {"mutated": "yes"}
    base3 = sched._removal_base(ev._universe)
    return len(cands), base1.reason, base1 is base2, base3 is base1, base1.kp, base1.gp


def test_removal_base_cache_warm_across_calls():
    """Twin of the reference test of that name: the base compiles once per
    (universe, cluster state), and an in-place pod mutation recompiles, at
    the same padded shapes in both packages."""
    ref, port = (_base_cache(t) for t in twins())
    assert ref == port
    n, reason, same, stale, _kp, _gp = port
    assert n >= 2 and not reason and same and not stale


def _metrics(t: Twin):
    env = t.build_env(4, 100)
    states = []
    for _ in range(3):
        env.clock.step(65)
        env.step(2.0)
        states.append(state(env))
    reg = env.registry
    sizes = list(reg.histogram("karpenter_consolidation_eval_batch_size"))
    return env, states, sizes


def test_consolidation_metrics_recorded():
    """Twin of the reference test of that name: the evaluations by path,
    the batch sizes and the compile-cache counters are equal in both
    packages, and the port's batched path answered."""
    (_r, ref_states, ref_sizes), (env, states, sizes) = (_metrics(t) for t in twins())
    assert_equal_states(ref_states, states)
    assert sizes == ref_sizes and sizes and max(sizes) >= 2
    by_path = counter_by_path(env)
    assert by_path.get("batched", 0) > 0, by_path
    reg = env.registry
    assert reg.counter("karpenter_consolidation_verdict_mismatch_total") == 0
    assert sum(reg.counters.get("karpenter_solver_compile_cache_misses_total", {}).values()) > 0


# ------------------------------------------------ test_consolidation_search
def _fuzz_keys(rng: random.Random, n: int):
    keys = [(i,) for i in range(n)]
    keys += [tuple(range(k)) for k in range(2, n + 1)]
    full = tuple(range(n))
    keys += [full[:i] + full[i + 1:] for i in range(n)]
    keys += [tuple(sorted(rng.sample(range(n), rng.randint(2, n)))) for _ in range(40)]
    return list(dict.fromkeys(k for k in keys if k))


def _population_parity(t: Twin, seed: int, npods: int):
    env = t.build_env(seed, npods, cpus=(4, 8) if seed == 0 else (8, 16))
    dc = env.operator.disruption
    cands = ranked_candidates(dc)
    keys = _fuzz_keys(random.Random(seed + 100), min(len(cands), 10))
    inv = dc._pool_inventory()
    ev = t.disruption._RemovalEvaluator(dc, cands, inv)
    ev._sync_scheduler()
    masks = np.zeros((len(keys), len(ev._universe)), bool)
    for r, key in enumerate(keys):
        masks[r, list(key)] = True
    verdicts = dc._scheduler.evaluate_population(masks, ev._universe)
    rows = []
    for key, v in zip(keys, verdicts):
        sim = None if v.needs_host else _sim(dc._simulate([cands[i] for i in key], inv))
        rows.append((key, _verdict(v), sim))
    return len(cands), rows


@pytest.mark.parametrize("seed,npods", [(0, 120), (3, 90)])
def test_population_parity_seeded_cluster(seed, npods):
    """Twin of ``test_consolidation_search.test_population_parity_seeded_
    cluster``: the population verdicts of the same masks and their
    sequential simulations are equal in both packages, and in the port each
    answered verdict equals its simulation."""
    ref, port = (_population_parity(t, seed, npods) for t in twins())
    assert ref == port
    n, rows = port
    assert n >= 3
    answered = 0
    for key, (fits, price, needs_host, _reason), sim in rows:
        if needs_host:
            continue
        answered += 1
        assert (fits, price) == sim, key
    assert answered >= len(rows) * 0.6, (answered, len(rows))


@pytest.mark.parametrize("batched", [True, False])
def test_forced_fallback_twin_actions(batched):
    """Twin of ``test_consolidation_search.test_forced_fallback_twin_
    actions``: after a mass scale-down the port's operator, batched or
    forced sequential, takes the JAX package's actions tick for tick,
    multi-node population winners included."""
    env = _twin_drive("search", batched)
    winners = env.registry.counters.get("karpenter_consolidation_search_winners_total", {})
    assert sum(winners.values()) > 0, winners
    if batched:
        assert counter_by_path(env).get("batched", 0) > 0
    assert env.registry.counter("karpenter_consolidation_verdict_mismatch_total") == 0


def _plan_drive(t: Twin, seed: int):
    plan = t.popsearch.SearchPlan(
        n=9, prices=[0.1 * (i + 1) for i in range(9)], spot=[False] * 9,
        population=24, rounds=3, seed=seed,
    )
    proposed = []
    while True:
        keys = plan.propose()
        if not keys:
            break
        proposed.append(keys)
        plan.observe(keys, [((sum(k) % 3) != 0, 0.0 if len(k) % 2 else 0.04 * len(k))
                            for k in keys])
    best = plan.best()
    return proposed, None if best is None else (best.indices, fx(best.price))


def test_search_plan_is_seed_deterministic():
    """Twin of the reference test of that name: the two packages' plans
    propose the same masks and pick the same winner for a seed, and the
    seed steers the proposals."""
    for seed in (42, 43):
        ref, port = (_plan_drive(t, seed) for t in twins())
        assert ref == port
    p1, b1 = _plan_drive(Twin(PACKAGES[1]), 42)
    assert (p1, b1) == _plan_drive(Twin(PACKAGES[1]), 42)
    assert _plan_drive(Twin(PACKAGES[1]), 43)[0] != p1
    first = set(p1[0])
    assert all((i,) in first for i in range(9))
    assert tuple(range(9)) in first and tuple(range(4)) in first


def test_search_plan_acceptability_rules():
    """Twin of the reference test of that name, both packages."""
    for t in twins():
        plan = t.popsearch.SearchPlan(
            n=3, prices=[0.4, 0.5, 0.6], spot=[False, True, False],
            population=8, rounds=1, seed=1,
        )
        got = [
            plan.acceptable((0, 2), True, 0.0),
            plan.acceptable((0, 2), True, 0.9),
            plan.acceptable((0, 2), True, 1.0),
            plan.acceptable((0, 1), True, 0.3),
            plan.acceptable((0, 1), True, 0.0),
            plan.acceptable((0,), True, 0.0),
            plan.acceptable((0, 2), False, 0.0),
        ]
        assert got == [True, True, False, False, True, False, False], t.pkg


def _descent_route(t: Twin):
    env = t.build_env(2, 60)
    dc = env.operator.disruption
    cands = ranked_candidates(dc)
    cands[0].reschedulable[0].volume_claims = ["pvc-x"]
    ev = t.disruption._RemovalEvaluator(dc, cands, dc._pool_inventory())
    before = len(env.registry.histogram("karpenter_consolidation_search_rounds"))
    acted = dc._consolidate_multi(cands, ev)
    after = len(env.registry.histogram("karpenter_consolidation_search_rounds"))
    return len(cands), acted, after - before, sorted(dc._pending), state(env)


def test_constraint_shapes_route_to_descent():
    """Twin of the reference test of that name: a volume claim in the
    universe sends the pass to the legacy descent in both packages, which
    then act alike."""
    ref, port = (_descent_route(t) for t in twins())
    assert ref[:4] == port[:4]
    assert_equal_states([ref[4]], [port[4]])
    assert port[0] >= 2 and port[2] == 0


def test_search_settings_wire_through():
    """Twin of the reference test of that name, on the port's operator."""
    t = Twin(PACKAGES[1])
    s = t.api.Settings(cluster_name="t", consolidation_search_rounds=3,
                       consolidation_population_size=64)
    s.validate()
    dc = t.env(settings=s).operator.disruption
    assert (dc.search_rounds, dc.search_population) == (3, 64)
    assert dc._scheduler.device.type == "cpu"
    with pytest.raises(ValueError):
        t.api.Settings(cluster_name="t", consolidation_search_rounds=0).validate()
    with pytest.raises(ValueError):
        t.api.Settings(cluster_name="t", consolidation_population_size=1).validate()


# ------------------------------------------------ test_multi_consolidation
def _make_node(t: Twin, env, name, zone, cpu, price, pods):
    a, L = t.api, t.labels
    claim = a.NodeClaim(
        name=name, pool_name="default", node_class_ref="default",
        provider_id=f"i-{name}", zone=zone, capacity_type=L.CAPACITY_TYPE_ON_DEMAND,
        price=price,
        capacity=a.Resources(cpu=cpu, memory=f"{cpu * 4}Gi", pods=110),
        allocatable=a.Resources(cpu=cpu, memory=f"{cpu * 4}Gi", pods=110),
        labels={L.LABEL_NODEPOOL: "default", L.LABEL_ZONE: zone,
                L.LABEL_CAPACITY_TYPE: L.CAPACITY_TYPE_ON_DEMAND},
        created_at=env.clock.now(),
    )
    for cond in ("Launched", "Registered", "Initialized"):
        claim.set_condition(cond)
    env.kube.put_node_claim(claim)
    env.kube.put_node(t.kube.Node(
        name=name, provider_id=claim.provider_id, labels=dict(claim.labels), taints=[],
        capacity=claim.capacity, allocatable=claim.allocatable, ready=True,
        created_at=env.clock.now(),
    ))
    for p in pods:
        env.kube.put_pod(p)
        env.kube.bind_pod(p.key(), name)
    return claim


def _zone_pod(t: Twin, cpu, mem, zone):
    return t.api.Pod(requests=t.resources(cpu, mem), node_selector={t.labels.LABEL_ZONE: zone})


def _multi_env(t: Twin, zone_a_only: bool):
    a, L = t.api, t.labels
    t.objects.reset_name_sequences()
    env = t.env()
    env.default_node_class()
    kw = {}
    if zone_a_only:
        kw["requirements"] = a.Requirements(
            [a.Requirement(L.LABEL_ZONE, t.requirements.Op.IN, ["zone-a"])])
    env.default_node_pool(disruption=a.Disruption(consolidation_policy="WhenUnderutilized"), **kw)
    return env


def _multi_case(t: Twin, case: str):
    env = _multi_env(t, case != "prefix")
    if case == "non_contiguous":
        _make_node(t, env, "c0", "zone-a", 8, 0.40, [_zone_pod(t, 1, "1Gi", "zone-a")])
        _make_node(t, env, "c1", "zone-b", 32, 0.90,
                   [_zone_pod(t, 14, "24Gi", "zone-b") for _ in range(2)])
        _make_node(t, env, "c2", "zone-a", 8, 0.45, [_zone_pod(t, 1, "1Gi", "zone-a") for _ in range(3)])
    elif case == "budget":
        for i, name in enumerate(["c0", "c1"]):
            _make_node(t, env, name, "zone-a", 8, 0.40 + i * 0.01, [_zone_pod(t, 1, "1Gi", "zone-a")])
        for i in range(8):
            _make_node(t, env, f"p{i}", "zone-b", 32, 0.90,
                       [_zone_pod(t, 14, "24Gi", "zone-b") for _ in range(2)])
    else:
        for i in range(3):
            _make_node(t, env, f"n{i}", "zone-a", 8, 0.40,
                       [t.api.Pod(requests=t.resources(1, "1Gi")) for _ in range(i + 1)])
    dc = env.operator.disruption
    ranked = ranked_candidates(dc)
    sims = []
    if case == "non_contiguous":
        sims = [_sim(dc._simulate(s)) for s in
                ([ranked[0], ranked[1], ranked[2]], [ranked[0], ranked[1]], [ranked[0], ranked[2]])]
    acted = dc._consolidate_multi(ranked)
    pending = [sorted(p.candidate_names) for p in dc._pending.values()]
    return [c.claim.name for c in ranked], sims, acted, pending, state(env)


@pytest.mark.parametrize("case,expect", [
    ("non_contiguous", ["c0", "c2"]),
    ("budget", ["c0", "c1"]),
    ("prefix", ["n0", "n1", "n2"]),
])
def test_multi_consolidation(case, expect):
    """Twins of ``test_multi_consolidation.py`` (``non_contiguous``:
    ``test_non_contiguous_subset_beats_every_prefix``; ``budget``:
    ``test_small_prefix_found_after_descent_budget_exhausts``; ``prefix``:
    ``test_prefix_still_wins_when_it_is_best``): the ranking, the
    simulations, the chosen subset and the replacement launched are equal
    in both packages, and the port pre-spins one replacement for
    ``expect``."""
    ref, port = (_multi_case(t, case) for t in twins())
    assert ref[:4] == port[:4]
    assert_equal_states([ref[4]], [port[4]])
    names, sims, acted, pending, _st = port
    assert acted and pending == [expect]
    if case == "non_contiguous":
        assert names == ["c0", "c1", "c2"]
        assert not sims[0][0] and not sims[1][0]
        fits, price = sims[2][0], float.fromhex(sims[2][1])
        assert fits and 0 < price < 0.40 + 0.45
    if case == "budget":
        assert len(names) == 10 and set(names[:2]) == {"c0", "c1"}
