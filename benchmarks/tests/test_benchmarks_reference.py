"""The plain reference against the program's CPU path on seeded small
clusters: the solve's canonical result, the removal what-ifs of a pass,
the fast path's decisions.  The reference imports nothing of the program;
this test holds the two side by side."""

from __future__ import annotations

import numpy as np
import pytest

from benchmarks import drivers as D
from benchmarks import harness as H
from benchmarks import inputs as I
from benchmarks import program as P
from benchmarks.reference import solve as R

LIVE500 = H.load_json(H.BENCH / "configs" / "hetero300-live500.json")
LIVE5K = H.load_json(H.BENCH / "configs" / "hetero300-live5k.json")


def setup(cfg, seed, nodes, **cluster_kw):
    shapes = I.machine_shapes(**cfg["catalog"])
    cluster = dict(cfg["cluster"], nodes=nodes, **cluster_kw)
    raw = I.live_cluster(cluster, cfg["pending"], shapes, np.random.default_rng(seed))
    pools = P.pools(cfg)
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    sched = TorchScheduler(pools, P.inventory(cfg, shapes, pools),
                           existing=P.cluster(raw, shapes), device="cpu")
    return shapes, raw, sched, R.Catalog(shapes, cfg["pools"])


@pytest.mark.parametrize("cfg,seed,pods,nodes", [(LIVE500, 3, 1500, 80), (LIVE500, 2**33 + 1, 900, 0),
                                                 (LIVE5K, 4, 1200, 60)],
                         ids=["live500", "empty", "live5k"])
def test_solve_equals_the_program(cfg, seed, pods, nodes):
    shapes, raw, sched, cat = setup(cfg, seed, nodes)
    batch = I.config2_batch(dict(cfg["pending"], pods=pods), np.random.default_rng(seed + 1), "p")
    got = P.canonical(sched.solve([P.pod(p) for p in batch]))
    want = R.solve(cat, batch, raw)[0]
    assert D.mismatches(got, want) == 0
    assert got[0] and sum(len(n[4]) for n in got[0]) + len(got[1]) == pods
    control = R.solve(cat, R.without_memory(batch), R.nodes_without_memory(raw))[0]
    assert D.mismatches(control, want) > 0


def test_whatifs_equal_the_program():
    from karpenter_tpu_torch.scheduling.popsearch import SearchPlan
    from karpenter_tpu_torch.scheduling.solver import RemovalCandidate

    # every node packed to its allocatable, so that the what-ifs hold
    # replacements and refusals beside the deletions the cell's cluster gives
    shapes, raw, sched, cat = setup(LIVE5K, 9, 150, per_node=[110, 110])
    order = sorted(range(len(raw)), key=lambda i: (len(raw[i]["pods"]), i))[:32]
    cands = [RemovalCandidate(sched.existing[i].name, tuple(sched.existing[i].pods))
             for i in order]
    answers = list(zip([(k,) for k in range(len(cands))],
                       sched.evaluate_removals([[c] for c in cands], cands)))
    plan = SearchPlan(len(cands), [1.0] * len(cands), [False] * len(cands), 64, 2, 5)
    while keys := plan.propose():
        masks = np.zeros((len(keys), len(cands)), bool)
        for r, k in enumerate(keys):
            masks[r, list(k)] = True
        got = sched.evaluate_population(masks, cands)
        plan.observe(keys, [(v.fits, v.replacement_price) for v in got])
        answers += list(zip(keys, got))
    live = R.Live(cat, raw)
    kinds = set()
    for key, v in answers:
        fits, price, opened = R.whatif(cat, live, [order[i] for i in key])
        if v.needs_host:
            assert opened >= 2
        else:
            assert (v.fits, v.replacement_price) == (fits, price)
        kinds.add((v.needs_host, fits, price > 0))
    assert len(kinds) >= 3  # the pass holds deletions, replacements and refusals


def test_admissions_equal_the_program():
    from karpenter_tpu_torch.scheduling import fastpath

    shapes, raw, sched, cat = setup(LIVE500, 21, 50)
    sched.solve([P.pod(I.pending_pod(LIVE500["pending"], 0, "seed"))])
    sched._resident.note_sync(sched)
    rng = np.random.default_rng(8)
    live = R.Live(cat, raw)
    outcomes = set()
    for j in range(120):
        p = I.pending_pod(LIVE500["pending"], int(rng.integers(10000)), f"a{j}")
        res = fastpath.try_admit(sched, [P.pod(p)])
        got = (res.outcome, res.reason or next(iter(res.placements.values()), ""))
        assert got == R.admit(cat, p, live)
        outcomes.add(got[0])
    assert outcomes == {"nominated", "fallback"}
