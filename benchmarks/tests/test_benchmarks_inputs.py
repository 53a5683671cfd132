"""The seeded builders: the same seed gives the same inputs, another seed
other inputs; every pending batch holds the same pods in another order."""

from __future__ import annotations

from collections import Counter

import numpy as np

from benchmarks import drivers as D
from benchmarks import harness as H
from benchmarks import inputs as I

CFG = H.load_json(H.BENCH / "configs" / "hetero300-live500.json")
LIVE5K = H.load_json(H.BENCH / "configs" / "hetero300-live5k.json")
SHAPES = I.machine_shapes(**CFG["catalog"])


def cluster(cfg, seed, nodes=50):
    c = dict(cfg["cluster"], nodes=nodes)
    return I.live_cluster(c, cfg["pending"], SHAPES, D.rng(seed, D.CLUSTER_STREAM))


def test_catalog_is_config_2s():
    assert len(SHAPES) == 297  # about 300 types; x 3 zones x 2 capacity types
    assert len({s["name"] for s in SHAPES}) == len(SHAPES)


def test_same_seed_same_inputs_other_seed_other_inputs():
    big = 2**31 + 12345
    for cfg in (CFG, LIVE5K):
        assert cluster(cfg, big) == cluster(cfg, big)
        assert cluster(cfg, big) != cluster(cfg, big + 1)
    a = I.config2_batch(CFG["pending"], D.rng(big, D.TRAFFIC_STREAM), "b")
    b = I.config2_batch(CFG["pending"], D.rng(big, D.TRAFFIC_STREAM), "b")
    c = I.config2_batch(CFG["pending"], D.rng(big + 1, D.TRAFFIC_STREAM), "b")
    assert a == b and a != c


def key(p):
    return (p["cpu"], p["memory"], tuple(sorted(p["selector"].items())), p["tolerations"])


def test_every_batch_holds_config_2s_pods():
    mix = dict(CFG["pending"], pods=1000)
    a = I.config2_batch(mix, D.rng(1, D.TRAFFIC_STREAM), "a")
    b = I.config2_batch(mix, D.rng(2, D.TRAFFIC_STREAM), "b")
    assert Counter(map(key, a)) == Counter(map(key, b))
    assert sum(bool(p["tolerations"]) for p in a) == 300  # 30 % on the dedicated pool
    # 80 cpu sizes x 4 memory ratios, a few merged by the 0.25 GiB floor
    assert 300 < len({key(p) for p in a}) <= 320


def test_live_nodes_within_allocatable():
    from benchmarks.reference.solve import allocatable

    by_name = {s["name"]: s for s in SHAPES}
    for cfg in (CFG, LIVE5K):
        nodes = cluster(cfg, 5, nodes=200)
        lo, hi = cfg["cluster"]["per_node"]
        for nd in nodes:
            cpu, mem, slots = allocatable(by_name[nd["type"]])
            assert sum(p["cpu"] for p in nd["pods"]) <= cpu
            assert sum(p["memory"] for p in nd["pods"]) <= mem and len(nd["pods"]) <= slots
            assert len(nd["pods"]) <= hi and all(not p["tolerations"] for p in nd["pods"])
        assert sum(bool(nd["pods"]) for nd in nodes) > 150


def test_churn_keeps_the_load_steady():
    """Every pass starts from the base cluster: as many pods deleted as
    bound, the base itself untouched, the universe's load the same from
    the first pass to the hundredth."""
    big = 2**31 + 77
    mix = LIVE5K["pending"]
    base = I.live_cluster(dict(LIVE5K["cluster"], nodes=300), mix, SHAPES,
                          D.rng(big, D.CLUSTER_STREAM))
    snapshot = [dict(nd, pods=list(nd["pods"])) for nd in base]
    gen = D.rng(big, D.TRAFFIC_STREAM)
    total = sum(len(nd["pods"]) for nd in base)

    def universe_pods(nodes):
        order = sorted(range(len(nodes)), key=lambda i: (len(nodes[i]["pods"]), i))[:32]
        return sum(len(nodes[i]["pods"]) for i in order)

    seen = []
    for p in range(100):
        nodes = I.churned(mix, base, SHAPES, gen, 20, f"c{p}-")
        assert sum(len(nd["pods"]) for nd in nodes) == total
        assert nodes != base
        seen.append(universe_pods(nodes))
    assert base == snapshot
    assert abs(sum(seen[-20:]) - sum(seen[:20])) <= 0.1 * sum(seen[:20])


def test_seeds_past_32_bits():
    assert D.rng(2**40 + 3, 1).integers(1 << 30) == D.rng(2**40 + 3, 1).integers(1 << 30)
    assert isinstance(D.rng(-5, 1), np.random.Generator)
