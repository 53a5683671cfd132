"""The port's disruption controller against the JAX package's on random
clusters: the twins of ``tests/test_fuzz_consolidation.py``.

Each seed builds the reference test's random cluster through the real
provision path in both packages (the JAX package's operator on the CPU,
the port's with ``device="cpu"``), deletes the same random share of its
pods and runs the controllers forward.  The two operator states
(`torch_twins.state`) must be equal after every tick, and the port's end
state must meet the reference test's invariants: quiesced with no pending
pod, no more nodes than the scale-up left (fewer when most pods left),
every bound pod on a live node that is not overcommitted, and through the
constrained scale-down co-location, anti-affinity and a zonal volume kept.
"""

import random

import pytest

from karpenter_tpu_torch.api import Resources
from karpenter_tpu_torch.api import labels as L
from torch_twins import Twin, assert_equal_states, state, twins

FUZZ_SIZES = ((0.25, "512Mi"), (1, "2Gi"), (2, "4Gi"), (4, "8Gi"))


def _live_nodes(env):
    return [n for n in env.kube.nodes.values() if not n.deleted_at]


def _convergence(t: Twin, seed: int):
    a = t.api
    t.objects.reset_name_sequences()
    env = t.env()
    env.default_node_class()
    env.default_node_pool(disruption=a.Disruption(consolidation_policy="WhenUnderutilized"))
    rng = random.Random(seed)
    pods = [a.Pod(requests=t.resources(*rng.choice(FUZZ_SIZES)))
            for _ in range(rng.randint(80, 220))]
    for p in pods:
        env.kube.put_pod(p)
    env.settle(max_rounds=40)
    assert not env.kube.pending_pods(), seed
    n0 = len(_live_nodes(env))
    keys = list(env.kube.pods.keys())
    drop = rng.sample(keys, int(len(keys) * rng.uniform(0.4, 0.7)))
    for key in drop:
        env.kube.delete_pod(key)
    states = []
    for _ in range(40):
        env.clock.step(65)
        env.step(2.0)
        states.append(state(env))
    env.settle(max_rounds=20)
    states.append(state(env))
    return env, n0, len(drop), len(keys), states


@pytest.mark.parametrize("seed", range(6))
def test_random_cluster_consolidation_convergence(seed):
    """Twin of ``test_fuzz_consolidation.test_random_cluster_consolidation_
    convergence``: the same random cluster scaled down converges through
    the same states in both packages, and the port's end state meets the
    reference's invariants (quiesced, shrunk, nothing overcommitted)."""
    (_r, _n, _d, _k, ref_states), (env, n0, dropped, total, states) = (
        _convergence(t, seed) for t in twins())
    assert_equal_states(ref_states, states)
    assert not env.kube.pending_pods(), seed
    live = _live_nodes(env)
    assert len(live) <= n0, (seed, len(live), n0)
    if dropped >= total * 0.5 and n0 > 3:
        assert len(live) < n0, (seed, len(live), n0)
    names = {n.name for n in live}
    used = {}
    for p in env.kube.pods.values():
        if p.node_name:
            assert p.node_name in names, (seed, p.node_name)
            used[p.node_name] = used.get(p.node_name, Resources()) + p.requests
    for n in live:
        if n.name in used:
            assert used[n.name].fits(n.allocatable), (seed, n.name)


def _constrained(t: Twin, seed: int):
    a, L = t.api, t.labels
    t.objects.reset_name_sequences()
    env = t.env()
    env.default_node_class()
    env.default_node_pool(disruption=a.Disruption(consolidation_policy="WhenUnderutilized"))
    env.kube.put_storage_class(a.StorageClass(name="zonal", zones=("zone-b",),
                                              binding_mode="Immediate"))
    env.kube.put_pvc(a.PersistentVolumeClaim(name="vol", storage_class="zonal"))
    rng = random.Random(3000 + seed)
    sizes = [t.resources(*s) for s in FUZZ_SIZES]
    pods = [a.Pod(requests=rng.choice(sizes)) for _ in range(rng.randint(60, 140))]
    term = t.objects.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                                     label_selector=(("pair", "g"),))
    coloc = [a.Pod(labels={"pair": "g"}, requests=sizes[1], pod_affinity=[term])
             for _ in range(3)]
    solo = [
        a.Pod(labels={"app": "solo"}, requests=sizes[0], pod_affinity=[
            t.objects.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                                      label_selector=(("app", "solo"),), anti=True)])
        for _ in range(rng.randint(2, 5))
    ]
    vol_pod = a.Pod(requests=sizes[1], volume_claims=["vol"])
    for p in pods + coloc + solo + [vol_pod]:
        env.kube.put_pod(p)
    env.settle(max_rounds=50)
    assert not env.kube.pending_pods(), seed
    n0 = len(_live_nodes(env))
    states = [state(env)]
    for p in rng.sample(pods, int(len(pods) * 0.6)):
        env.kube.delete_pod(p.key())
    for _ in range(40):
        env.clock.step(65)
        env.step(2.0)
        states.append(state(env))
    env.settle(max_rounds=20)
    states.append(state(env))
    return env, n0, coloc, solo, vol_pod, states


@pytest.mark.parametrize("seed", range(4))
def test_constrained_cluster_consolidation_invariants(seed):
    """Twin of ``test_fuzz_consolidation.test_constrained_cluster_
    consolidation_invariants``: co-location, anti-affinity and a zonal
    volume through a scale-down, the same states tick for tick in both
    packages, and the port's end state keeps every constraint."""
    ref, port = (_constrained(t, seed) for t in twins())
    assert_equal_states(ref[5], port[5])
    env, n0, coloc, solo, vol_pod, _states = port
    assert not env.kube.pending_pods(), seed
    assert len(_live_nodes(env)) <= n0, seed
    bound = {p.key(): p for p in env.kube.pods.values() if p.node_name}
    assert len({bound[p.key()].node_name for p in coloc if p.key() in bound}) <= 1
    solo_nodes = [bound[p.key()].node_name for p in solo if p.key() in bound]
    assert len(solo_nodes) == len(set(solo_nodes))
    if vol_pod.key() in bound:
        assert env.kube.nodes[bound[vol_pod.key()].node_name].labels[L.LABEL_ZONE] == "zone-b"
