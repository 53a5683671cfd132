"""bench.py's other solve problems in the port, held to the JAX package.

Each problem function of ``karpenter_tpu_torch/testing.py`` builds the
problem of its ``bench.py`` function: BASELINE config 3 (`affinity_topology_problem`),
config 5 (`multipool_spot_problem`), the four co-location lines
(`coloc_problem`), the relaxation line (`relax_problem`), the hybrid line
(`hybrid_problem`) and the 100k-pod resident tick (`resident_100k_problem`),
and config 4's repack (`consolidation_repack`).  At ``bench.SCALE = 0.05``
each problem goes through `TensorScheduler` and `TorchScheduler(device=
"cpu")` in both objectives: the decoded results must be equal in canonical
form, with no tolerance, and so must the path, the continuation, the count
of pods relaxed at compile time and the total price.
"""

import dataclasses

import pytest

import bench
import chip_smoke
import torch_specs
from karpenter_tpu.api import labels as jax_labels
from karpenter_tpu.api.objects import reset_name_sequences as jax_reset
from karpenter_tpu.scheduling import TensorScheduler
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api import reset_name_sequences
from karpenter_tpu_torch.scheduling.solver import TorchScheduler

SCALE = 0.05
# problem -> (bench's function, the port's function); each returns
# (pools, inventory, pods) or (pools, inventory, pods, existing)
PROBLEMS = {
    "config3": (bench.build_affinity_topology, T.affinity_topology_problem),
    "config5": (bench.build_multipool_spot, T.multipool_spot_problem),
    "coloc-tensor": (bench.build_coloc_tensor, lambda s: T.coloc_problem("tensor", s)),
    "coloc-crossclass": (bench.build_crossclass_coloc,
                         lambda s: T.coloc_problem("crossclass", s)),
    "coloc-inequiv": (bench.build_inequiv_coloc, lambda s: T.coloc_problem("inequiv", s)),
    "coloc-prefer": (bench.build_prefer_coloc, lambda s: T.coloc_problem("prefer", s)),
    "relax": (bench.build_relax, T.relax_problem),
    "hybrid": (bench.build_hybrid, T.hybrid_problem),
    "resident100k": (bench.build_resident_100k, T.resident_100k_problem),
}
DELTA_SHARE = 100  # the delta tick replaces every 100th pod: 1 %


def _build(monkeypatch, problem: str, scale: float = SCALE):
    """The problem from both functions, each package's name counters
    rewound first: ``(reference spec, port spec)``, each ``(pools,
    inventory, pods, existing)``."""
    monkeypatch.setattr(bench, "SCALE", scale)
    ref_build, port_build = PROBLEMS[problem]
    jax_reset()
    ref = tuple(ref_build())
    reset_name_sequences()
    port = tuple(port_build(scale))
    return ref + ((),) * (4 - len(ref)), port + ((),) * (4 - len(port))


def _delta(pods, make_name):
    """Bench's warm tick: every `DELTA_SHARE`-th pod leaves and as many new
    pod objects, of the shapes of their neighbours, join the end."""
    gone = range(0, len(pods), DELTA_SHARE)
    out = [p for i, p in enumerate(pods) if i % DELTA_SHARE]
    return out + [dataclasses.replace(pods[i + 1], name=make_name(i)) for i in gone]


def _same(ref_sched, ref, sched, got):
    assert torch_specs.canonical(got, L) == torch_specs.canonical(ref, jax_labels)
    assert sched.last_path == ref_sched.last_path
    assert sched.last_continuation == ref_sched.last_continuation
    assert sched.last_compile_relaxed == ref_sched.last_compile_relaxed
    assert got.total_price() == ref.total_price()
    assert sched.last_kernel == "reference"


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_problem_matches_reference(monkeypatch, problem, objective):
    (rp, ri, rpods, rex), (pp, pi, ppods, pex) = _build(monkeypatch, problem)
    ref_sched = TensorScheduler(rp, ri, existing=list(rex), objective=objective)
    sched = TorchScheduler(pp, pi, existing=list(pex), objective=objective, device="cpu")
    runs = [(rpods, ppods)]
    if problem == "resident100k":  # the warm tick: a hit, then a delta
        runs += [(rpods, ppods),
                 (_delta(rpods, "delta-{}".format), _delta(ppods, "delta-{}".format))]
    for rq, pq in runs:
        ref = ref_sched.solve(rq)
        got = sched.solve(pq)
        _same(ref_sched, ref, sched, got)
        assert not got.unschedulable
    if problem == "resident100k":
        assert sched.last_resident and sched.last_delta_rows > 0


def _pod_key(p) -> tuple:
    return (
        p.name, sorted(p.labels.items()), sorted(p.requests.items()),
        sorted(p.node_selector.items()), repr(p.tolerations), repr(p.topology_spread),
        repr(p.pod_affinity), repr(p.preferred_affinity), repr(p.affinity_terms),
    )


def _node_key(sn) -> tuple:
    return (sn.name, sn.provider_id, sorted(sn.labels.items()),
            sorted(sn.allocatable.items()), sorted(sn.used.items()),
            [_pod_key(p) for p in sn.pods])


@pytest.mark.parametrize("scale", [0.05, 0.2])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_problem_functions_match_bench(monkeypatch, problem, scale):
    """The port's function against bench's: the same pods in the same order
    (names, labels, requests and every constraint), the same pools, types
    and live nodes."""
    (rp, ri, rpods, rex), (pp, pi, ppods, pex) = _build(monkeypatch, problem, scale)
    assert len(ppods) == len(rpods)
    assert [_pod_key(p) for p in ppods] == [_pod_key(p) for p in rpods]
    assert [(p.name, p.weight, repr(p.limits), repr(p.requirements)) for p in pp] == [
        (p.name, p.weight, repr(p.limits), repr(p.requirements)) for p in rp]
    assert {k: [t.name for t in v] for k, v in pi.items()} == {
        k: [t.name for t in v] for k, v in ri.items()}
    assert [_node_key(n) for n in pex] == [_node_key(n) for n in rex]
    counts = lambda pods: [sum(len(getattr(p, f)) for p in pods) for f in (
        "tolerations", "topology_spread", "pod_affinity", "preferred_affinity",
        "affinity_terms")]
    assert counts(ppods) == counts(rpods)


def _reference_repack(scale: float):
    """``bench.run_consolidation_repack``'s cluster in the JAX package, the
    way `testing.consolidation_repack` builds the port's: the name
    counters rewound and launches one at a time."""
    from karpenter_tpu.api import Disruption, Pod, Resources
    from karpenter_tpu.cloud.fake.backend import generate_catalog
    from karpenter_tpu.testing import Environment

    jax_reset()
    env = Environment(shapes=generate_catalog(**T.FLAGSHIP_CATALOG))
    env.default_node_class()
    env.default_node_pool(disruption=Disruption(consolidation_policy="WhenUnderutilized"))
    env.operator.provisioner.launch_concurrency = 1
    sizes = [Resources(cpu=0.5, memory="1Gi"), Resources(cpu=1, memory="2Gi"),
             Resources(cpu=2, memory="4Gi"), Resources(cpu=4, memory="8Gi")]
    n_pods = max(1, int(5_000 * scale))
    for i in range(n_pods):
        env.kube.put_pod(Pod(requests=sizes[i % len(sizes)]))
    env.settle(max_rounds=60)
    assert not env.kube.pending_pods()
    dc = env.operator.disruption
    dc._budgets = dc._remaining_budgets()
    candidates = dc._candidates()
    assert sum(len(c.reschedulable) for c in candidates) == n_pods
    return dc, candidates


def test_consolidation_repack_matches_reference():
    """Config 4: ``_simulate`` over every candidate decides alike (fits,
    price, the replacement, the repack's placements) in both packages."""
    ref = chip_smoke.repack_decision(*_reference_repack(SCALE))
    got = chip_smoke.repack_decision(*T.consolidation_repack("cpu", SCALE))
    assert got["removed"] and got["repack"] is not None
    assert got == ref
