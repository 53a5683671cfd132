"""The port's pack against the JAX package's, on the same inputs.

`pack_reference` (the plain PyTorch twin of the CUDA kernels in
karpenter_tpu_torch/csrc/ffd_pack.cu) is held to the JAX lax.scan kernel
(`run_pack`) and the Pallas kernel (`run_pack_pallas`, run through the
Pallas interpreter as tests/test_pallas.py runs it) on the shapes of
tests/test_pallas.py, on the two bench problems cut to 500 pods, and on
random arrays made from numpy seeds.

Tolerance: none.  `take`, `leftover`, `node_cfg` and `node_pods` must be
equal, and `node_used` bit-equal to the scan kernel's (the Pallas kernel
rebuilds `node_used` as alloc - residual, so it is not compared there).
"""

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.api import Pod, Requirement, Requirements, Resources
from karpenter_tpu.api import labels as L
from karpenter_tpu.api.objects import PodAffinityTerm, TopologySpreadConstraint
from karpenter_tpu.api.requirements import Op
from karpenter_tpu.ops import pallas_packer
from karpenter_tpu.ops.packer import pack_kernel
from karpenter_tpu.ops.packer import run_pack as jax_run_pack
from karpenter_tpu.ops.tensorize import compile_problem
from karpenter_tpu.state.cluster import StateNode
from karpenter_tpu.testing import Environment
from karpenter_tpu_torch.interop import problem_arrays, problem_from_arrays
from karpenter_tpu_torch.ops.packer import pack_reference, run_pack

OBJECTIVES = ("nodes", "cost")


@pytest.fixture(scope="module")
def setup():
    env = Environment()
    pool = env.default_node_pool()
    nc = env.default_node_class()
    types = env.instance_types.list(pool, nc)
    return env, pool, types


def _homogeneous(setup):
    _, pool, types = setup
    pods = [Pod(requests=Resources(cpu=1, memory="1Gi")) for _ in range(300)]
    return compile_problem(pods, [pool], {pool.name: types})


def _heterogeneous_classes(setup):
    _, pool, types = setup
    sizes = [
        Resources(cpu=0.25, memory="512Mi"),
        Resources(cpu=1, memory="2Gi"),
        Resources(cpu=2, memory="4Gi"),
        Resources(cpu=4, memory="16Gi"),
    ]
    pods = [Pod(requests=sizes[i % 4]) for i in range(400)]
    return compile_problem(pods, [pool], {pool.name: types})


def _small_batch(setup):
    _, pool, types = setup
    pods = [Pod(requests=Resources(cpu=1, memory="1Gi")) for _ in range(200)]
    return compile_problem(pods, [pool], {pool.name: types})


def _anti_affinity_cap(setup):
    _, pool, types = setup
    sel = (("app", "d"),)
    pods = [
        Pod(
            labels={"app": "d"},
            requests=Resources(cpu=0.25),
            pod_affinity=[
                PodAffinityTerm(
                    topology_key=L.LABEL_HOSTNAME, label_selector=sel, anti=True
                )
            ],
        )
        for _ in range(50)
    ]
    return compile_problem(pods, [pool], {pool.name: types})


def _zone_spread_split(setup):
    _, pool, types = setup
    sel = (("app", "z"),)
    pods = [
        Pod(
            labels={"app": "z"},
            requests=Resources(cpu=1, memory="1Gi"),
            topology_spread=[
                TopologySpreadConstraint(
                    max_skew=1, topology_key=L.LABEL_ZONE, label_selector=sel
                )
            ],
        )
        for _ in range(60)
    ]
    return compile_problem(pods, [pool], {pool.name: types})


def _mixed_constraints(setup):
    _, pool, types = setup
    pods = []
    for i in range(150):
        p = Pod(requests=Resources(cpu=[0.5, 1, 2][i % 3], memory="1Gi"))
        if i % 4 == 0:
            p.node_selector = {L.LABEL_ARCH: "arm64"}
        if i % 5 == 0:
            p.required_affinity = [
                Requirement(L.LABEL_ZONE, Op.IN, ["zone-a", "zone-b"])
            ]
        pods.append(p)
    return compile_problem(pods, [pool], {pool.name: types})


def _existing_nodes_prefill(setup):
    _, pool, types = setup
    existing = [
        StateNode(
            name=f"node-{i}",
            provider_id=f"i-{i}",
            labels={
                L.LABEL_ARCH: "amd64",
                L.LABEL_OS: "linux",
                L.LABEL_ZONE: "zone-a",
            },
            taints=[],
            allocatable=Resources(cpu=8, memory="32Gi", pods=110),
        )
        for i in range(3)
    ]
    pods = [Pod(requests=Resources(cpu=1, memory="1Gi")) for _ in range(20)]
    return compile_problem(pods, [pool], {pool.name: types}, existing=existing)


def _pool_priority_splits_signature_rows(setup):
    env = Environment()
    nc = env.default_node_class()
    small = env.default_node_pool(
        name="small",
        weight=100,
        requirements=Requirements([Requirement(L.LABEL_INSTANCE_CPU, Op.LT, ["9"])]),
    )
    big = env.default_node_pool(
        name="big",
        weight=0,
        requirements=Requirements([Requirement(L.LABEL_INSTANCE_CPU, Op.GT, ["31"])]),
    )
    inventory = {
        "small": env.instance_types.list(small, nc),
        "big": env.instance_types.list(big, nc),
    }
    pods = [Pod(requests=Resources(cpu=1, memory="1Gi")) for _ in range(30)]
    pods += [Pod(requests=Resources(cpu=24, memory="48Gi")) for _ in range(10)]
    return compile_problem(pods, [small, big], inventory)


SHAPES = {
    "homogeneous": _homogeneous,
    "heterogeneous_classes": _heterogeneous_classes,
    "small_batch": _small_batch,
    "anti_affinity_cap": _anti_affinity_cap,
    "zone_spread_split": _zone_spread_split,
    "mixed_constraints": _mixed_constraints,
    "existing_nodes_prefill": _existing_nodes_prefill,
    "pool_priority_splits_signature_rows": _pool_priority_splits_signature_rows,
}


def _port_pack(jprob, objective):
    prob = problem_from_arrays(problem_arrays(jprob), {"axes": jprob.axes})
    return run_pack(prob, objective=objective, device="cpu")


def _assert_scan_parity(jprob, objective):
    scan = jax_run_pack(jprob, objective=objective)
    port = _port_pack(jprob, objective)
    np.testing.assert_array_equal(port.take, np.asarray(scan.take))
    np.testing.assert_array_equal(port.leftover, np.asarray(scan.leftover))
    np.testing.assert_array_equal(port.node_cfg, np.asarray(scan.node_cfg))
    np.testing.assert_array_equal(port.node_pods, np.asarray(scan.node_pods))
    np.testing.assert_array_equal(
        port.node_used.view(np.int32),
        np.asarray(scan.node_used, np.float32).view(np.int32),
    )
    return port


def _assert_pallas_parity(jprob, port, objective):
    fused = pallas_packer.run_pack_pallas(jprob, objective=objective)
    G = len(jprob.classes)
    ks = min(port.take.shape[1], fused.take.shape[1])
    np.testing.assert_array_equal(port.take[:G, :ks], fused.take[:G, :ks])
    np.testing.assert_array_equal(port.leftover[:G], fused.leftover[:G])
    used = port.node_pods[:ks] > 0
    np.testing.assert_array_equal(port.node_pods[:ks], fused.node_pods[:ks])
    np.testing.assert_array_equal(
        port.node_cfg[:ks][used], fused.node_cfg[:ks][used]
    )


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shape_parity(setup, shape, objective):
    jprob = SHAPES[shape](setup)
    port = _assert_scan_parity(jprob, objective)
    if pallas_packer.supports(jprob):
        _assert_pallas_parity(jprob, port, objective)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("problem", ["flagship", "heterogeneous"])
def test_bench_problem_parity(monkeypatch, problem, objective):
    monkeypatch.setattr(bench, "SCALE", 0.05)  # 500 pods
    if problem == "flagship":
        pool, types, pods = bench.build_problem()
        jprob = compile_problem(pods, [pool], {pool.name: types})
    else:
        pools, inventory, pods = bench.build_heterogeneous()
        jprob = compile_problem(pods, pools, inventory)
    assert pallas_packer.supports(jprob)
    port = _assert_scan_parity(jprob, objective)
    _assert_pallas_parity(jprob, port, objective)
    assert port.leftover.sum() == 0


def _random_arrays(seed: int):
    """Padded pack inputs drawn from a numpy seed: mixed request sizes,
    sparse feasibility, some unopenable configs, a few prefilled slots,
    capped classes sharing tracking rows.  Odd seeds run out of slots."""
    rng = np.random.default_rng(seed)
    G, C, K, R, S = 24, 64, (512, 64)[seed % 2], 4, 4
    req = rng.choice([0.0, 0.25, 0.5, 1.0, 1.5, 3.0], size=(G, R)).astype(np.float32)
    req[:, 0] = np.maximum(req[:, 0], 0.25)
    cnt = rng.integers(0, 40, G).astype(np.int32)
    maxper = np.where(rng.random(G) < 0.3, rng.integers(1, 4, G), 2**30).astype(np.int32)
    slot = rng.integers(0, S, G).astype(np.int32)
    feas = rng.random((G, C)) < 0.6
    alloc = (rng.integers(1, 17, (C, R)) * 0.5).astype(np.float32)
    price = (rng.random(C) * 3 + 0.05).astype(np.float32)
    openable = rng.random(C) < 0.85
    E = 5
    used0 = np.zeros((K, R), np.float32)
    cfg0 = np.full(K, -1, np.int32)
    cfg0[:E] = rng.integers(0, C, E)
    used0[:E] = alloc[cfg0[:E]] * rng.random((E, R)).astype(np.float32) * 0.5
    npods0 = np.zeros(K, np.int32)
    npods0[:E] = rng.integers(0, 5, E)
    sig0 = np.zeros((S, K), np.int32)
    sig0[:, :E] = rng.integers(0, 2, (S, E))
    return (req, cnt, maxper, slot, feas, alloc, price, openable,
            used0, cfg0, npods0, E, sig0)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("seed", range(4))
def test_random_arrays_parity(seed, objective):
    args = _random_arrays(seed)
    K = args[8].shape[0]
    ref = pack_kernel(*args, k_slots=K, objective=objective)
    port = pack_reference(
        *(a if isinstance(a, int) else torch.from_numpy(a) for a in args),
        objective=objective,
    )
    names = ("take", "leftover", "node_cfg", "node_pods")
    for name, got in zip(names, port[:4]):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    np.testing.assert_array_equal(
        port[4].numpy().view(np.int32),
        np.asarray(ref.node_used, np.float32).view(np.int32),
    )
