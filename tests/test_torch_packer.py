"""The port's pack against the JAX package's, on the same inputs.

`pack_reference` (the plain PyTorch twin of the CUDA kernels in
karpenter_tpu_torch/csrc/ffd_pack.cu) is held to the JAX lax.scan kernel
(`run_pack`) and the Pallas kernel (`run_pack_pallas`, run through the
Pallas interpreter as tests/test_pallas.py runs it) on the shapes of
tests/test_pallas.py, on the two bench problems cut to 500 pods, on
random arrays made from numpy seeds, and on arrays where the scan's int32
sums wrap (also with the wrapping slots across the boundary of two CTAs of
the cluster scan), and on arrays where the new-node choice breaks ties by
first index.  Also the shape rule that picks the card's scan kernel, the
cluster scan's layout and its wrap guard.

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
from karpenter_tpu_torch.ops import fused_packer
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.ops.packer import choose_config_reference, pack_reference, run_pack
from karpenter_tpu_torch.testing import tie_arrays, wrap_arrays

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


def _assert_arrays_parity(args, objective):
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
    return port


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("seed", range(4))
def test_random_arrays_parity(seed, objective):
    _assert_arrays_parity(_random_arrays(seed), objective)


def _inexact_arrays(seed: int):
    """`_random_arrays` with config 2's request sizes (multiples of 0.05
    vCPU, which binary floats hold inexactly) and counts in the hundreds,
    so ``take * req`` rounds and the scan's ``used + take * req`` rounds
    once fused and differently in two steps."""
    args = list(_random_arrays(seed))
    rng = np.random.default_rng(100 + seed)
    G, R = args[0].shape
    args[0] = (0.05 * rng.integers(1, 81, (G, R))).astype(np.float32)
    args[1] = rng.integers(0, 400, G).astype(np.int32)
    args[5] = (args[5] * 8 + np.float32(0.45)).astype(np.float32)
    return tuple(args)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("seed", range(4))
def test_inexact_request_arrays_parity(seed, objective):
    """`node_used` bit-equal where the fused and the two-step update of
    the scan's usage differ (XLA on a CPU with FMA fuses it)."""
    _assert_arrays_parity(_inexact_arrays(seed), objective)


def test_fma32_matches_the_fused_update():
    """`fma32` rounds ``a * b + c`` once, as XLA's fused ``c + a * b``,
    over signs, magnitudes and integer counts up to 2^24."""
    import jax

    from karpenter_tpu_torch.ops.packer import fma32

    rng = np.random.default_rng(7)
    n = 200_000
    c = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 200.0, 1e6], n)).astype(np.float32)
    a = rng.integers(0, 2**24, n).astype(np.float32)
    b = (rng.standard_normal(n) * rng.choice([1e-4, 0.05, 3.0, 1e3], n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda c, a, b: c + a * b)(c, a, b))
    got = fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_wrap_arrays_parity(objective):
    """Classes that request no axis meet four prefilled feasible slots with
    2^30 room each: the int32 prefix wraps (see `wrap_arrays`)."""
    take, leftover, node_cfg, _, _ = _assert_arrays_parity(wrap_arrays(16), objective)
    # the wrap happened: slot 3 took 2^30 pods of class 0, whose leftover
    # went negative, and class 8's window started below slot 0, reopening
    # prefilled slots
    assert int(take[0, 3]) == 2**30
    assert int(leftover[0]) == -(2**30)
    assert int(node_cfg[0]) != 0


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_wrap_arrays_straddle_parity(objective):
    """The wrap case at 4096 slots with its four prefilled slots at
    2046-2049, across slot 2048, where the cluster scan's CTAs meet: the
    wrapping prefix and the window that reopens them cross the boundary."""
    at = 4096 // 2 - 2
    args = wrap_arrays(4096, at=at)
    assert args[11] == at + 4  # the first free slot
    take, leftover, node_cfg, _, _ = _assert_arrays_parity(args, objective)
    assert int(take[0, at + 3]) == 2**30
    assert int(leftover[0]) == -(2**30)
    # class 8's window opened from slot at - 4 >= 0, over prefilled slots
    assert int(node_cfg[at - 4]) >= 0 and int(node_cfg[at]) != 0


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_wrap_arrays_grid_straddle_parity(objective):
    """The wrap case at 32,768 slots with its prefilled slots at
    16,382-16,385, across slot 16,384, where the grid scan's two clusters
    meet (`grid_layout`: 2 clusters of 8 CTAs of 2,048 slots): the plain
    version held to the JAX package past 16,384 slots."""
    at = 16384 - 2
    args = wrap_arrays(32768, at=at)
    g = fused_packer.grid_layout(32768, 6, 8, fused_packer.GRID_CLUSTERS)
    assert (g.clusters, g.ctas * g.per_thread * fused_packer.scan_threads(
        32768 // (g.clusters * g.ctas))) == (2, at + 2)
    take, leftover, node_cfg, _, _ = _assert_arrays_parity(args, objective)
    assert int(take[0, at + 3]) == 2**30
    assert int(leftover[0]) == -(2**30)
    assert int(node_cfg[at - 4]) >= 0 and int(node_cfg[at]) != 0


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_tie_arrays_parity(objective):
    """Equal scores at configs the choice kernel holds in different threads,
    warps and quads: the pack equals JAX's, and the choice takes the first
    index (class 0 of four equal champions, class 1 of a cost tie between
    price 2 on 2 pods and price 1 on 1 pod); a class that fits nothing and
    one with maxper 0 get c_star 0 and new_ok 0."""
    args = tie_arrays()
    _assert_arrays_parity(args, objective)
    choice = [torch.from_numpy(args[i]) for i in (0, 2, 4, 5, 6, 7)]
    c_star, new_ok, per = (t.tolist() for t in choose_config_reference(*choice, objective))
    first_champion = testing._quad_config(0, 3, 1)
    assert c_star[0] == first_champion and per[0] == 500
    if objective == "cost":
        assert c_star[1] == testing._quad_config(0, 9, 1) and per[1] == 1
    assert (c_star[2], new_ok[2]) == (0, 0)
    assert (c_star[3], new_ok[3], per[3]) == (0, 0, 1)


def test_choice_wrapper_on_the_cpu():
    """On CPU tensors the choice wrapper runs the plain version; an unknown
    objective is refused."""
    args = tie_arrays(k_slots=8)
    choice = [torch.from_numpy(args[i]) for i in (0, 2, 4, 5, 6, 7)]
    want = choose_config_reference(*choice, "cost")
    for a, b in zip(fused_packer.choose_config(*choice, "cost"), want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="objective"):
        fused_packer.choose_config(*choice, "fewest")


@pytest.mark.parametrize(
    "K,kernel,smem",
    [(256, "ffd_scan", 60_800), (2048, "ffd_scan", 218_496),
     (4096, "ffd_scan_cluster", 398_720), (8192, "ffd_scan_cluster", 759_168),
     (16384, "ffd_scan_cluster", 1_480_064), (32768, "ffd_scan_grid", 2_921_856)],
)
def test_scan_kernel_by_shape(K, kernel, smem):
    """config 2's R 6, S 8, Cp 4096: the resident state fits one block up
    to 2048 slots (88 bytes a slot plus the ring), not at 4096; a cluster
    of up to 8 CTAs holds it up to 16,384 slots, a grid of clusters past
    that."""
    R, S, C = 6, 8, 4096
    per_thread, got = fused_packer.resident_layout(K, R, S, C)
    assert got == smem
    assert per_thread * fused_packer.scan_threads(K) >= K
    assert fused_packer.scan_kernel(K, R, S, C) == kernel


@pytest.mark.parametrize(
    "K,R,S,C,layout",
    [
        # config 2 on 2,000 live nodes: 8 CTAs, each a ring of 8 rows of
        # 8192 bytes, two tiles of 32 class rows of 19 words, 8 x 896
        # exchange bytes and 512 slots of 64 bytes
        (4096, 6, 2, 8192, (8, 1, 8 * 8192 + 2 * 32 * 4 * 19 + 8 * 896 + 512 * 64)),
        (8192, 6, 8, 4096, (8, 1, 8 * 4096 + 4864 + 8 * 896 + 1024 * 88)),
        (16384, 6, 8, 4096, (8, 2, 8 * 4096 + 4864 + 8 * 896 + 2048 * 88)),
        (16384, 6, 2, 8192, (8, 2, 8 * 8192 + 4864 + 8 * 896 + 2048 * 64)),
        (32768, 6, 2, 8192, None),  # 4 slots a thread at 8 CTAs
        (4096, 6, 64, 8192, None),  # 312 bytes a slot: past 227 KB at 8 CTAs
    ],
)
def test_cluster_layout(K, R, S, C, layout):
    got = fused_packer.cluster_layout(K, R, S, C)
    assert got == layout
    if got is not None:
        ctas, per_thread, smem = got
        assert smem <= fused_packer.SMEM_PER_BLOCK
        assert ctas * per_thread * fused_packer.scan_threads(-(-K // ctas)) >= K


def test_cluster_layout_of_each_size():
    """A forced size gives that size's layout, or None where it does not
    hold the slots (config2_live's shape at 2, 4 and 8 CTAs)."""
    assert fused_packer.cluster_layout(4096, 6, 2, 8192, ctas=2) == (2, 2, 203_264)
    assert fused_packer.cluster_layout(4096, 6, 2, 8192, ctas=4) == (4, 1, 139_520)
    assert fused_packer.cluster_layout(4096, 6, 2, 8192, ctas=8) == (8, 1, 110_336)
    assert fused_packer.cluster_layout(16384, 6, 2, 8192, ctas=4) is None


@pytest.mark.parametrize(
    "K,R,S,max_clusters,layout",
    [
        # config 2 on 10,000 live nodes (Kp 16,384, Sp 2): one cluster of 8
        # CTAs of 1,024 threads, 2 slots a thread, 16 groups of it; two
        # tiles of 32 class rows of 19 words, 8 x 640 exchange bytes, 2,048
        # slots of 64 bytes
        (16384, 6, 2, 16, (1, 16, 8, 2, 2 * 32 * 4 * 19 + 8 * 640 + 2048 * 64)),
        # on 20,000 (Kp 32,768): two such clusters
        (32768, 6, 2, 16, (2, 8, 8, 2, 141_056)),
        # the wrap case's S 8 at 65,536 slots: four clusters
        (65536, 6, 8, 16, (4, 4, 8, 2, 4864 + 8 * 640 + 2048 * 88)),
        (245760, 6, 2, 15, (15, 1, 8, 2, 141_056)),  # every cluster of an H100
        (245761, 6, 2, 15, None),  # past the co-resident clusters
        (32768, 6, 2, 1, None),  # one cluster holds 16,384 slots at most
        (4096, 6, 2, 16, (1, 16, 8, 1, 4864 + 8 * 640 + 512 * 64)),
        # 856 bytes a slot: more clusters, 256 slots a CTA
        (16384, 6, 200, 16, (8, 2, 8, 1, 4864 + 8 * 640 + 256 * 856)),
    ],
)
def test_grid_layout(K, R, S, max_clusters, layout):
    """The fewest clusters of 8 CTAs whose CTAs hold the slots at up to 2
    a thread within 227 KB; no feasibility ring, so Cp does not enter."""
    got = fused_packer.grid_layout(K, R, S, max_clusters)
    assert got == layout
    if got is not None:
        q, ctas = got.clusters, got.ctas
        assert got.smem <= fused_packer.SMEM_PER_BLOCK and q <= max_clusters
        assert q * ctas * got.per_thread * fused_packer.scan_threads(-(-K // (q * ctas))) >= K


@pytest.mark.parametrize("live", [10_000, 20_000])
def test_scan_kernel_picks_the_grid_past_one_cluster(live):
    """Config 2's pods on 10,000 and 20,000 live nodes (Cp and Kp 16,384
    and 32,768): the cluster scan's ring of 8 feasibility rows and its 8
    CTAs no longer hold them, so the solve's scan is the grid, and so is a
    batched or fleet scan there (the grid's batch and fleet modes); a card
    whose co-resident clusters cannot hold the slots keeps the global
    scan."""
    from karpenter_tpu_torch.ops.packer import pad_problem
    from karpenter_tpu_torch.ops.tensorize import compile_problem as port_compile

    pools, inv, pods = testing.heterogeneous_problem()
    prob = port_compile(pods, pools, inv, existing=testing.live_cluster(live))
    args, kp = pad_problem(prob)
    K, R, S, C = args[8].shape[0], args[0].shape[1], args[12].shape[0], args[5].shape[0]
    assert (K, C) == {10_000: (16384, 16384), 20_000: (32768, 32768)}[live]
    assert (R, S) == (6, 2)
    assert fused_packer.cluster_layout(K, R, S, C) is None
    assert fused_packer.scan_kernel(K, R, S, C) == "ffd_scan_grid"
    assert fused_packer.scan_kernel(K, R, S, C, 16) == "ffd_scan_grid"
    assert fused_packer.grid_layout(K, R, S, 16).clusters == K // 16384
    assert fused_packer.scan_kernel(K, R, S, C, 15) == "ffd_scan_grid"
    assert fused_packer.batch_launches(0, K, R, S, C)[-1] == "ffd_scan_grid_batched"
    assert fused_packer.batch_launches(live, K, R, S, C) == ("ffd_scan_grid_batched",)
    if K > 16384:
        assert fused_packer.scan_kernel(K, R, S, C, 1) == "ffd_scan_global"


def test_scan_kernel_keeps_the_global_scan_past_the_grid():
    """The global scan stays for more than 31 resource axes (one flag bit
    each), for slots past the card's co-resident clusters, and for
    feasibility rows no cp.async size divides: for the solve's scan and,
    the same, for a batched or fleet scan."""
    pick = fused_packer.scan_kernel
    assert pick(16384, 6, 2, 16384, 16) == "ffd_scan_grid"
    assert pick(32768, 6, 2, 32768, 16) == "ffd_scan_grid"
    assert pick(16384, 6, 2, 16384, 15) == "ffd_scan_grid"
    assert pick(32768, 6, 2, 32768, 15) == "ffd_scan_grid"
    assert pick(16384, 32, 2, 16384, 16) == "ffd_scan_global"
    assert pick(32768, 32, 2, 32768, 16) == "ffd_scan_global"
    assert pick(32768, 6, 2, 32768, 1) == "ffd_scan_global"
    assert pick(300_000, 6, 2, 32768, 16) == "ffd_scan_global"
    assert pick(32768, 6, 2, 32766, 16) == "ffd_scan_global"


@pytest.mark.parametrize(
    "K,S,max_clusters,layout",
    [
        # config 2 on 10,000 live nodes: one cluster an element, 15 groups
        # of it on an H100's 15 co-resident clusters
        (16384, 2, 15, (1, 15, 8, 2, 141_056)),
        # on 20,000: two clusters an element, 7 groups
        (32768, 2, 15, (2, 7, 8, 2, 141_056)),
        (65536, 8, 15, (4, 3, 8, 2, 4864 + 8 * 640 + 2048 * 88)),
        (245760, 2, 15, (15, 1, 8, 2, 141_056)),  # every cluster: one group
        (245761, 2, 15, None),  # past every grid
        (32768, 2, 1, None),
    ],
)
def test_grid_layout_groups(K, S, max_clusters, layout):
    """The batched and fleet grid: `grid_layout`'s clusters an element, the
    groups of them the card holds at once, its slots a thread and bytes."""
    got = fused_packer.grid_layout(K, 6, S, max_clusters)
    assert got == layout
    if got is not None:
        assert got.clusters * got.groups <= max_clusters


def test_grid_wrapper_on_the_cpu():
    """On CPU tensors the grid scan's entry point runs the plain version."""
    args = [a if isinstance(a, int) else torch.from_numpy(a) for a in wrap_arrays(64)]
    choice = choose_config_reference(*(args[i] for i in (0, 2, 4, 5, 6, 7)))
    scan_args = (*args[:6], *choice, *args[8:])
    got = fused_packer.ffd_scan_grid(*scan_args)
    want = fused_packer.ffd_scan(*scan_args)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("K,guard", [(2048, 2**20), (4096, 2**19), (16384, 2**17)])
def test_wrap_guard(K, guard):
    """With every cap below the guard the exact sum of K caps stays below
    2^31, and the guard is the largest power of two for which it does."""
    T = fused_packer.wrap_guard(K)
    assert T == guard
    assert K * (T - 1) < 2**31 <= K * (2 * T - 1)


def test_scan_kernel_by_feasibility_row():
    # rows copy in the widest cp.async the row length allows
    assert fused_packer.feas_copy_bytes(4096) == 16
    assert fused_packer.feas_copy_bytes(8) == 8
    assert fused_packer.feas_copy_bytes(12) == 4
    assert fused_packer.feas_copy_bytes(6) == 0
    assert fused_packer.scan_kernel(256, 6, 8, 12) == "ffd_scan"
    assert fused_packer.scan_kernel(256, 6, 8, 6) == "ffd_scan_global"
    # at most two slots a thread: past 2048 slots the resident kernel does
    # not run, however small the state; the cluster kernel does
    assert fused_packer.resident_layout(2049, 1, 1, 16)[0] == 4
    assert fused_packer.scan_kernel(2049, 1, 1, 16) == "ffd_scan_cluster"
    assert fused_packer.cluster_layout(2049, 1, 1, 16)[:2] == (8, 1)
    # one flag bit per resource axis: at most 31
    assert fused_packer.scan_kernel(256, 31, 2, 64) == "ffd_scan"
    assert fused_packer.scan_kernel(256, 32, 2, 64) == "ffd_scan_global"
    assert fused_packer.scan_kernel(4096, 32, 2, 64) == "ffd_scan_global"
    assert fused_packer.scan_kernel(4096, 6, 2, 8190) == "ffd_scan_global"
