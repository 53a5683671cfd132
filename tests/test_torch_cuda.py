"""The CUDA kernels against their plain PyTorch version, on the card.

Each scan case asserts which scan kernel the wrapper's shape rule launched:
the resident one up to the slot count whose state fits a block, the
cluster one above it (2, 4 or 8 CTAs), on the wrap case (int32 sums that
wrap) too, also with its prefilled slots straddling a CTA boundary; and
the global one through its own entry point.  The choice is held to the
plain version on its own cases: ties broken by first index, few classes,
6 configs and a ``feas`` one byte off (both read a config at a time).  The
verdict kernels are held to theirs at the sweep's shape, on the tie arrays
(at the live problem's shape too, and at next0 0 and K, and at R 200,
where the config pass reads its rows from device memory), past one
launch's 65,535 elements and, for the prologue, with U and Gp past its
block.  The batched scans launch as `fused_packer.batch_launches` says:
the frontier-window scan (``ffd_scan_window_batched``), then the picked
scan for the elements that leave its window; on each of
``testing.frontier_arrays``' cases the window scan's ``done`` mask is the
elements whose frontier stays within W.  The admission score (``admit_kernel``) is held to its plain version
on every class of the wrap case, of config 2 over 4096 slots, of each of
``testing.admit_edge_arrays``' cases and of a resident state, and a fast-path operator drive on the card to the CPU's;
an operator drive that consolidates on the card, to the CPU's.  The fleet
pack (``fused_packer.fleet_pack``) is held to its plain version and to one
solo ``ffd_pack`` a tenant on ``testing.fleet_tenant_arrays``' cases and on
config 2 as four tenants (the resident and the cluster scan, and the
global scan through ``scan=``), and a multi-tenant solver server on the
card to a dedicated sidecar.  The sharded pack on a mesh of the machine's
cards (8 shards, (4, 2)) runs ``ffd_shard_scan`` where its data rows share
one card and the cap / apply pair where forced, each held to its plain
version and to ``ffd_pack`` at the main path's problems and on the wrap
and frontier cases.

Marked ``cuda``: each test asks for the ``cuda_device`` fixture, which skips
where ``torch.cuda.is_available()`` is false, so every worker collects the
same tests everywhere.  On the card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``.  Tolerance: none — every output must be equal
(``node_used`` compared as float32 bit patterns)."""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.ops import fused_packer
from karpenter_tpu_torch.ops.packer import (
    choose_config_reference,
    ffd_scan_reference,
    pack_reference,
    pad_problem,
    to_device,
)
from karpenter_tpu_torch.ops.tensorize import compile_problem
from karpenter_tpu_torch.scheduling.solver import TorchScheduler

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_bit_equal(got, want):
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b)


# case -> the scan kernel the shapes pick.  config 2 at scale 0.1 has R 6,
# S 2 and Cp 4096: its resident state fits one block at 2048 slots, not at
# 4096, where the cluster scan takes it (8 CTAs), up to 16,384 slots, and
# past that the grid scan (clusters of 8 CTAs of 2,048 slots: at 32,768
# slots two, at 65,536 four).  "wrap-K-at-N": the wrap case's prefilled
# slots at N .. N + 3 (N + 2 a boundary between two CTAs or two clusters).
CASES = {
    "flagship": "ffd_scan",
    "heterogeneous": "ffd_scan",
    "heterogeneous-2048": "ffd_scan",
    "heterogeneous-4096": "ffd_scan_cluster",
    "heterogeneous-8192": "ffd_scan_cluster",
    "heterogeneous-16384": "ffd_scan_cluster",
    "wrap": "ffd_scan",
    "wrap-4096": "ffd_scan_cluster",
    "wrap-4096-straddle": "ffd_scan_cluster",
    "wrap-16384-straddle": "ffd_scan_cluster",
    "heterogeneous-32768": "ffd_scan_grid",
    "wrap-32768-at-2046": "ffd_scan_grid",
    "wrap-32768-straddle": "ffd_scan_grid",
    "wrap-65536-at-2046": "ffd_scan_grid",
    "wrap-65536-at-16382": "ffd_scan_grid",
    "wrap-short": "ffd_scan",
    "wrap-negzero": "ffd_scan",
}


def _case(case: str):
    """The pack arguments of a case, on the host."""
    if case == "flagship":
        pool, types, pods = T.flagship_problem(scale=0.1)
        return pad_problem(compile_problem(pods, [pool], {pool.name: types}))[0]
    if case.startswith("heterogeneous"):
        pools, inv, pods = T.heterogeneous_problem(scale=0.1)
        k = int(case.partition("-")[2] or 0)
        return pad_problem(compile_problem(pods, pools, inv), k)[0]
    if case == "wrap-short":  # fewer classes than the ring holds
        return T.wrap_arrays(8, classes=3)
    if case == "wrap-negzero":  # -0.0 in used0: no slot may skip used += 0 * req
        args = T.wrap_arrays(256)
        args[8][0, 3] = -0.0
        return args
    # wrap[-K[-straddle | -at-N]]: the prefilled slots straddle slot K / 2,
    # or start at slot N
    _, k, straddle, at = (case.split("-") + ["", "", ""])[:4]
    k = int(k or 256)
    return T.wrap_arrays(k, at=int(at) if at else (k // 2 - 2 if straddle else 0))


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("problem", list(CASES))
def test_kernel_matches_reference(cuda_device, problem, objective):
    host_args, kernel = _case(problem), CASES[problem]
    args = to_device(host_args, cuda_device)
    before = dict(fused_packer.LAUNCHES)
    got = fused_packer.ffd_pack(*args, objective=objective)
    torch.cuda.synchronize()
    moved = {k for k, n in fused_packer.LAUNCHES.items() if n != before[k]}
    assert moved == {"choose_config", kernel}
    assert all(fused_packer.LAUNCHES[k] == before[k] + 1 for k in moved)
    _assert_bit_equal(got, pack_reference(*args, objective=objective))


CHOICE_CASES = ("heterogeneous", "flagship", "wrap", "ties", "ties-16384", "configs-6",
                "feas-offset")


def _choice(case: str, dev):
    """The choice's card inputs ``(req, maxper, feas, alloc, price,
    openable)`` of a choice case; "feas-offset" is the heterogeneous case
    with ``feas`` a view one byte into its buffer."""
    if case == "ties":
        host = T.tie_arrays()
    elif case == "ties-16384":
        host = T.tie_arrays(16384)
    elif case == "configs-6":
        host = T.first_configs(T.wrap_arrays(256), 6)
    else:
        host = _case("heterogeneous" if case == "feas-offset" else case)
    req, _, maxper, _, feas, alloc, price, openable = to_device(host, dev)[:8]
    if case == "feas-offset":
        buf = torch.zeros(feas.numel() + 1, dtype=torch.bool, device=dev)
        buf[1:] = feas.reshape(-1)
        feas = buf[1:].view(feas.shape)
    return req, maxper, feas, alloc, price, openable


def _launch_moves(fn):
    before = dict(fused_packer.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in fused_packer.LAUNCHES.items() if n != before[k]}


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("case", CHOICE_CASES)
def test_choose_config_matches_reference(cuda_device, case, objective):
    choice = _choice(case, cuda_device)
    got, moved = _launch_moves(lambda: fused_packer.choose_config(*choice, objective))
    assert moved == {"choose_config": 1}
    assert all(t.is_contiguous() for t in got)
    _assert_bit_equal(got, choose_config_reference(*choice, objective))


def test_global_kernel_matches_reference(cuda_device):
    """The global kernel at a shape the resident one takes."""
    args = to_device(_case("heterogeneous"), cuda_device)
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, cnt, maxper, slot, feas, alloc, *chosen,
                 used0, cfg0, npods0, next0, sig0)
    before = fused_packer.LAUNCHES["ffd_scan_global"]
    got = fused_packer.ffd_scan_global(*scan_args)
    torch.cuda.synchronize()
    assert fused_packer.LAUNCHES["ffd_scan_global"] == before + 1
    _assert_bit_equal(got, ffd_scan_reference(*scan_args))


@pytest.mark.parametrize("ctas", fused_packer.CLUSTER_SIZES)
@pytest.mark.parametrize("problem", ["heterogeneous-4096", "wrap-4096-straddle"])
def test_cluster_sizes_match_reference(cuda_device, problem, ctas):
    """The cluster kernel on a cluster of each size at 4096 slots, whichever
    size the shape rule picks."""
    args = to_device(_case(problem), cuda_device)
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, cnt, maxper, slot, feas, alloc, *chosen,
                 used0, cfg0, npods0, next0, sig0)
    before = fused_packer.LAUNCHES["ffd_scan_cluster"]
    got = fused_packer.ffd_scan_cluster(*scan_args, ctas=ctas)
    torch.cuda.synchronize()
    assert fused_packer.LAUNCHES["ffd_scan_cluster"] == before + 1
    _assert_bit_equal(got, ffd_scan_reference(*scan_args))


def test_cluster_size_that_cannot_hold_raises(cuda_device):
    """16,384 slots on 2 CTAs would need 8 slots a thread: refused, never
    sent to another kernel or size."""
    args = to_device(_case("heterogeneous-16384"), cuda_device)
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    before = dict(fused_packer.LAUNCHES)
    with pytest.raises(ValueError, match="2 CTAs"):
        fused_packer.ffd_scan_cluster(req, cnt, maxper, slot, feas, alloc, *chosen,
                                      used0, cfg0, npods0, next0, sig0, ctas=2)
    for k in ("ffd_scan", "ffd_scan_cluster", "ffd_scan_global"):
        assert fused_packer.LAUNCHES[k] == before[k]


def test_misaligned_feasibility_raises(cuda_device):
    """The kernel follows the shapes alone: a ``feas`` view that does not
    start on a 16-byte boundary is refused, not sent to another kernel."""
    args = list(to_device(_case("heterogeneous"), cuda_device))
    feas = args[4]
    shifted = torch.zeros(feas.numel() + 1, dtype=torch.bool, device=cuda_device)
    shifted[1:] = feas.reshape(-1)
    args[4] = shifted[1:].view(feas.shape)
    before = dict(fused_packer.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fused_packer.ffd_pack(*args)
    assert fused_packer.LAUNCHES["ffd_scan"] == before["ffd_scan"]
    assert fused_packer.LAUNCHES["ffd_scan_global"] == before["ffd_scan_global"]
    assert fused_packer.LAUNCHES["ffd_scan_cluster"] == before["ffd_scan_cluster"]


@pytest.mark.parametrize("live", [10_000, 20_000])
def test_grid_scan_on_live_clusters(cuda_device, live):
    """Config 2's pods on 10,000 and 20,000 live nodes at full size (Kp and
    Cp 16,384 and 32,768: one cluster and two): ``ffd_pack`` launches the
    grid scan, bit-equal to the plain version, both objectives."""
    pools, inv, pods = T.heterogeneous_problem()
    args = to_device(pad_problem(compile_problem(pods, pools, inv,
                                                 existing=T.live_cluster(live)))[0], cuda_device)
    for objective in ("nodes", "cost"):
        got, moved = _launch_moves(lambda: fused_packer.ffd_pack(*args, objective=objective))
        assert moved == {"choose_config": 1, "ffd_scan_grid": 1}
        _assert_bit_equal(got, pack_reference(*args, objective=objective))


def test_grid_that_cannot_hold_raises(cuda_device):
    """65,536 slots need four clusters an element: a layout made for
    `MAX_GRID_CLUSTERS` co-resident clusters (8 groups) launches 8 groups
    for a batch of 16, more clusters than the card holds, and the grid's
    entry point refuses them and launches nothing."""
    a = to_device(T.frontier_arrays("wrap", k_slots=65536, batch=16), cuda_device)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     *_, cnt_b, rm_b, perm_b) = a
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, cnt_b[0], maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0,
                 sig0)
    layout = fused_packer.grid_layout(65536, 6, 8, fused_packer.MAX_GRID_CLUSTERS)
    assert layout.clusters * min(layout.groups, 16) > fused_packer.grid_clusters(
        torch.cuda.current_device())
    before = dict(fused_packer.LAUNCHES)
    with pytest.raises(RuntimeError, match="no thread-block cluster"):
        fused_packer._launch_grid(scan_args, (10, 8, 65536, 6, 8), layout,
                                  (16, perm_b, cnt_b, rm_b))
    assert fused_packer.LAUNCHES == before


@pytest.mark.parametrize("live_nodes,kernel", [(0, "ffd_scan"), (2000, "ffd_scan_cluster"),
                                               (10_000, "ffd_scan_grid")])
def test_solve_on_card_matches_cpu(cuda_device, live_nodes, kernel):
    pools, inv, pods = T.heterogeneous_problem(scale=0.1)
    existing = T.live_cluster(live_nodes)
    card = TorchScheduler(pools, inv, existing=existing, device=cuda_device)
    before = fused_packer.LAUNCHES[kernel]
    got = card.solve(pods)
    cpu = TorchScheduler(pools, inv, existing=existing, device="cpu").solve(pods)
    assert card.last_kernel == "cuda_ffd"
    assert fused_packer.LAUNCHES[kernel] > before
    key = lambda r: sorted(tuple(sorted(p.name for p in n.pods)) for n in r.new_nodes)
    assert key(got) == key(cpu)
    assert sorted(got.existing_placements.items()) == sorted(cpu.existing_placements.items())
    assert got.total_price() == cpu.total_price()


def test_wrapper_rejects_bad_inputs(cuda_device):
    pools, inv, pods = T.heterogeneous_problem(scale=0.01)
    args = list(to_device(pad_problem(compile_problem(pods, pools, inv))[0], cuda_device))
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="dtype"):
        fused_packer.ffd_pack(*args)


@pytest.mark.parametrize("live_nodes,kernel", [(0, "ffd_scan"), (2000, "ffd_scan_cluster")])
def test_warm_ticks_on_card_match_cpu(cuda_device, live_nodes, kernel):
    """A cold solve, a compile-cache hit and a delta tick on the card, each
    packed from the resident tensors, equal the same ticks on the CPU; after
    the delta the card tensors equal their host mirrors."""
    import dataclasses

    pools, inv, pods = T.heterogeneous_problem(scale=0.1)
    existing = T.live_cluster(live_nodes)
    churned = pods[50:] + [dataclasses.replace(p, name="") for p in pods[-50:]]
    card = TorchScheduler(pools, inv, existing=existing, device=cuda_device)
    cpu = TorchScheduler(pools, inv, existing=existing, device="cpu")
    key = lambda r: (sorted(tuple(sorted(p.name for p in n.pods)) for n in r.new_nodes),
                     sorted(r.existing_placements.items()), r.total_price())
    for batch in (pods, pods, churned):
        before = fused_packer.LAUNCHES[kernel]
        got, want = card.solve(batch), cpu.solve(batch)
        assert card.last_resident and cpu.last_resident
        assert fused_packer.LAUNCHES[kernel] == before + 1
        assert key(got) == key(want)
    assert card.compile_cache_hits == 1 and card.last_delta_rows > 0
    st = card._resident.states[-1]
    assert st.d_feas.device.type == "cuda" and st.d_feas.data_ptr() % 16 == 0
    for name in ("req", "cnt", "feas", "alloc", "price", "openable", "used0", "npods0"):
        d, h = getattr(st, f"d_{name}").cpu().numpy(), getattr(st, f"h_{name}")
        if h.dtype == np.float32:
            d, h = d.view(np.int32), h.view(np.int32)
        np.testing.assert_array_equal(d, h)


# bench.py's problems at the shapes past phase 5's: config 5 at Cp 16,384
# (the resident scan's 169,344-byte layout) and the 100k-pod tick at Kp 2,048
# (2 slots a thread, 1,000 live rows); name -> (problem function, Kp, Cp)
BENCH_SHAPES = {
    "config5": (T.multipool_spot_problem, 512, 16384),
    "resident100k": (T.resident_100k_problem, 2048, 4096),
}


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("problem", list(BENCH_SHAPES))
def test_bench_problem_on_card_matches_plain_and_cpu(cuda_device, monkeypatch, problem,
                                                     objective):
    """A cold solve on the card at full scale hands the pack the shapes
    above; ``choose_config`` and the resident scan on those tensors equal
    their plain versions bit for bit, and the solve (then a hit and, on the
    100k tick, a delta of 1 % of the pods) equals the CPU's."""
    import dataclasses

    build, kp, cp = BENCH_SHAPES[problem]
    spec = tuple(build())
    pools, inv, pods = spec[:3]
    existing = list(spec[3]) if len(spec) > 3 else []
    calls, real = [], fused_packer.ffd_pack
    monkeypatch.setattr(fused_packer, "ffd_pack",
                        lambda *a, **kw: (calls.append(a), real(*a, **kw))[1])
    card = TorchScheduler(pools, inv, existing=existing, objective=objective,
                          device=cuda_device)
    cpu = TorchScheduler(pools, inv, existing=existing, objective=objective, device="cpu")
    # 1 % of the pods leave and as many arrive, all of the first pod's shape,
    # so the class counts change and the delta scatters rows
    n = len(pods) // 100
    delta = pods[n:] + [dataclasses.replace(pods[0], name="") for _ in range(n)]
    batches = (pods, pods, delta) if problem == "resident100k" else (pods, pods)
    for i, batch in enumerate(batches):
        before = fused_packer.LAUNCHES["ffd_scan"]
        got, want = card.solve(batch), cpu.solve(batch)
        assert fused_packer.LAUNCHES["ffd_scan"] == before + 1
        assert card.last_kernel == "cuda_ffd" and card.last_resident
        assert T.canonical_result(got) == T.canonical_result(want)
        assert not got.unschedulable
        if i == 0:
            args = calls[-1]
            assert (args[8].shape[0], args[5].shape[0]) == (kp, cp)
            assert args[11] == len(existing)
            assert fused_packer.scan_kernel(args[8].shape[0], args[0].shape[1],
                                            args[12].shape[0], cp) == "ffd_scan"
            chosen = fused_packer.choose_config(*(args[j] for j in (0, 2, 4, 5, 6, 7)),
                                                objective)
            plain = choose_config_reference(*(args[j] for j in (0, 2, 4, 5, 6, 7)),
                                            objective)
            _assert_bit_equal(chosen, plain)
            scan_in = (*args[:6], *plain, *args[8:])
            _assert_bit_equal(fused_packer.ffd_scan(*scan_in), ffd_scan_reference(*scan_in))
    if problem == "resident100k":
        assert card.last_delta_rows > 0


# ---------------------------------------------------------------------------
# The consolidation verdicts: the batched scans, verdict_rows and
# population_prologue against their plain versions on the same card tensors
# ---------------------------------------------------------------------------


def _sweep(dev, pods=560):
    """bench.py's consolidation sweep (testing.consolidation_sweep): its
    removal base on ``dev``, the universe and the scheduler."""
    pools, inv, existing, cands = T.consolidation_sweep(pods)
    sched = TorchScheduler(pools, inv, existing=existing, device=dev)
    base = sched._removal_base(tuple(cands))
    assert not base.reason and not base.empty and not base.pop_reason
    return sched, base, cands


def _random_batch(base, B, seed):
    """B seeded what-if elements over a base (host numpy): class orders,
    counts and removed live slots."""
    rng = np.random.RandomState(seed)
    perm = np.stack([rng.permutation(base.gp) for _ in range(B)]).astype(np.int32)
    cnt = rng.randint(0, 5, (B, base.gp)).astype(np.int32)
    rm = np.zeros((B, base.kp), bool)
    rm[:, : base.n_live] = rng.rand(B, base.n_live) < 0.2
    return cnt, rm, perm


def _batched_case(case, dev):
    """``(base args on dev, cnt_b, rm_b, perm_b)``: the sweep's singles
    (the resident scan at Kp 1024), or config 2's pods at 4096 slots with a
    seeded batch (the cluster scan)."""
    if case == "sweep":
        sched, base, cands = _sweep(dev)
        cnt, rm, perm, bad = sched._subset_batch(base, [[c] for c in cands])
        assert not bad
        return base.args, *to_device((cnt, rm, perm), dev)
    pools, inv, pods = T.heterogeneous_problem(scale=0.02)
    host = pad_problem(compile_problem(pods, pools, inv), 4096)[0]
    G, K = host[0].shape[0], host[8].shape[0]
    rng = np.random.RandomState(5)
    perm = np.stack([rng.permutation(G) for _ in range(16)]).astype(np.int32)
    cnt = rng.randint(0, 9, (16, G)).astype(np.int32)
    return to_device(host, dev), *to_device((cnt, np.zeros((16, K), bool), perm), dev)


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("case,kernel", [("sweep", "ffd_scan_batched"),
                                         ("heterogeneous-4096", "ffd_scan_cluster_batched")])
def test_batched_scan_matches_reference(cuda_device, case, kernel, objective):
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference

    args, cnt_b, rm_b, perm_b = _batched_case(case, cuda_device)
    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    shapes = (used0.shape[0], req.shape[1], sig0.shape[0], alloc.shape[0])
    assert f"{fused_packer.scan_kernel(*shapes)}_batched" == kernel
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable, objective)
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    got, moved = _launch_moves(lambda: fused_packer.ffd_scan_batch(*scan_args))
    # the sweep (Kp 1024) fits the window: the window scan alone; at 4096
    # slots the window scan, then the picked scan for what leaves it
    assert moved == dict.fromkeys(fused_packer.batch_launches(next0, *shapes), 1)
    assert ("ffd_scan_window_batched" in moved) and (len(moved) == 1) == (case == "sweep")
    _assert_bit_equal(got, ffd_scan_batch_reference(*scan_args))


def test_batched_global_scan_matches_reference(cuda_device):
    """The global scan with the batch axis (the shapes past the cluster
    scan's), through its launcher, on the sweep's singles."""
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference

    args, cnt_b, rm_b, perm_b = _batched_case("sweep", cuda_device)
    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    shapes = (req.shape[0], alloc.shape[0], used0.shape[0], req.shape[1], sig0.shape[0])
    got, moved = _launch_moves(lambda: fused_packer._launch_global(
        (req, cnt_b[0], maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0),
        shapes, (perm_b.shape[0], perm_b, cnt_b, rm_b)))
    assert moved == {"ffd_scan_global_batched": 1}
    _assert_bit_equal(got, ffd_scan_batch_reference(
        req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
        cnt_b, rm_b, perm_b))


@pytest.mark.parametrize("objective", ["nodes", "cost"])
def test_verdict_kernels_match_reference(cuda_device, objective):
    """At the sweep's shape: `population_prologue` on a seeded population,
    then `verdict_rows` on the batched scan's outputs, each bit-equal to
    its plain version, and the whole `population_verdicts` to the plain
    `population_verdicts_reference`."""
    from karpenter_tpu_torch.ops.packer import (
        population_prologue_reference,
        population_verdicts_reference,
        verdict_rows_reference,
    )

    _, base, cands = _sweep(cuda_device)
    rng = np.random.RandomState(1)
    masks = torch.from_numpy(rng.rand(64, base.cand_slot.shape[0]) < 0.3).to(cuda_device)
    masks[:, len(cands):] = False
    pop = (base.cand_cnt, base.cand_slot, base.cand_occ, base.sort_rank, base.occ_span,
           masks, base.k_slots)
    got, moved = _launch_moves(lambda: fused_packer.population_prologue(*pop))
    assert moved == {"population_pairs": 1}
    _assert_bit_equal(got, population_prologue_reference(*pop))
    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = base.args
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable, objective)
    outs = fused_packer.ffd_scan_batch(req, maxper, slot, feas, alloc, *chosen,
                                       used0, cfg0, npods0, next0, sig0, *got)
    tail = (got[2], feas, alloc, price, openable, base.pool_id, base.zone_id, base.ct_id,
            base.compactable, next0)
    rows, moved = _launch_moves(lambda: fused_packer.verdict_rows(*outs, *tail))
    assert moved == {k: 1 for k in fused_packer.VERDICT_ROWS_LAUNCHES}
    _assert_bit_equal([rows], [verdict_rows_reference(*outs, *tail)])
    plain_args = (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0,
                  next0, sig0, base.pool_id, base.zone_id, base.ct_id, base.compactable,
                  base.cand_cnt, base.cand_slot, base.cand_occ, base.sort_rank,
                  base.occ_span, masks)
    _assert_bit_equal([rows], [population_verdicts_reference(*plain_args, objective=objective)])


@pytest.mark.parametrize("objective", ["nodes", "cost"])
def test_verdicts_on_card_match_cpu(cuda_device, objective):
    """`evaluate_removals` on the singles and `evaluate_population` on a
    seeded population through the card equal the same calls on the CPU."""
    pools, inv, existing, cands = T.consolidation_sweep()
    card = TorchScheduler(pools, inv, existing=existing, device=cuda_device,
                          objective=objective)
    cpu = TorchScheduler(pools, inv, existing=existing, device="cpu", objective=objective)
    singles = [[c] for c in cands]
    got, moved = _launch_moves(lambda: card.evaluate_removals(singles, cands))
    assert moved.get("ffd_scan_window_batched") == 1  # Kp 1024: the window alone
    assert all(moved.get(k) == 1 for k in fused_packer.VERDICT_ROWS_LAUNCHES)
    assert got == cpu.evaluate_removals(singles, cands)
    masks = np.random.RandomState(2).rand(100, len(cands)) < 0.25
    got, moved = _launch_moves(lambda: card.evaluate_population(masks, cands))
    assert moved.get("population_pairs") == 1
    assert got == cpu.evaluate_population(masks, cands)


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("case", list(T.VERDICT_TIE_CASES))
def test_verdict_rows_on_tie_arrays(cuda_device, case, objective):
    """The removal verdicts through the card (each launch once) and
    `verdict_rows` on the scan's outputs at next0, 0 and K, bit-equal to
    their plain versions on the tie arrays: equal masked prices across
    warps and config tiles, elements in two groups of 32, an element with
    every config masked, one with no new slot, one with many; at the live
    problem's shape too."""
    from karpenter_tpu_torch.ops.packer import removal_verdicts_reference, verdict_rows_reference

    a = to_device(T.verdict_tie_arrays(*T.VERDICT_TIE_CASES[case]), cuda_device)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
    K, R = used0.shape
    scans = fused_packer.batch_launches(next0, K, R, sig0.shape[0], alloc.shape[0])
    got, moved = _launch_moves(lambda: fused_packer.removal_verdicts(*a, objective=objective))
    assert moved == {"choose_config": 1, **dict.fromkeys(scans, 1),
                     **{k: 1 for k in fused_packer.VERDICT_ROWS_LAUNCHES}}
    _assert_bit_equal([got], [removal_verdicts_reference(*a, objective=objective)])
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable, objective)
    outs = fused_packer.ffd_scan_batch(req, maxper, slot, feas, alloc, *chosen, used0, cfg0,
                                       npods0, next0, sig0, cnt_b, rm_b, perm_b)
    tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable)
    for n0 in sorted({next0, 0, K}):
        _assert_bit_equal([fused_packer.verdict_rows(*outs, *tail, n0)],
                          [verdict_rows_reference(*outs, *tail, n0)])


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("case", list(T.FRONTIER_CASES))
def test_window_scan_on_frontier_arrays(cuda_device, case, objective):
    """The frontier-window scan through `ffd_scan_batch` on each of
    `testing.frontier_arrays`' cases: the launches its plan makes (the
    window alone, both, or the picked scan alone), its `done` mask equal
    to the elements whose frontier stays within W where the tail does not
    move, every output bit-equal to the plain version, and the removal
    verdicts' rows too."""
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference, removal_verdicts_reference

    a = to_device(T.frontier_arrays(case), cuda_device)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     *_, cnt_b, rm_b, perm_b) = a
    K, R = used0.shape
    shapes = (K, R, sig0.shape[0], alloc.shape[0])
    W = fused_packer.window_layout(*shapes)[0]
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable, objective)
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    fused_packer.WINDOW_RECORDS = []
    try:
        got, moved = _launch_moves(lambda: fused_packer.ffd_scan_batch(*scan_args))
        (rec,) = fused_packer.WINDOW_RECORDS
    finally:
        fused_packer.WINDOW_RECORDS = None
    assert moved == dict.fromkeys(fused_packer.batch_launches(next0, *shapes), 1)
    want = ffd_scan_batch_reference(*scan_args)
    _assert_bit_equal(got, want)
    assert rec["W"] == W and rec["plan"] == fused_packer.window_plan(next0, K, W)
    if rec["done"] is not None:
        finishes = T.window_finishes(used0.cpu().numpy(), req.cpu().numpy(),
                                     want[2].cpu().numpy(), next0, W)
        np.testing.assert_array_equal(rec["done"].cpu().numpy(), finishes.astype(np.int32))
    rows, _ = _launch_moves(lambda: fused_packer.removal_verdicts(*a, objective=objective))
    _assert_bit_equal([rows], [removal_verdicts_reference(*a, objective=objective)])


@pytest.mark.parametrize("shape", T.PROLOGUE_CASES)
def test_population_prologue_past_the_block(cuda_device, shape):
    """`population_prologue` (one launch) bit-equal to its plain version
    with U and Gp past its block of 256 threads, rm rows of 16-byte stores
    and of byte stores (K 1000, 7)."""
    from karpenter_tpu_torch.ops.packer import population_prologue_reference

    a = to_device(T.population_arrays(*shape), cuda_device)
    got, moved = _launch_moves(lambda: fused_packer.population_prologue(*a))
    assert moved == {"population_pairs": 1}
    _assert_bit_equal(got, population_prologue_reference(*a))


@pytest.mark.parametrize("step", range(4))
@pytest.mark.parametrize("case", ["cp8192-kp4096-b512", "gp40-cp1000"])
def test_verdict_rows_every_group(cuda_device, case, step, monkeypatch):
    """The config pass at each element group size (``step`` halvings of the
    largest; partial last groups, two flag words at Gp 40) gives the plain
    version's rows."""
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference, verdict_rows_reference

    groups = fused_packer.verdict_groups(fused_packer.verdict_shape()[1])
    assert len(groups) == 4
    group = groups[step]
    a = to_device(T.verdict_tie_arrays(*T.VERDICT_TIE_CASES[case]), cuda_device)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    outs = ffd_scan_batch_reference(req, maxper, slot, feas, alloc, *chosen, used0, cfg0,
                                    npods0, next0, sig0, cnt_b, rm_b, perm_b)
    tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable, next0)
    monkeypatch.setattr(fused_packer, "verdict_group", lambda *shape: group)
    _assert_bit_equal([fused_packer.verdict_rows(*outs, *tail)],
                      [verdict_rows_reference(*outs, *tail)])


def test_verdict_rows_axis_limit(cuda_device):
    """Past the axes the config pass's shared memory holds, `verdict_rows`
    launches the config pass that reads its rows from device memory (each
    of the three launches once) and gives the plain version's rows."""
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference, verdict_rows_reference

    index = torch.cuda.current_device()
    a = to_device(T.verdict_tie_arrays(*T.VERDICT_TIE_CASES["r200"]), cuda_device)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
    R = used0.shape[1]
    assert R > fused_packer._verdict_max_axes(index, req.shape[0]) > 150
    assert not fused_packer.verdict_rows_in_smem(index, req.shape[0], R)
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    outs = ffd_scan_batch_reference(req, maxper, slot, feas, alloc, *chosen, used0, cfg0,
                                    npods0, next0, sig0, cnt_b, rm_b, perm_b)
    tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable, next0)
    rows, moved = _launch_moves(lambda: fused_packer.verdict_rows(*outs, *tail))
    assert moved == {k: 1 for k in fused_packer.VERDICT_ROWS_LAUNCHES}
    _assert_bit_equal([rows], [verdict_rows_reference(*outs, *tail)])


def test_batched_scan_past_the_launch_limit(cuda_device):
    """B = 65,636 elements, past the 65,535 of one launch's grid: two
    launches, each writing its slice of the outputs, bit-equal to the
    plain version; then `verdict_rows` on all of them."""
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference, verdict_rows_reference

    B = fused_packer.MAX_BATCH + 101
    a = to_device(T.verdict_tie_arrays(8, 300, 64, B, 4), cuda_device)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    got, moved = _launch_moves(lambda: fused_packer.ffd_scan_batch(*scan_args))
    assert moved == {"ffd_scan_window_batched": 2}  # Kp 64: the window alone
    _assert_bit_equal(got, ffd_scan_batch_reference(*scan_args))
    tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable, next0)
    _assert_bit_equal([fused_packer.verdict_rows(*got, *tail)],
                      [verdict_rows_reference(*got, *tail)])


# ---------------------------------------------------------------------------
# The admission fast path
# ---------------------------------------------------------------------------


def _admit_args(host):
    (req, cnt, _maxper, _slot, feas, alloc, _price, openable,
     used0, cfg0, _npods0, _next0, _sig0) = host
    return req, cnt, feas, alloc, openable, used0, cfg0


@pytest.mark.parametrize("case", ["wrap", "wrap-4096-straddle", "heterogeneous-4096"])
def test_admit_matches_reference(cuda_device, case):
    """`admit` (one launch of ``admit_kernel``) bit-equal to
    `admit_reference` for every class: where four slots of a class that
    requests no axis wrap the int32 prefix, and at config 2's shapes over
    4096 slots with live nodes (its first slots prefilled)."""
    from karpenter_tpu_torch.ops.packer import admit_reference

    host = list(_case(case))
    if case.startswith("heterogeneous"):
        K = host[8].shape[0]
        rng = np.random.RandomState(3)
        live = 2000
        host[9] = host[9].copy()
        host[9][:live] = rng.randint(0, host[5].shape[0], live)
        host[8] = host[8].copy()
        host[8][:live] = host[5][host[9][:live]] * rng.rand(live, host[5].shape[1]).astype(np.float32)
        assert K == 4096
    args = to_device(_admit_args(host), cuda_device)
    for g in range(args[0].shape[0]):
        got, moved = _launch_moves(lambda: fused_packer.admit(*args, g))
        assert moved == {"admit_kernel": 1}
        _assert_bit_equal([got], [admit_reference(*args, g)])


@pytest.mark.parametrize("case", [*T.ADMIT_EDGE_CASES, "feas-offset"])
def test_admit_on_edge_arrays(cuda_device, case):
    """`testing.admit_edge_arrays`, every class, one launch each, bit for
    bit; ``feas-offset`` is the ``exact`` case with its feasibility rows one
    byte off 8-byte alignment (Cp 512: the byte loads)."""
    from karpenter_tpu_torch.ops.packer import admit_reference

    host = list(T.admit_edge_arrays("exact" if case == "feas-offset" else case))
    args = list(to_device(host, cuda_device))
    if case == "feas-offset":
        f = args[2]
        buf = torch.zeros(f.numel() + 1, dtype=torch.bool, device=cuda_device)
        buf[1:] = f.reshape(-1)
        args[2] = buf[1:].view(f.shape)
        assert args[2].data_ptr() % 8 == 1
    for g in range(args[0].shape[0]):
        got, moved = _launch_moves(lambda: fused_packer.admit(*args, g))
        assert moved == {"admit_kernel": 1}
        _assert_bit_equal([got], [admit_reference(*args, g)])


def test_admit_on_a_resident_state(cuda_device):
    """Every class of a warm resident state on the card: the kernel on the
    state's own tensors equals the plain version on the same tensors."""
    from karpenter_tpu_torch.ops.packer import admit_reference

    pools, inv, pods = T.heterogeneous_problem(scale=0.02)
    sched = TorchScheduler(pools, inv, existing=T.live_cluster(300), device=cuda_device)
    sched.solve(pods)
    st = sched._resident.states[0]
    args = (st.d_req, st.d_cnt, st.d_feas, st.d_alloc, st.d_openable, st.d_used0, st.d_cfg0)
    for g in range(st.Gp):
        _assert_bit_equal([fused_packer.admit(*args, g)], [admit_reference(*args, g)])


def test_fast_path_operator_on_card_matches_cpu(cuda_device):
    """A seed batch and a single-pod trickle through the operator with the
    fast path on: on the card ``admit_kernel`` launches and the final state
    (claims, nodes, bindings, cloud calls, ledger, solver and fast-path
    counters) equals the same drive on the CPU."""
    from karpenter_tpu_torch.api import Pod, Resources, Settings
    from karpenter_tpu_torch.api.objects import reset_name_sequences

    def drive(device):
        reset_name_sequences()
        env = T.Environment(settings=Settings(cluster_name="test", provision_fastpath_bypass=True,
                                              enable_pipelined_reconcile=False), device=device)
        env.default_node_class()
        env.default_node_pool()
        env.operator.provisioner.launch_concurrency = 1
        for i in range(12):
            env.kube.put_pod(Pod(name=f"seed-{i:02d}", requests=Resources(cpu=2.5, memory="2Gi")))
        env.settle()
        for i in range(8):
            env.kube.put_pod(Pod(name=f"trickle-{i}", requests=Resources(cpu=0.1, memory="64Mi")))
            env.step(2.0)
        env.settle()
        return T.operator_state(env)

    before = fused_packer.LAUNCHES["admit_kernel"]
    card = drive(cuda_device)
    assert fused_packer.LAUNCHES["admit_kernel"] > before
    cpu = drive("cpu")
    assert card == cpu
    nominated = dict(card["counters"]["karpenter_admission_fastpath_total"])
    assert nominated.get((("outcome", "nominated"),), 0) > 0
    assert not card["counters"]["karpenter_admission_fastpath_mismatch_total"]


def test_consolidation_operator_on_card_matches_cpu(cuda_device):
    """Consolidation through the operator (``testing.consolidating_cluster``
    at 1,000 of config 2's pods, half of them deleted; the pipelined
    schedule on): on the card the batched scan, the three verdict launches
    and the population prologue launch, and the final state (claims
    created, marked and replaced, bindings, cloud calls, ledger, the
    disruption counters) equals the same drive on the CPU."""
    def drive(device):
        env = T.consolidating_cluster(device, n_pods=1000)
        for _ in range(10):
            env.step(2.0)
        return T.operator_state(env)

    before = dict(fused_packer.LAUNCHES)
    card = drive(cuda_device)
    launched = {k: v - before[k] for k, v in fused_packer.LAUNCHES.items()}
    for k in ("choose_config", "verdict_summary", "verdict_configs", "verdict_write",
              "population_pairs"):
        assert launched[k] > 0, (k, launched)
    assert launched["ffd_scan_window_batched"] > 0, launched
    assert launched["ffd_scan_global_batched"] == 0
    cpu = drive("cpu")
    assert card == cpu
    assert sum(dict(card["counters"]["karpenter_deprovisioning_actions"]).values()) >= 1
    assert not card["counters"]["karpenter_consolidation_verdict_mismatch_total"]


# ------------------------------------------------------------- fleet pack
def _fleet_case(case: str) -> list:
    """The tenants (host arguments) of a fleet case: ``testing``'s fleet
    tenants (dyadic, inexact, wrap at 256 slots) at B 1, 3 or 4, or config
    2 at scale 0.1 as four tenants whose counts and live usage are seeded
    apart, at its own slots (resident scan) or over 4096 (cluster scan)."""
    kind, _, rest = case.partition("-")
    if kind != "heterogeneous":
        B = int(rest)
        k = 256 if kind == "wrap" else 64
        return [T.fleet_tenant_arrays(kind, 30 + b, k) for b in range(B)]
    base = list(_case(case))
    out = []
    for b in range(4):
        rng = np.random.default_rng(40 + b)
        args = list(base)
        args[1] = (base[1] - np.floor(base[1] * rng.uniform(0, 0.2, base[1].shape))).astype(np.int32)
        args[6] = (base[6] * np.float32(1 + 0.01 * b)).astype(np.float32)
        out.append(tuple(args))
    return out


# case -> the scan the shapes pick
FLEET_CASES = {
    "dyadic-1": "ffd_scan", "dyadic-3": "ffd_scan", "dyadic-4": "ffd_scan",
    "inexact-4": "ffd_scan", "wrap-4": "ffd_scan",
    "heterogeneous": "ffd_scan", "heterogeneous-4096": "ffd_scan_cluster",
}


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_pack_matches_reference_and_solo(cuda_device, case, objective):
    """Each tenant's row of the fleet pack equals the plain version and a
    solo `ffd_pack` of its tenant, bit for bit; one launch of each fleet
    kernel."""
    tenants = [to_device(t, cuda_device) for t in _fleet_case(case)]
    cols = T.fleet_columns(tenants)
    K = tenants[0][8].shape[0]
    got, moved = _launch_moves(
        lambda: fused_packer.fleet_pack(cols, k_slots=K, objective=objective))
    assert moved == {"choose_config_fleet": 1, f"{FLEET_CASES[case]}_fleet": 1}, moved
    from karpenter_tpu_torch.ops.packer import fleet_pack_reference

    _assert_bit_equal(got, fleet_pack_reference(cols, k_slots=K, objective=objective))
    solo = [fused_packer.ffd_pack(*t, objective=objective) for t in tenants]
    _assert_bit_equal(got, tuple(torch.stack(o) for o in zip(*solo)))


def test_fleet_pack_global_scan(cuda_device):
    tenants = [to_device(t, cuda_device) for t in _fleet_case("heterogeneous-4096")]
    cols = T.fleet_columns(tenants)
    got, moved = _launch_moves(
        lambda: fused_packer.fleet_pack(cols, k_slots=4096, scan="ffd_scan_global"))
    assert moved == {"choose_config_fleet": 1, "ffd_scan_global_fleet": 1}, moved
    solo = [fused_packer.ffd_pack(*t) for t in tenants]
    _assert_bit_equal(got, tuple(torch.stack(o) for o in zip(*solo)))


def test_solver_service_on_card_matches_sidecar(cuda_device):
    """Barrier-released tenants through a multi-tenant server on the card
    get the dedicated sidecar's answers; the batched path ran."""
    import socket
    import threading

    from karpenter_tpu_torch.service import RemoteSolver, SolverServer
    from karpenter_tpu_torch.service.codec import decode, encode, recv_frame, send_frame
    from karpenter_tpu_torch.service.server import PACK_ARG_ORDER

    probs = {f"t{b}": T.fleet_tenant_arrays("dyadic", 60 + b) for b in range(4)}
    legacy = SolverServer(port=0, device="cuda").start_background()
    srv = SolverServer(port=0, multi_tenant=True, device="cuda").start_background()
    try:
        def solve(address, tenant, args):
            arrays = {n: np.asarray(a) for n, a in zip(PACK_ARG_ORDER, args)}
            with socket.create_connection(address) as sock:
                send_frame(sock, encode({"method": "pack", "k_slots": 64, "tenant": tenant},
                                        arrays))
                header, out = decode(recv_frame(sock))
            assert header["status"] == "ok", header
            return out

        want = {t: solve(legacy.address, "", a) for t, a in probs.items()}
        assert RemoteSolver(*srv.address).info()["platform"] == "cuda"
        for _ in range(5):
            barrier, got = threading.Barrier(len(probs)), {}

            def worker(t):
                barrier.wait(timeout=30)
                got[t] = solve(srv.address, t, probs[t])

            threads = [threading.Thread(target=worker, args=(t,)) for t in probs]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            for t in probs:
                for name, v in want[t].items():
                    np.testing.assert_array_equal(got[t][name], v, err_msg=f"{t} {name}")
        batched = sum(d["batched"] for d in srv.tenants_payload()["tenants"].values())
        assert batched > 0
    finally:
        srv.stop()
        legacy.stop()


def _ha_drive(device, launches=None):
    """The failover drive (`testing.ha_drive`) on 300 of config 2's pods
    over phase 7's cell, its invariants and the consistency checker."""
    from karpenter_tpu_torch.api import Disruption, Settings
    from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog

    settings = Settings(cluster_name="ha", enable_admission_fastpath=False,
                        enable_pipelined_reconcile=False, feature_gate_drift=False)
    h = T.HAHarness(device=device, shapes=generate_catalog(**T.CONFIG2_CATALOG),
                    settings=settings, launches=launches)
    try:
        h.default_node_class()
        hold = lambda: Disruption(consolidate_after=1e9)
        h.node_pool("general", disruption=hold())
        h.node_pool("dedicated", taints=[T.DEDICATED_TAINT], disruption=hold())
        h.sync()
        marks = T.ha_drive(h, T.heterogeneous_pods(300), churn_pods=10,
                           churn_rounds=(1, 1, 1))
        T.ha_checks(h, marks)
        assert T.ha_consistency(h) == []
        return h, {"launches": list(h.launches), "store": h.store_state(),
                   "state": {n: T.operator_state(h.view(n)) for n in T.HA_REPLICAS},
                   "ticks": [(t["round"], t["replica"], t["led"], t["kind"])
                             for t in h.ticks]}
    finally:
        h.close()


def test_failover_on_card_matches_cpu(cuda_device):
    """Two replicas on one shared store, their solvers on the card, through
    A's crash, B's take-over and release and A's second term: every solve
    on the card launches ``choose_config`` and the resident scan, and the
    launches, ticks, store state and each replica's operator state equal
    the same drive on the CPU."""
    fused_packer.reset_launches()
    h, card = _ha_drive("cuda", launches=fused_packer.LAUNCHES)
    solves = [t for t in h.ticks if t["kind"]]
    assert solves and all(t["launches"].get("choose_config") for t in solves)
    assert all(t["launches"].get("ffd_scan") for t in solves)
    assert fused_packer.LAUNCHES["ffd_scan_global"] == 0
    _, cpu = _ha_drive("cpu")
    for key in ("launches", "ticks", "store"):
        assert card[key] == cpu[key], key
    for name in T.HA_REPLICAS:
        for key in cpu["state"][name]:
            assert card["state"][name][key] == cpu["state"][name][key], (name, key)


# ---------------------------------------------------------------------------
# The device mesh (parallel/mesh.py, csrc/mesh_pack.cu): 8 shards a (4, 2)
# mesh over the machine's cards in turn (all on the one card of a one-card
# machine)
# ---------------------------------------------------------------------------


def _card_mesh(shards=8):
    """The (4, 2) mesh of 8 shards over the machine's cards in turn, or,
    with ``shards=1``, the default mesh of one card, (1, 1)."""
    from karpenter_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    return make_mesh(shards, [torch.device("cuda", i % n) for i in range(shards)])


MESH_CASES = {
    "wrap-256": lambda: T.wrap_arrays(256),
    "wrap-4096-straddling": lambda: T.wrap_arrays(4096, at=2046),
    "wrap-64-at-30": lambda: T.wrap_arrays(64, at=30),
    "ties": lambda: T.tie_arrays(),
    "configs-6": lambda: T.first_configs(T.wrap_arrays(256), 6),
}


def _mesh_scans_match(device, args, objective, expect_scan=False, shards=8):
    """Both scans of the sharded pack on the card mesh of ``shards`` shards
    (the one the plan picks, ``ffd_shard_scan`` where the data rows sit on
    one card and the shapes fit a CTA, and the pair composed by hand, as
    the plan runs it across cards): their launches, the whole outputs
    bit-equal to `mesh_pack_reference` on the same card shards and to the
    single-device `ffd_pack`, and the one-launch scan's shard buffers equal
    to `ffd_shard_scan_reference`'s."""
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as PM

    mesh = _card_mesh(shards)
    plan, reps, slots, next0 = PM.pack_layout(mesh, args, site="mesh_pack")
    G, R = args[0].shape
    D, tiles = len(plan.tiles), len(plan.tiles) * len(plan.tiles[0])
    picked = fused_packer.shard_scan_kernel(plan, args[8].shape[0], R, args[12].shape[0],
                                            args[5].shape[0])
    one_card = picked == "ffd_shard_scan"
    assert one_card == (len(mesh.distinct()) == 1) or not expect_scan
    want = P.mesh_pack_reference(plan, reps, slots, next0, objective)
    single = fused_packer.ffd_pack(*to_device(args, device), objective=objective)

    def pair():
        recs = [fused_packer.choose_config_shard(*(reps[dev][i] for i in (0, 2, 4, 5, 6, 7)),
                                                 g0, g1, c0, c1, objective)
                for dev, g0, g1, c0, c1 in plan.tile_bounds()]
        shards = P.mesh_shards(plan, reps, recs, slots, next0)
        P.mesh_scan(shards, fused_packer.ffd_shard_cap, fused_packer.ffd_shard_apply)
        return P.mesh_outputs(shards)

    for forced, run in ((False, lambda: fused_packer.mesh_pack(plan, reps, slots, next0,
                                                               objective)), (True, pair)):
        fused_packer.reset_launches()
        got = run()
        by_pair = forced or not one_card
        assert fused_packer.LAUNCHES["ffd_shard_scan"] == (0 if by_pair else 1)
        assert fused_packer.LAUNCHES["ffd_shard_cap"] == ((G + 1) * D if by_pair else 0)
        assert fused_packer.LAUNCHES["ffd_shard_apply"] == (G * D if by_pair else 0)
        assert fused_packer.LAUNCHES["choose_config_shard"] == tiles
        _assert_bit_equal(got, want)
        _assert_bit_equal(got, single)
    if one_card:
        recs = [P.choose_config_shard_reference(*(reps[dev][i] for i in (0, 2, 4, 5, 6, 7)),
                                                g0, g1, c0, c1, objective)
                for dev, g0, g1, c0, c1 in plan.tile_bounds()]
        kern = P.mesh_shards(plan, reps, recs, slots, next0)
        plain = P.mesh_shards(plan, reps, recs, slots, next0)
        fused_packer.ffd_shard_scan(kern)
        P.ffd_shard_scan_reference(plain)
        for a, b in zip(kern, plain):
            for f in ("used", "cfg", "npods", "sig", "take", "leftover", "nxt"):
                x, y = getattr(a, f), getattr(b, f)
                assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                   y.view(torch.int32) if y.dtype == torch.float32 else y), f


@pytest.mark.parametrize("case", sorted(MESH_CASES))
@pytest.mark.parametrize("objective", ["nodes", "cost"])
def test_mesh_pack_matches_plain_and_ffd_pack(cuda_device, case, objective):
    """The sharded pack's kernels (choose_config_shard; ffd_shard_scan, or
    ffd_shard_cap and ffd_shard_apply where forced) against their plain
    versions on the same card shards, and against the single-device
    ffd_pack, bit for bit."""
    _mesh_scans_match(cuda_device, MESH_CASES[case](), objective)


def _padded(pools, inv, pods, existing=()):
    """A problem padded as `mesh_pack_fn` pads it for the (4, 2) mesh."""
    from karpenter_tpu_torch.ops.packer import node_slot_bound

    prob = compile_problem(pods, pools, inv, existing=list(existing))
    return pad_problem(prob, max(node_slot_bound(prob), 32))[0]


# the main path's problems at full size and the cases that wrap
MESH_SCAN_CASES = {
    "config2": lambda: _padded(*T.heterogeneous_problem()),
    "flagship": lambda: (lambda pool, types, pods: _padded([pool], {pool.name: types},
                                                          pods))(*T.flagship_problem()),
    "live-2000": lambda: _padded(*T.heterogeneous_problem(), T.live_cluster(2000)),
    "wrap-256": lambda: T.wrap_arrays(256),
    "wrap-4096-straddling-2048": lambda: T.wrap_arrays(4096, at=2046),
    "frontier-wrap-0": lambda: T.frontier_pack("wrap", 0),
    "frontier-past-last": lambda: T.frontier_pack("past", -1),
}


# each case on the (4, 2) mesh of one card, and those of at most 2,048
# slots on the default mesh of one card, (1, 1): one CTA holding every slot
MESH_SCAN_RUNS = [(case, 8) for case in sorted(MESH_SCAN_CASES)] + [
    (case, 1) for case in ("config2", "flagship", "wrap-256", "frontier-wrap-0",
                           "frontier-past-last")]


@pytest.mark.parametrize("case,shards", MESH_SCAN_RUNS,
                         ids=[c if n == 8 else f"{c}-1x1" for c, n in MESH_SCAN_RUNS])
@pytest.mark.parametrize("objective", ["nodes", "cost"])
def test_mesh_shard_scan_matches_plain_and_ffd_pack(cuda_device, case, shards, objective):
    """``ffd_shard_scan`` (one cluster launch: 4 CTAs for the (4, 2) mesh's
    data shards on one card, 1 for the (1, 1) mesh, 2,048 slots at the
    frontier cases there, two a thread) and the pair driven directly on
    config 2, the flagship, the live cluster (2,000 live nodes: 4 shards of
    1,024 slots), the wrap case at 256 and 4096 slots (the prefilled slots
    across the shard boundary at 2,048) and two frontier elements: equal to
    their plain versions and to ffd_pack, bit for bit."""
    args = MESH_SCAN_CASES[case]()
    if case == "live-2000":
        assert args[8].shape[0] == 4096
    _mesh_scans_match(cuda_device, args, objective, expect_scan=True, shards=shards)


def test_assemble_feasibility_kernel_matches_plain(cuda_device):
    """One launch a tile and the whole mask, against the plain version, at
    the mesh tests' problem and at config 2's shapes (Gp 320, Cp 8192);
    then chip_smoke's `assemble_cases` (tiles whose bounds and widths 1, 15
    and 17 are no multiples of 16, fresh and in place into masks
    prefilled with a sentinel whose rows are C and C + 3 bytes apart, and
    9 tiles in one launch; one launch a call) at those shapes, at G 37,
    C 100 with every class its own signature, and at T 60,000."""
    import chip_smoke
    from karpenter_tpu_torch.ops import packer as P

    for kw in ({}, {"classes": 320, "k_slots": 4096, "types": 1024}):
        p = T.mesh_step_problem(**kw)
        adm = to_device(tuple(p[k] for k in T.MESH_STEP_ARGS[:7]), cuda_device)
        G, C = len(p["sig_of"]), len(p["t_of"])
        for g0, g1, c0, c1 in ((0, G, 0, C), (1, G // 2, 3, C - 5), (2, 2, 0, C)):
            got = fused_packer.assemble_feasibility(*adm, g0, g1, c0, c1)
            assert torch.equal(got, P.assemble_feasibility_reference(*adm, g0, g1, c0, c1))
        diff, launches = chip_smoke.assemble_cases(torch, adm)
        assert set(launches) == {1} and not any(diff.values()), diff
    for kw in ({"S": 37}, {"C": 300, "S": 4, "T": 60000}):
        arrays = T.assemble_arrays(**kw)
        diff, launches = chip_smoke.assemble_cases(torch, to_device(arrays, cuda_device))
        assert set(launches) == {1} and not any(diff.values()), (kw, diff)


def test_mesh_scheduler_on_card_matches_single_device(cuda_device):
    """`TorchScheduler(pack_fn=mesh_pack_fn(mesh))` on the card: config 2
    at a tenth of its pods, cold, hit and a delta, decodes as the
    single-device scheduler does; its sharded resident buffers equal their
    mirrors; the admission fast path falls back with sharded_backend."""
    from karpenter_tpu_torch.parallel.mesh import mesh_pack_fn
    from karpenter_tpu_torch.scheduling import fastpath

    pools, inv, pods = T.heterogeneous_problem(scale=0.1)
    single = TorchScheduler(pools, inv, device=cuda_device)
    fn = mesh_pack_fn(_card_mesh())
    sharded = TorchScheduler(pools, inv, device=cuda_device, pack_fn=fn)
    key = lambda r: (sorted((len(n.pods), n.feasible_types[0].name) for n in r.new_nodes),
                     sorted(r.unschedulable))
    for batch in (pods, pods, pods[5:] + [type(p)(requests=p.requests) for p in pods[:5]]):
        assert key(sharded.solve(batch)) == key(single.solve(batch))
        assert sharded.last_kernel == "scan-sharded" and sharded.last_resident
    st = sharded._resident.states[-1]
    assert st.mesh is fn.mesh
    for name in ("req", "cnt", "feas", "alloc", "price", "used0", "npods0"):
        a, b = getattr(st, f"d_{name}").host(), getattr(st, f"h_{name}")
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b)
    sharded.solve(pods[:4])
    res = fastpath.try_admit(sharded, [type(pods[0])(requests=pods[0].requests)])
    assert (res.outcome, res.reason) == ("fallback", fastpath.REASON_SHARDED_BACKEND)


def test_mesh_kernels_refuse_misaligned_feas(cuda_device):
    """The choice and scan kernels read feas rows; like the single-device
    kernels they refuse one that does not start on a 16-byte boundary."""
    args = to_device(T.wrap_arrays(256), cuda_device)
    req, _, maxper, _, feas, alloc, price, openable = args[:8]
    buf = torch.zeros(feas.numel() + 1, dtype=torch.bool, device=cuda_device)
    buf[1:] = feas.reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        fused_packer.choose_config_shard(req, maxper, buf[1:].view(feas.shape), alloc, price,
                                         openable, 0, 4, 0, 8)
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as PM

    plan, reps, slots, next0 = PM.pack_layout(_card_mesh(), T.wrap_arrays(256),
                                              site="mesh_pack")
    shards = P.mesh_shards(plan, reps, [torch.zeros((g1 - g0, P.MESH_REC), dtype=torch.int32,
                                                    device=dev)
                                        for dev, g0, g1, _, _ in plan.tile_bounds()],
                           slots, next0)
    for sh in shards:
        sh.rep = sh.rep[:4] + (buf[1:].view(feas.shape),) + sh.rep[5:]
    with pytest.raises(ValueError, match="16-byte"):
        fused_packer.ffd_shard_scan(shards)


# ---- the grid scan's batch and fleet modes (past one thread-block cluster)


def _live10k_batch(dev, B: int):
    """The removal base of 10,000 live nodes of config 2's ``std1.large``
    (1-4 seeded pods each, universe its 64 least-loaded nodes: Kp and Cp
    16,384) and a batch of its 64 singles and 64 drop-one subsets, tiled to
    B elements: ``(scan arguments of ffd_scan_batch, next0)``."""
    hpools, hinv, _ = T.heterogeneous_problem(scale=1 / T.N_PODS)
    std = next(it for it in hinv["general"] if it.name == "std1.large")
    existing, cands = T.consolidation_cluster(8, 10_000, [std])
    universe = cands[:64]
    sched = TorchScheduler(hpools, hinv, existing=existing, device=dev)
    base = sched._removal_base(tuple(universe))
    subsets = [[c] for c in universe] + [[c for c in universe if c is not d] for d in universe]
    cnt, rm, perm, bad = sched._subset_batch(base, subsets)
    assert not bad and cnt.shape[0] == 128
    reps = -(-B // 128)
    cnt_b, rm_b, perm_b = (torch.from_numpy(np.concatenate([a] * reps)[:B]).to(dev)
                           for a in (cnt, rm, perm))
    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = base.args
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable)
    return (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
            cnt_b, rm_b, perm_b), next0


@pytest.mark.parametrize("B", [128, 512])
def test_batched_grid_scan_on_live10k(cuda_device, B):
    """The consolidation base of 10,000 live nodes: ``ffd_scan_batch``
    launches the grid's batch mode alone (next0 past the window), bit-equal
    to the plain version."""
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference

    scan_args, next0 = _live10k_batch(cuda_device, B)
    shapes = (scan_args[8].shape[0], scan_args[0].shape[1], scan_args[12].shape[0],
              scan_args[4].shape[0])
    assert shapes == (16384, 6, 2, 16384)
    assert fused_packer.batch_launches(next0, *shapes) == ("ffd_scan_grid_batched",)
    got, moved = _launch_moves(lambda: fused_packer.ffd_scan_batch(*scan_args))
    assert moved == {"ffd_scan_grid_batched": 1}
    _assert_bit_equal(got, ffd_scan_batch_reference(*scan_args))


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("shape", [
    dict(case="past", k_slots=16384, configs=20000),  # the "both" plan, one cluster
    dict(case="wrap", k_slots=32768, batch=16),  # two clusters, 16 elements, "both"
    dict(case="wrap", k_slots=32768, batch=16, at=2046),  # across a CTA boundary
    dict(case="wrap", k_slots=32768, batch=16, at=16382),  # across a cluster boundary
])
def test_batched_grid_scan_on_frontier_arrays(cuda_device, shape, objective):
    """The grid's batch mode after the frontier-window scan (the elements
    that leave the window) and on every element, bit-equal to the plain
    version; the window's done mask is the elements whose frontier stays
    within W."""
    from karpenter_tpu_torch.ops.packer import ffd_scan_batch_reference

    a = to_device(T.frontier_arrays(**shape), cuda_device)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     *_, cnt_b, rm_b, perm_b) = a
    chosen = fused_packer.choose_config(req, maxper, feas, alloc, price, openable, objective)
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    K, R = used0.shape
    plan = fused_packer.batch_launches(next0, K, R, sig0.shape[0], alloc.shape[0])
    assert plan[-1] == "ffd_scan_grid_batched"
    fused_packer.WINDOW_RECORDS = []
    try:
        got, moved = _launch_moves(lambda: fused_packer.ffd_scan_batch(*scan_args))
        records = fused_packer.WINDOW_RECORDS
    finally:
        fused_packer.WINDOW_RECORDS = None
    assert moved == dict.fromkeys(plan, 1)
    want = ffd_scan_batch_reference(*scan_args)
    _assert_bit_equal(got, want)
    if records[0]["done"] is not None:
        W = records[0]["W"]
        front = T.element_frontiers(want[2].cpu().numpy(), next0)
        np.testing.assert_array_equal(records[0]["done"].cpu().numpy(), front <= W)
        if shape["case"] == "past":
            assert (front > W).sum() == 2  # two elements went on to the grid
    every = fused_packer._launch_picked(
        (req, cnt_b[0], *scan_args[1:13]), (req.shape[0], alloc.shape[0], K, R, sig0.shape[0]),
        (perm_b.shape[0], perm_b, cnt_b, rm_b))
    torch.cuda.synchronize()
    _assert_bit_equal(every, want)


def _live_fleet(live: int, n: int, dev) -> list:
    """``n`` tenants of config 2 on ``live`` live nodes at full size, each
    live node's usage scaled by a seeded factor and each class's count cut
    by a seeded share (chip_smoke's ``live_tenants``)."""
    pools, inv, pods = T.heterogeneous_problem()
    base, _ = pad_problem(compile_problem(pods, pools, inv, existing=T.live_cluster(live)))
    E = base[11]
    out = []
    for i in range(n):
        rng = np.random.default_rng(23 + i)
        args = list(base)
        used0 = args[8].copy()
        used0[:E] = (used0[:E] * rng.uniform(0.5, 1.0, (E, 1))).astype(np.float32)
        args[8] = used0
        cnt = args[1]
        args[1] = (cnt - np.floor(cnt * rng.uniform(0.0, 0.1, cnt.shape))).astype(np.int32)
        out.append(to_device(tuple(args), dev))
    return out


@pytest.mark.parametrize("live,B", [(10_000, 4), (10_000, 16), (20_000, 4)])
def test_fleet_grid_scan(cuda_device, live, B):
    """Fleets past one cluster (Kp 16,384 at B 4 and 16, more than the card's
    15 groups; 32,768 at B 4, two clusters an element): ``fleet_pack``
    launches the grid's fleet mode, and each tenant's row equals the plain
    version and its solo ``ffd_pack``, both objectives."""
    from karpenter_tpu_torch.ops.packer import fleet_pack_reference

    tenants = _live_fleet(live, B, cuda_device)
    cols = T.fleet_columns(tenants)
    K = tenants[0][8].shape[0]
    for objective in ("nodes", "cost"):
        got, moved = _launch_moves(
            lambda: fused_packer.fleet_pack(cols, k_slots=K, objective=objective))
        assert moved == {"choose_config_fleet": 1, "ffd_scan_grid_fleet": 1}, moved
        _assert_bit_equal(got, fleet_pack_reference(cols, k_slots=K, objective=objective))
        solo = [fused_packer.ffd_pack(*t, objective=objective) for t in tenants]
        _assert_bit_equal(got, tuple(torch.stack(o) for o in zip(*solo)))


@pytest.mark.parametrize("batched", [False, True])
def test_grid_spin_budget_traps(cuda_device, batched):
    """A grid launch of two clusters an element whose waits may take one
    clock cycle traps, alone and with a batch axis, and torch raises (in a
    process of its own: the trap ends its CUDA context)."""
    import pathlib
    import subprocess
    import sys

    import chip_smoke

    script = chip_smoke.SPIN_TRAP_SCRIPT % (32768, batched, chip_smoke.GRID_BATCH)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=pathlib.Path(chip_smoke.__file__).resolve().parent, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1].startswith("raised: ")
