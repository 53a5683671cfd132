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
an operator drive that consolidates on the card, to the CPU's.

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
# 4096, where the cluster scan takes it (8 CTAs), up to 16,384 slots.
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
    # wrap[-K[-straddle]]: the prefilled slots straddle slot K / 2
    _, k, straddle = (case.split("-") + ["", ""])[:3]
    k = int(k or 256)
    return T.wrap_arrays(k, at=k // 2 - 2 if straddle else 0)


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


@pytest.mark.parametrize("live_nodes,kernel", [(0, "ffd_scan"), (2000, "ffd_scan_cluster")])
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
