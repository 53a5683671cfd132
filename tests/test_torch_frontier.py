"""The frontier-window scan's cases and launch rule, on the CPU.

``testing.frontier_arrays`` builds removal-verdict batches that put the
elements' frontiers (live slots plus the new slots opened so far) inside,
at and past the window W that ``fused_packer.window_layout`` picks, with
``next0`` past W, with K within W, with a -0.0 usage in the tail and in the
window, with a request of +inf, and with caps of 2^30 whose prefix sums
wrap.  On every case and both objectives the port's plain
``removal_verdicts_reference`` gives JAX ``removal_verdict_kernel``'s rows
bit for bit; each case reaches what it is for, read from the plain
version's frontiers against W; and ``window_plan`` takes each of its three
branches.  The card kernel itself is held to the plain version by
``tests/test_torch_cuda.py`` and chip_smoke phase 6.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import packer as JP
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.ops import fused_packer as F
from karpenter_tpu_torch.ops import packer as P

OBJECTIVES = ("nodes", "cost")


def _torch(a):
    return [x if isinstance(x, int) else torch.from_numpy(x) for x in a]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _scan(case):
    """The case's arrays, its plain batched scan (nodes objective) and W."""
    a = T.frontier_arrays(case)
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     _pool, _zone, _ct, _comp, cnt_b, rm_b, perm_b) = _torch(a)
    chosen = P.choose_config_reference(req, maxper, feas, alloc, price, openable)
    outs = P.ffd_scan_batch_reference(req, maxper, slot, feas, alloc, *chosen, used0, cfg0,
                                      npods0, next0, sig0, cnt_b, rm_b, perm_b)
    K, R = used0.shape
    W = F.window_layout(K, R, sig0.shape[0], feas.shape[1])[0]
    return a, outs, W


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("case", list(T.FRONTIER_CASES))
def test_frontier_rows_bit_equal(case, objective):
    a = T.frontier_arrays(case)
    port = P.removal_verdicts_reference(*_torch(a), objective=objective)
    want = JP.removal_verdict_kernel(*a, k_slots=a[7].shape[0], objective=objective)
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(want))


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_frontier_rows_bit_equal_past_one_cluster(objective):
    """The "past" case at Kp 16,384 and Cp 20,000, B 4 (the shapes at which
    the elements that leave the window go to the grid's batch mode): the
    port's plain rows equal JAX ``removal_verdict_kernel``'s bit for bit,
    and two elements do leave the window."""
    shape = dict(k_slots=16384, configs=20000, batch=4)
    a = T.frontier_arrays("past", **shape)
    K, R = a[7].shape
    assert F.batch_launches(a[10], K, R, a[11].shape[0], a[3].shape[1]) == (
        "ffd_scan_window_batched", "ffd_scan_grid_batched")
    port = P.removal_verdicts_reference(*_torch(a), objective=objective)
    want = JP.removal_verdict_kernel(*a, k_slots=K, objective=objective)
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(want))
    scan = P.ffd_scan_batch_reference(*_scan_inputs(a))
    W = F.window_layout(K, R, a[11].shape[0], a[3].shape[1])[0]
    front = T.element_frontiers(scan[2].numpy(), a[10])
    assert sorted(front[front > W].tolist()) == [W + 3, K]


def _scan_inputs(a):
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     _pool, _zone, _ct, _comp, cnt_b, rm_b, perm_b) = _torch(a)
    chosen = P.choose_config_reference(req, maxper, feas, alloc, price, openable)
    return (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
            cnt_b, rm_b, perm_b)


@pytest.mark.parametrize("case", list(T.FRONTIER_CASES))
def test_frontier_cases_reach_their_purpose(case):
    a, outs, W = _scan(case)
    used0, req, next0 = a[7], a[0], a[10]
    K = used0.shape[0]
    front = T.element_frontiers(outs[2].numpy(), next0)
    done = T.window_finishes(used0, req, outs[2].numpy(), next0, W)
    plan = F.window_plan(next0, K, W)
    assert (plan == "pick") == (case == "next0-past-w")
    assert (plan == "window") == (case == "k-within-w")
    assert front.max() <= K
    if case == "inside":
        assert front.max() <= W // 2 and front.min() > 256  # past the first round
    if case in ("exact", "k-within-w"):
        assert front.max() == W == min(W, K)
    if case == "past":
        assert sorted(front[front > W].tolist()) == [W + 3, K]
        assert done.sum() == len(done) - 2
    if case == "next0-past-w":
        assert next0 >= W and front.min() > W
    if case in ("negzero-tail", "inf-request"):
        assert T.tail_moves(used0, req, W) and front.max() <= W and not done.any()
    if case == "negzero-window":
        assert not T.tail_moves(used0, req, W) and done.all()
        assert np.signbit(used0[:W]).any()
    if case == "wrap":
        assert (outs[1].numpy() < 0).any() and done.all()  # a leftover below zero
    if case in ("inside", "exact", "wrap", "negzero-window"):
        assert done.all()


def test_element_frontiers():
    cfg = np.array([[0, -1, -1, -1], [0, -1, 3, -1], [-1, -1, -1, -1]])
    assert T.element_frontiers(cfg, 1).tolist() == [1, 3, 1]
    assert T.element_frontiers(cfg, 0).tolist() == [1, 3, 0]


def test_window_plan_branches():
    assert F.window_plan(1100, 2048, 1024) == "pick"  # the live slots reach past W
    assert F.window_plan(1024, 1024, 1024) == "pick"
    assert F.window_plan(5, 4096, 0) == "pick"  # no window at these shapes
    assert F.window_plan(60, 1024, 1024) == "window"  # Kp <= W
    assert F.window_plan(0, 64, 256) == "window"
    assert F.window_plan(151, 8192, 1024) == "both"
    assert F.window_plan(0, 2048, 512) == "both"


def test_window_layout_rule():
    """Two CTAs a SM at config 2's Cp 4096 (W 1024) and 8192 (W 512), R 6,
    S 2; no larger than K needs; none past the resident scan's limits."""
    assert F.window_layout(8192, 6, 2, 4096)[0] == 1024
    assert F.window_layout(8192, 6, 2, 8192)[0] == 512
    for K, R, S, C in ((8192, 6, 2, 4096), (8192, 6, 2, 8192), (2048, 3, 2, 304)):
        W, smem = F.window_layout(K, R, S, C)
        assert smem == F.window_smem(W, R, S, C)
        assert 2 * (smem + 1024) <= 233_472
    assert F.window_layout(64, 3, 2, 300)[0] == 256
    assert F.window_layout(300, 3, 2, 300)[0] == 512
    assert F.window_layout(64, 40, 2, 300) is None  # past MAX_AXES
    assert F.window_layout(64, 3, 2, 301) is None  # no cp.async size divides Cp
    # one a SM where two do not fit
    W, smem = F.window_layout(8192, 6, 2, 16384)
    assert 2 * (smem + 1024) > 233_472 and smem <= F.SMEM_PER_BLOCK


def test_batch_launches():
    assert F.batch_launches(151, 8192, 6, 2, 4096) == (
        "ffd_scan_window_batched", "ffd_scan_cluster_batched")
    assert F.batch_launches(100, 2048, 6, 2, 4096) == (
        "ffd_scan_window_batched", "ffd_scan_batched")
    assert F.batch_launches(60, 1024, 6, 1, 256) == ("ffd_scan_window_batched",)
    assert F.batch_launches(2000, 4096, 6, 2, 8192) == ("ffd_scan_cluster_batched",)
    assert F.batch_launches(4, 64, 200, 2, 300) == ("ffd_scan_global_batched",)
    # past one cluster (config 2 on 10,000 live nodes: Kp and Cp 16,384):
    # the grid's batch mode, alone where next0 passes W, after the window
    # where a small cluster's universe pods pad Kp to 16,384 ("both")
    assert F.batch_launches(10000, 16384, 6, 2, 16384) == ("ffd_scan_grid_batched",)
    assert F.batch_launches(100, 16384, 6, 2, 16384) == (
        "ffd_scan_window_batched", "ffd_scan_grid_batched")
    assert F.window_plan(100, 16384, F.window_layout(16384, 6, 2, 16384)[0]) == "both"


def test_batched_scan_on_the_cpu_is_the_plain_version():
    """On CPU tensors `ffd_scan_batch` is the plain version and launches
    nothing, whatever the plan at the shapes."""
    a = _torch(T.frontier_arrays("past"))
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     *_, cnt_b, rm_b, perm_b) = a
    chosen = P.choose_config_reference(req, maxper, feas, alloc, price, openable)
    args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
            cnt_b, rm_b, perm_b)
    before = dict(F.LAUNCHES)
    got = F.ffd_scan_batch(*args)
    assert F.LAUNCHES == before
    for x, y in zip(got, P.ffd_scan_batch_reference(*args)):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
