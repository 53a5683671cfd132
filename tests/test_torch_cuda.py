"""The CUDA kernels against their plain PyTorch version, on the card.

Each scan case asserts which scan kernel the wrapper's shape rule launched:
the resident one up to the slot count whose state fits a block, the
cluster one above it (2, 4 or 8 CTAs), on the wrap case (int32 sums that
wrap) too, also with its prefilled slots straddling a CTA boundary; and
the global one through its own entry point.  The choice is held to the
plain version on its own cases: ties broken by first index, few classes,
6 configs and a ``feas`` one byte off (both read a config at a time).

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
