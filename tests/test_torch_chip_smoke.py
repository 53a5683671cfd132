"""chip_smoke.py on the CPU: it refuses to run without a card, the bound
it reports counts only what the run's data needs, each scan kernel's
latency floor follows that kernel's own step, and the kernels line has a
row for every kernel the wrappers count."""

import pathlib
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from karpenter_tpu_torch.ops import fused_packer


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=pathlib.Path(chip_smoke.__file__).parent,
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _tiny_pack():
    """Two classes, three slots, four configs, one axis.  Slot 0 is
    prefilled on config 2; class 0 opens slot 1, class 1 opens slot 2."""
    i32 = np.int32
    args = (
        np.array([[1.0], [2.0]], np.float32),  # req
        np.array([5, 6], i32),  # cnt
        np.array([9, 9], i32),  # maxper
        np.array([0, 0], i32),  # slot
        np.array([[1, 1, 1, 0], [0, 1, 0, 0]], bool),  # feas
        np.ones((4, 1), np.float32),  # alloc
        np.ones(4, np.float32),  # price
        np.array([1, 1, 0, 1], bool),  # openable
        np.zeros((3, 1), np.float32),  # used0
        np.array([2, -1, -1], i32),  # cfg0
        np.zeros(3, i32),  # npods0
        1,  # first free slot
        np.zeros((1, 3), i32),  # sig0
    )
    args = tuple(a if isinstance(a, int) else torch.from_numpy(a) for a in args)
    take = torch.tensor([[0, 5, 0], [1, 2, 3]], dtype=torch.int32)
    node_cfg = torch.tensor([2, 1, 1], dtype=torch.int32)
    return args, take, node_cfg


def test_bound_counts_what_the_data_needs():
    b = chip_smoke.kernel_bounds(*_tiny_pack())
    # choose_config: all of feas/openable/price/req/maxper, the alloc rows
    # of the two configs some class fits and may open, three outputs;
    # capacity + score for the three fitting (class, config) pairs
    assert b["choose_config"]["bytes"] == 8 + 4 + 16 + 8 + 8 + 2 * 4 + 3 * 2 * 4
    assert b["choose_config"]["operations"] == 3 * (4 + 4) + 2 * 2 * 4 + 4
    # ffd_scan: feas only at (class, config) pairs of open slots (class 0
    # sees slot 0; class 1 sees slots 0 and 1 on two configs), alloc and
    # signature counters only where the class fits, not all of feas [2, 4]
    class_in = 4 * (2 * 4) + 3 * 2 * 4
    gathered = 3 * 1 + 2 * 4 + 2 * 4
    slot_in = 3 * 3 * 4
    outs = 2 * 3 * 4 + 2 * 4 + 2 * 3 * 4 + 3 * 4
    assert b["ffd_scan"]["bytes"] == class_in + gathered + slot_in + outs
    # two fitting slots (capacity + prefix), four that take pods (update)
    assert b["ffd_scan"]["operations"] == 2 * (4 + 5) + 4 * (2 + 3)
    for k in b.values():
        assert k["bound_by"] == "bytes"
        assert k["bound_ms"] == k["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_scan_latency_floor():
    assert fused_packer.scan_threads(256) == 256
    assert fused_packer.scan_threads(5000) == 1024
    # the global kernel: a barrier after the req row, three per chunk of
    # its block scan, three in each block sum; two first-touch L2 loads
    assert chip_smoke.scan_step_model("ffd_scan_global", 256) == (10, 2)
    assert chip_smoke.scan_step_model("ffd_scan_global", 2048) == (13, 2)
    # the resident kernel: one barrier; two dependent L2 loads a tile of
    # class rows
    assert chip_smoke.scan_step_model("ffd_scan", 256) == (1, 2 / fused_packer.SCAN_TILE)
    floor = chip_smoke.scan_latency_floor_ms(
        "ffd_scan_global", 320, 256, barrier_us=0.02, l2_us=0.1)
    assert np.isclose(floor, 320 * (10 * 0.02 + 2 * 0.1) / 1e3)
    floor = chip_smoke.scan_latency_floor_ms("ffd_scan", 320, 256, barrier_us=0.02, l2_us=0.1)
    assert np.isclose(floor, 320 * (0.02 + 2 / 32 * 0.1) / 1e3)
    # the cluster kernel: the resident step, its one barrier a cluster
    # barrier (the caller passes that round trip)
    assert chip_smoke.scan_step_model("ffd_scan_cluster", 4096) == (
        1, 2 / fused_packer.SCAN_TILE)
    floor = chip_smoke.scan_latency_floor_ms(
        "ffd_scan_cluster", 320, 4096, barrier_us=0.5, l2_us=0.1)
    assert np.isclose(floor, 320 * (0.5 + 2 / 32 * 0.1) / 1e3)


def test_kernels_line_rows():
    """Four rows, one per counted kernel, the two big-slot scans at the live
    cluster; phase 4 times the cluster sizes the rule does not pick."""
    assert chip_smoke.KERNELS == (
        "choose_config", "ffd_scan", "ffd_scan_global", "ffd_scan_cluster")
    assert set(chip_smoke.KERNELS) == set(fused_packer.LAUNCHES)
    assert set(chip_smoke.ROW_PROBLEM) == set(chip_smoke.KERNELS)
    assert chip_smoke.ROW_PROBLEM["ffd_scan_cluster"] == "config2_live"
    assert chip_smoke.ROW_PROBLEM["ffd_scan_global"] == "config2_live"
    picked = fused_packer.cluster_layout(4096, 6, 2, 8192)[0]
    others = chip_smoke.other_cluster_sizes(4096, 6, 2, 8192)
    assert sorted(others + [picked]) == [2, 4, 8]
    assert chip_smoke.other_cluster_sizes(32768, 6, 2, 8192) == []


def test_phase5_churn_and_mirror_check():
    """Phase 5's delta tick on the CPU: `churn` replaces 1 % of the pods by
    new objects at the batch's end and grows the usage of live nodes; a
    delta solve packs from the resident tensors, `check_mirrors` passes on
    them and fails on a card tensor that drifted from its mirror; a
    `cold_solve` drops the warm state first."""
    import random

    import pytest

    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods = T.heterogeneous_problem(scale=0.05)  # 500 pods
    existing = T.live_cluster(20)
    rng = random.Random(0)
    out = chip_smoke.churn(rng, pods, existing)
    assert len(out) == len(pods)
    kept, new = out[: len(pods) - chip_smoke.DELTA_PODS], out[len(pods) - chip_smoke.DELTA_PODS:]
    assert {id(p) for p in kept} <= {id(p) for p in pods}
    assert not {id(p) for p in new} & {id(p) for p in pods}
    assert {p.class_key() for p in new} <= {p.class_key() for p in pods}
    assert len({p.name for p in out}) == len(out)
    assert sum(bool(sn.pods) for sn in existing) == chip_smoke.DELTA_NODES

    sched = TorchScheduler(pools, inv, existing=existing, device="cpu")
    sched.solve(pods)
    sched.solve(chip_smoke.churn(rng, pods, existing))
    assert sched.last_resident and sched.last_delta_rows > 0
    st = sched._resident.states[-1]
    chip_smoke.check_mirrors(torch, "cpu", st)
    st.d_used0[0, 0] += 1.0
    with pytest.raises(SystemExit):
        chip_smoke.check_mirrors(torch, "cpu", st)
    chip_smoke.cold_solve(sched, pods)
    assert sched.compile_cache_misses == 3 and sched.resident_rebuilds == 2
