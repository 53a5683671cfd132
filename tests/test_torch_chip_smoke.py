"""chip_smoke.py on the CPU: it refuses to run without a card, and the
bound it reports counts only what the run's data needs."""

import pathlib
import subprocess
import sys

import numpy as np
import torch

import chip_smoke


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
    assert chip_smoke.scan_threads(256) == 256
    assert chip_smoke.scan_threads(5000) == 1024
    assert chip_smoke.scan_barriers_per_step(256) == 10
    assert chip_smoke.scan_barriers_per_step(2048) == 13
    floor = chip_smoke.scan_latency_floor_ms(320, 256, barrier_us=0.02, l2_us=0.1)
    assert np.isclose(floor, 320 * (10 * 0.02 + 2 * 0.1) / 1e3)
