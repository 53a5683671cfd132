"""The roofline arithmetic copied into the benchmark against the bring-up
script's own functions on the same inputs.  Only this test reads the
script; the harness never imports it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks import harness as H
from benchmarks import inputs as I
from benchmarks.reference import solve as R

SCAN = H.load_module(H.BENCH / "roofline" / "ffd_scan.py")
ADMIT = H.load_module(H.BENCH / "roofline" / "admit_kernel.py")
CFG = H.load_json(H.BENCH / "configs" / "hetero300-live500.json")


@pytest.fixture(scope="module")
def problem():
    shapes = I.machine_shapes(**CFG["catalog"])
    rng = np.random.default_rng(7)
    nodes = I.live_cluster(dict(CFG["cluster"], nodes=40), CFG["pending"], shapes, rng)
    pods = I.config2_batch(dict(CFG["pending"], pods=600), rng, "p")
    cat = R.Catalog(shapes, CFG["pools"])
    _, prob, pk = R.solve(cat, pods, nodes)
    return prob, pk


def chip_smoke():
    import sys

    sys.path.insert(0, str(H.ROOT))
    import chip_smoke as cs

    return cs


def test_scan_bound_equals_kernel_bounds(problem):
    prob, pk = problem
    args, take, node_cfg = SCAN.pack_arrays(prob, pk)
    tensors = tuple(a if isinstance(a, int) else torch.from_numpy(np.ascontiguousarray(a))
                    for a in args)
    theirs = chip_smoke().kernel_bounds(tensors, torch.from_numpy(take),
                                        torch.from_numpy(node_cfg))["ffd_scan"]
    ours = SCAN.scan_bound(args, take, node_cfg)
    assert ours == theirs
    assert ours["bound_ms"] > 0


@pytest.mark.parametrize("g", [0, 5, -1])
def test_admit_bound_equals_the_scripts(problem, g):
    prob, _ = problem
    E = prob.E
    args = (prob.req, prob.cnt.astype(np.int32), prob.feas, prob.alloc, prob.openable,
            prob.used0, (prob.C + np.arange(E)).astype(np.int32))
    g = g % len(prob.classes)
    theirs = chip_smoke().admit_bound(tuple(torch.from_numpy(np.ascontiguousarray(a))
                                            for a in args), g)
    assert ADMIT.admit_bound(args, g) == theirs


def test_peaks_are_the_data_sheets():
    peaks = H.load_module(H.BENCH / "roofline" / "peaks.py")
    assert peaks.HBM_BYTES_PER_S == chip_smoke().HBM_BYTES_PER_S == 3.35e12
    assert peaks.F32_OPS_PER_S == chip_smoke().F32_OPS_PER_S
