"""chip_smoke.py on the CPU: it refuses to run without a card, the bound
it reports counts only what the run's data needs, each scan kernel's
latency floor follows that kernel's own step, the kernels line has a
row for every kernel the wrappers count, ``--through N`` is parsed by a
plain function, and the ptxas summary is read per kernel."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
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
    # the grid kernel: the cluster step, its exchange the cluster barrier
    # and the round trip between clusters (the caller passes both as one);
    # each slot's feasibility byte is gathered a step ahead
    assert chip_smoke.scan_step_model("ffd_scan_grid", 32768) == (
        1, 2 / fused_packer.SCAN_TILE)


def test_kernels_line_rows():
    """A row per counted kernel: the solve's five (the grid scan measured
    on 20,000 live nodes), the two big-slot scans at the live cluster,
    then phase 6's eight (the batched scans, each at
    the problem whose shapes pick it, the frontier-window scan at phase
    9's base, `verdict_rows`' three launches and
    the prologue's at ``live``, those four in place of the JAX package's
    verdict epilogue and prologue), then phase 8's admission score, then
    phase 11's fleet launches (the choice and the picked scan at the config
    2 service cell, the cluster and global scans at the live cluster's
    tenants, all in place of the JAX package's ``fleet_pack_kernel``),
    then phase 15's mesh kernels (the feasibility expansion at the
    factorized step, the sharded pack's four at config 2 on the mesh: the
    choice, the one-launch scan, the pair);
    phase 4 times the cluster sizes the rule does not pick."""
    assert chip_smoke.KERNELS == (
        "choose_config", "ffd_scan", "ffd_scan_global", "ffd_scan_cluster", "ffd_scan_grid",
        "ffd_scan_batched", "ffd_scan_cluster_batched", "ffd_scan_global_batched",
        "ffd_scan_window_batched", "ffd_scan_grid_batched", "verdict_summary",
        "verdict_configs", "verdict_write", "population_pairs", "admit_kernel",
        "choose_config_fleet", "ffd_scan_fleet", "ffd_scan_cluster_fleet",
        "ffd_scan_global_fleet", "ffd_scan_grid_fleet", "assemble_feasibility",
        "choose_config_shard", "ffd_shard_scan", "ffd_shard_cap", "ffd_shard_apply")
    assert chip_smoke.KERNELS[-10:-5] == chip_smoke.FLEET_KERNELS
    assert chip_smoke.KERNELS[-5:] == chip_smoke.MESH_KERNELS
    assert chip_smoke.MESH_KERNELS[-2:] == chip_smoke.MESH_PAIR
    assert chip_smoke.ROW_PROBLEM["ffd_shard_cap"] == "config2_mesh"
    assert chip_smoke.ROW_PROBLEM["ffd_shard_scan"] == "config2_mesh"
    assert chip_smoke.FLEET_REPLACES == "karpenter_tpu/ops/packer.py:930"
    assert chip_smoke.ROW_PROBLEM["ffd_scan_fleet"] == "service-16-config2"
    assert chip_smoke.ROW_PROBLEM["ffd_scan_window_batched"] == "consolidation"
    assert chip_smoke.ROW_PROBLEM["admit_kernel"] == "arrivals"
    assert chip_smoke.ADMIT_REPLACES == "karpenter_tpu/ops/packer.py:197"
    assert set(chip_smoke.KERNELS) == set(fused_packer.LAUNCHES)
    assert chip_smoke.VERDICT_ROWS == fused_packer.VERDICT_ROWS_LAUNCHES
    assert set(chip_smoke.ROW_PROBLEM) == set(chip_smoke.KERNELS)
    assert set(chip_smoke.VERDICT_REPLACES) == set(chip_smoke.VERDICT_KERNELS)
    for k, fn in chip_smoke.VERDICT_FUNCTION.items():
        assert chip_smoke.ROW_PROBLEM[k] == "live"
        assert chip_smoke.VERDICT_REPLACES[k] == (
            "karpenter_tpu/ops/packer.py:525" if fn == "verdict_rows"
            else "karpenter_tpu/ops/packer.py:686")
    assert set(chip_smoke.SPILL_CHECKED) == {"choose_config", "ffd_scan_window",
                                             *chip_smoke.VERDICT_FUNCTION, "admit",
                                             "ffd_scan_grid"}
    assert chip_smoke.ROW_PROBLEM["ffd_scan_cluster"] == "config2_live"
    assert chip_smoke.ROW_PROBLEM["ffd_scan_global"] == "config2_live"
    assert chip_smoke.ROW_PROBLEM["ffd_scan_grid"] == "config2_live20k"
    # the grid's batch and fleet modes: at the verdicts' and the fleet's
    # problems past one cluster (config 2's catalog on 10,000 live nodes)
    assert chip_smoke.VERDICT_SCAN["live10k"] == "ffd_scan_grid"
    assert chip_smoke.ROW_PROBLEM["ffd_scan_grid_batched"] == "live10k"
    assert chip_smoke.ROW_PROBLEM["ffd_scan_grid_fleet"] == "fleet_live10k"
    assert chip_smoke.VERDICT_REPLACES["ffd_scan_grid_batched"] == "karpenter_tpu/ops/packer.py:615"
    assert set(chip_smoke.TIMED_VERDICTS) == set(chip_smoke.VERDICT_SCAN) == set(
        chip_smoke.POPULATION)
    assert chip_smoke.TIMED_VERDICTS["live10k"] < chip_smoke.TIMED_VERDICTS["live"]
    # live10k's CPU drives, both objectives, run in spawned processes
    assert chip_smoke.VERDICT_TWINNED == ("live10k",)
    assert chip_smoke.FLEET_GRID == (("config2_live10k", 4), ("config2_live10k", 16),
                                     ("config2_live20k", 4))
    assert {name for name, _ in chip_smoke.FLEET_GRID} == set(chip_smoke.LARGE_LIVE)
    assert set(chip_smoke.LARGE_LIVE) < set(chip_smoke.PHASE5_SCAN)
    assert {chip_smoke.PHASE5_SCAN[n] for n in chip_smoke.LARGE_LIVE} == {"ffd_scan_grid"}
    for name, scan in chip_smoke.VERDICT_SCAN.items():
        assert chip_smoke.ROW_PROBLEM[f"{scan}_batched"] == name
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


@pytest.mark.parametrize("argv,through", [
    ([], chip_smoke.LAST_PHASE),
    (["--through", "1"], 1),
    (["--through", "3"], 3),
    (["--through", "4"], 4),
    (["--through", "5"], 5),
    (["--through", "6"], 6),
    (["--through", "7"], 7),
    (["--through", "8"], 8),
    (["--through", "9"], 9),
    (["--through", "10"], 10),
    (["--through", "11"], 11),
    (["--through", "12"], 12),
    (["--through", "13"], 13),
    (["--through", "14"], 14),
    (["--through", "15"], 15),
    (["--through", "16"], 16),
    (["--through", "17"], 17),
], ids=[  # the first eight as they were named while the last phase was 9
    "argv0-9", "argv1-1", "argv2-3", "argv3-4", "argv4-5", "argv5-6", "argv6-7", "argv7-8",
    "argv8-9", "argv9-10", "argv10-11", "argv11-12", "argv12-13", "argv13-14", "argv14-15",
    "argv15-16", "argv16-17"])
def test_through_parses(argv, through):
    assert chip_smoke.parse_through(argv) == through


@pytest.mark.parametrize("argv", [
    ["--through"], ["--through", "0"], ["--through", "18"], ["--through", "x"],
    ["--through", "2", "3"], ["--thru", "2"], ["3"],
])
def test_through_refuses_bad_values(argv):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.parse_through(argv)
    assert exc.value.code == 2


def test_partial_run_exits_3(capsys):
    chip_smoke.phase_done(2, 3)  # phase 2 of a run through 3: goes on
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase_done(3, 3)
    assert exc.value.code == 3
    err = capsys.readouterr()
    assert "chip_smoke: stopped after phase 3 (partial run)" in err.err
    assert '"ok"' not in err.out


def test_bad_argument_exits_2_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--through", "18"],
        cwd=pathlib.Path(chip_smoke.__file__).parent,
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 2
    assert '"ok"' not in proc.stdout


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120choose_config_kernelILb1EEEvPKfPKiPKhS2_S2_S6_iiiiPiS7_S7_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120choose_config_kernelILb1EEEvPKfPKiPKhS2_S2_S6_iiiiPiS7_S7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Function properties for __internal_fdiv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115ffd_scan_kernelILi1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115ffd_scan_kernelILi1EEEvPKf
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 424 bytes cmem[0]
"""


def test_ptxas_resources_per_kernel():
    got = chip_smoke.ptxas_resources(PTXAS_LOG)
    assert got == {
        "_ZN12_GLOBAL__N_120choose_config_kernelILb1EEEvPKfPKiPKhS2_S2_S6_iiiiPiS7_S7_": (54, 0, 0),
        "_ZN12_GLOBAL__N_115ffd_scan_kernelILi1EEEvPKf": (40, 12, 8),
    }


def _tiny_batch():
    """`_tiny_pack` as one element of a batch: its own class order, its
    counts, nothing removed; with the scan's outputs."""
    from karpenter_tpu_torch.ops import packer as P

    args, take, node_cfg = _tiny_pack()
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = P.choose_config_reference(req, maxper, feas, alloc, price, openable)
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt[None], torch.zeros((1, 3), dtype=torch.bool),
                 torch.arange(2, dtype=torch.int32)[None])
    outs = P.ffd_scan_batch_reference(*scan_args)
    return args, take, node_cfg, scan_args, outs


def test_batched_bound_is_the_scan_bound_per_element():
    """Phase 6's batched-scan bound of one element in base order counts the
    operations of the scan's bound, and its bytes plus the element's class
    order and removal row."""
    args, _, _, scan_args, outs = _tiny_batch()
    one = chip_smoke.kernel_bounds(args, outs[0][0], outs[2][0])["ffd_scan"]
    b = chip_smoke.batched_scan_bound(torch, scan_args, outs)
    assert b["operations"] == one["operations"]
    assert b["bytes"] == one["bytes"] + 3 * 1 + 2 * 4  # rm_b [1, K] bool, perm_b [1, G]
    assert b["bound_ms"] == b["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3


def test_verdict_bounds_count_the_run():
    from karpenter_tpu_torch.ops import packer as P

    args, _, _, scan_args, outs = _tiny_batch()
    feas, alloc, price, openable = args[4:8]
    ids = torch.zeros(4, dtype=torch.int32)
    tail = (scan_args[15], feas, alloc, price, openable, ids, ids, ids,
            torch.ones(2, dtype=torch.bool), 1)
    rows = P.verdict_rows_reference(*outs, *tail)
    assert rows[0, P.RV_NEW_COUNT] == 2  # slots 1 and 2 open, class 0 on them
    b = chip_smoke.verdict_rows_bound(torch, outs, tail, rows)
    # B 1, G 2, K 3, C 4, R 1: leftovers, pod counts of slots 1-2, k_star's
    # config, take columns and usage rows of 2 new slots + k_star, the class
    # order, class 0's feasibility row, the config arrays, compactable, the row
    assert b["bytes"] == 8 + 2 * 4 + 4 + 3 * (2 + 1) * 4 + 8 + 4 + 4 * (4 + 4 + 1 + 12) + 2 + 24
    # operations as the data needs them: the slack adds (C x R), the
    # openable test and key compares of each pair (4 x C), the fit, class
    # and argmin tests at the 3 openable configs of c_star's key (R + 1
    # class on k_star + 2 each), the hold tests at the 3 openable configs
    # (the row reads hold: 2 new slots, no non-donor; R + 1 class + 1
    # each), the window's 2 slot tests and a class test per new slot
    configs_ops = 4 * 1 + 4 * 4 + 3 * (1 + 1 + 2) + 3 * (1 + 1 + 1)
    assert b["operations"] == configs_ops + 2 + 2 * 2
    # the launches' shares: per-element reads and slot tests, the config
    # arrays and feasibility row with the per-config tests, the row
    parts = b["parts"]
    assert list(parts) == list(chip_smoke.VERDICT_ROWS)
    assert parts["verdict_summary"]["bytes"] == 8 + 2 * 4 + 4 + 3 * (2 + 1) * 4 + 8 + 2
    assert parts["verdict_summary"]["operations"] == 2 + 2 * 2
    assert parts["verdict_configs"]["bytes"] == 4 + 4 * (4 + 4 + 1 + 12)
    assert parts["verdict_configs"]["operations"] == configs_ops
    # two pools, c_star's openable in one config; class 0 not compactable:
    # both new slots are non-donors, the row reads no hold, no hold tests
    pools = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    other = (tail[0], feas, alloc, price, openable, pools, ids, ids,
             torch.tensor([False, True]), 1)
    b = chip_smoke.verdict_rows_bound(torch, outs, other, P.verdict_rows_reference(*outs, *other))
    assert b["parts"]["verdict_configs"]["operations"] == 4 * 1 + 4 * 4 + 1 * (1 + 1 + 2)
    assert parts["verdict_write"] == chip_smoke._bound(24, 0)
    assert sum(v["bytes"] for v in parts.values()) == b["bytes"]
    pop = (torch.tensor([[1, 0], [2, 1]], dtype=torch.int32), torch.tensor([0, 3], dtype=torch.int32),
           torch.tensor([[0, 2**29], [4, 5]], dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32),
           9, torch.tensor([[True, True], [False, True]]), 3)
    cnt_b, rm_b, perm_b = P.population_prologue_reference(*pop)
    assert perm_b.tolist() == [[1, 0], [1, 0]] and cnt_b.tolist() == [[1, 3], [1, 2]]
    assert rm_b.tolist() == [[True, False, False], [False, False, False]]
    b = chip_smoke.prologue_bound(pop, (cnt_b, rm_b, perm_b))
    assert b["bytes"] == 4 + 16 + 16 + 8 + 8 + (16 + 6 + 16)
    assert b["operations"] == 3 * 2 * 2 + 2 * 2 * 2 + 3


def test_phase6_drive_on_the_cpu():
    """Phase 6's drive at a small sweep on the CPU: the removal batch and
    each round of a plan pass go through the verdict entry points, and
    `verdict_inputs`' removal batch is the one the entry point built."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, existing, cands = T.consolidation_sweep(pods=80)
    spec = dict(pools=pools, inventory=inv, existing=existing, universe=cands,
                subsets=[[c] for c in cands], population=16,
                prices=T.node_prices(existing, inv))
    sched = TorchScheduler(pools, inv, existing=existing, device="cpu")
    removals, rounds, best, calls = chip_smoke.drive_verdicts(sched, spec)
    assert len(removals) == len(cands)
    assert [c[0] for c in calls] == ["evaluate_removals"] + ["evaluate_population"] * len(rounds)
    assert 1 <= len(rounds) <= chip_smoke.SEARCH_ROUNDS
    assert all(len(keys) == len(vs) for keys, vs in rounds)
    masks = chip_smoke.key_masks(rounds[0][0], len(cands))
    assert masks.sum(1).tolist() == [len(k) for k in rounds[0][0]]


def test_timed_in_turns_order(monkeypatch):
    """The scans past one cluster are read in turns: the first run, the
    others, the others again in reverse, the first again; each run's
    figure is the mean of its two readings."""
    order = []

    def fake_ms(torch_, fn, iters, warmup=3):
        order.append(fn())
        return float(len(order))

    monkeypatch.setattr(chip_smoke, "cuda_ms", fake_ms)
    runs = {k: (lambda k=k: k) for k in ("global", "grid", "third")}
    got = chip_smoke.timed_in_turns(torch, runs, 3)
    assert order == ["global", "grid", "third", "third", "grid", "global"]
    assert got == {"global": 3.5, "grid": 3.5, "third": 3.5}
    order.clear()
    got = chip_smoke.timed_in_turns(torch, {k: runs[k] for k in ("global", "grid")}, 3)
    assert order == ["global", "grid", "grid", "global"] and got == {"global": 2.5, "grid": 2.5}


def test_phase7_tick_summary():
    """Phase 7's line a tick: seconds become ms, a tick that solved nothing
    carries no kernel and no phases, launches that did not happen drop out,
    and the observatory's section and breakdown merge; `tick_p50s` groups
    the ticks by the kind of their solve."""
    section = {"compiles": 1, "warm_recompiles": 0, "dispatches": 2, "transfer_bytes": 64,
               "resident_bytes": 128, "resident_delta_bytes": 128}
    detail = {"dispatches": {"ffd_pack": 1, "resident_delta": 1}, "compiles": {"ffd_pack": 1},
              "transfer_bytes": {"resident_seed": 64}, "resident_updates": {"seed": 1}}
    t = chip_smoke.tick_summary(
        4, "cold", 0.25, {"provisioner": 0.2, "link": 0.001},
        {"compile": 0.1, "decode": 0.05}, "cuda_ffd", section, detail,
        {"choose_config": 1, "ffd_scan": 1, "ffd_scan_cluster": 0})
    assert t["tick"] == 4 and t["solve"] == "cold" and t["kernel"] == "cuda_ffd"
    assert t["tick_ms"] == 250.0
    assert t["controllers_ms"] == {"provisioner": 200.0, "link": 1.0}
    assert t["phases_ms"] == {"compile": 100.0, "decode": 50.0}
    assert t["launches"] == {"choose_config": 1, "ffd_scan": 1}
    assert t["device"]["transfer_bytes"] == {"resident_seed": 64}
    assert t["device"]["resident_bytes"] == 128 and t["gc_ms"] == 0.0
    timer = chip_smoke.GcTimer()
    timer("start", {})
    timer("stop", {})
    assert timer.ms >= 0.0
    assert chip_smoke.tick_summary(1, "", 0.001, {}, {}, "", section, detail, {},
                                   gc_ms=2.5)["gc_ms"] == 2.5
    idle = chip_smoke.tick_summary(5, "", 0.002, {}, {"compile": 0.1}, "cuda_ffd",
                                   section, detail, {})
    assert idle["kernel"] == "" and idle["phases_ms"] == {} and idle["launches"] == {}
    p50s = chip_smoke.tick_p50s([t, idle, {**t, "tick_ms": 150.0}])
    assert p50s == {"cold": {"p50_ms": 200.0, "ticks": 2},
                    "none": {"p50_ms": idle["tick_ms"], "ticks": 1}}


def test_phase7_drive_on_the_cpu():
    """Phase 7's drive at a small size on the CPU: every pod binds, the
    churn rounds replace bound pods by new ones of their shapes and each
    round's batch is solved, no controller fails, every tick's line reads
    the operator's clocks and the observatory, and a second drive reaches
    the same `testing.operator_state`, the state the card's run is held to."""
    from karpenter_tpu_torch import testing as T

    env, ticks, _ = chip_smoke.drive_operator("cpu", n_pods=120, rounds=2, churn_pods=10)
    assert not env.kube.pending_pods() and len(env.kube.pods) == 120
    assert all(p.node_name for p in env.kube.pods.values())
    solves = [t for t in ticks if t["solve"]]
    assert len(solves) == 3  # the 120 pods, then each round's 10
    assert all(t["kernel"] == "reference" and t["phases_ms"] for t in solves)
    assert solves[0]["device"]["dispatches"] == {"ffd_pack": 1}
    assert solves[0]["device"]["resident_updates"] == {"seed": 1}
    assert solves[0]["device"]["transfer_bytes"]["resident_seed"] > 0
    for t in ticks:
        assert set(t["controllers_ms"]) == set(chip_smoke.CONTROLLERS)
        assert t["tick_ms"] > 0 and t["launches"] == {}
    # pod-0 ... pod-119 went in first; the rounds' 20 replacements follow
    # (round 2 may replace some of round 1's)
    later = sorted(int(p.name.split("-")[1]) for p in env.kube.pods.values()
                   if int(p.name.split("-")[1]) >= 120)
    assert 10 <= len(later) <= 20 and later[-1] == 139
    again, ticks2, _ = chip_smoke.drive_operator("cpu", n_pods=120, rounds=2, churn_pods=10)
    assert [t["solve"] for t in ticks2] == [t["solve"] for t in ticks]
    assert T.operator_state(again) == T.operator_state(env)



def test_phase8_drive_on_the_cpu():
    """Phase 8's drive at a small size on the CPU: the batch's first tick
    is too large a burst for the fast path; after it binds and 30 % of its
    pods are deleted, the first single arrival falls back (the resident
    tensors cannot absorb the whole batch leaving) and the next ones are
    nominated by the fast path; the oversized pod falls back to the
    batched solve and gets a node of its own; `AdmitTimer` records each
    attempt with its phases; the same drive with the fast path off puts
    every pod on the same node, and so does a drive cut to its first
    entries at that tick.  (At this size the single-pod solve's resident
    state has too few slots for a burst, which falls back as a resident
    miss.)"""
    from karpenter_tpu_torch import testing as T

    kw = dict(n_pods=120, arrivals=12, bursts=2, oversized=1)
    with chip_smoke.AdmitTimer() as timer:
        env, ticks = chip_smoke.drive_arrivals("cpu", **kw)
    counts = chip_smoke.fastpath_counts(env.registry)
    assert counts["mismatch"] == 0 and "mismatch" not in counts["outcome"]
    assert counts["outcome"]["nominated"] == 11, counts
    seen = [(c["outcome"], c["reason"]) for c in timer.calls]
    assert seen[:3] == [("fallback", "burst_too_large"), ("fallback", "resident_miss"),
                        ("nominated", "")]
    assert seen[-1] == ("fallback", "needs_new_node")
    assert [t["arrival"] for t in ticks if t["arrival"] != "batch"] == (
        ["single"] * 12 + ["burst", "quiet"] * 2 + ["oversized"])
    assert ticks[-1]["solve"] and ticks[-1]["fastpath"] == {"fallback": 1}
    assert len(timer.calls) == sum(counts["outcome"].values())
    scored = [c for c in timer.calls if "dispatch" in c["phases_ms"]]
    assert {"delta", "dispatch", "device_block", "oracle"} <= set(scored[0]["phases_ms"])
    assert all(c["ms"] >= sum(c["phases_ms"].values()) for c in timer.calls)
    big = env.kube.pods["default/oversized-0"]
    assert big.requests.cpu >= chip_smoke.OVERSIZED_CPU and big.node_name
    assert sum(1 for p in env.kube.pods.values() if p.node_name == big.node_name) == 1
    off, _ = chip_smoke.drive_arrivals("cpu", fastpath=False, **kw)
    assert not chip_smoke.fastpath_counts(off.registry)["outcome"]
    placed = lambda e: {k: p.node_name for k, p in sorted(e.kube.pods.items())}
    assert placed(off) == placed(env)
    again, _ = chip_smoke.drive_arrivals("cpu", **kw)
    assert T.operator_state(again) == T.operator_state(env)
    batch = [k for k in env.kube.pods if k.startswith("default/pod-")]
    assert len(batch) == 120 - int(120 * chip_smoke.HEADROOM_SHARE)
    # the cut drive equals the full drive's state at the cut's tick
    at = {}
    full, _ = chip_smoke.drive_arrivals(
        "cpu", **kw, cut=14, at_cut=lambda e: at.update(state=T.operator_state(e)))
    short, short_ticks = chip_smoke.drive_arrivals("cpu", **kw, cut=14, stop_at_cut=True)
    assert [t["arrival"] for t in short_ticks][-1] != "settle"
    assert T.operator_state(short) == at["state"]
    assert chip_smoke.fastpath_outcomes(short.registry) <= chip_smoke.fastpath_outcomes(
        full.registry)


def test_phase8_arrival_plan_interleaves_every_kind():
    """The arrival mix is the docstring's (200 singles, 10 bursts each with
    a quiet tick, 5 oversized pods) and its first `ARRIVAL_CUT` entries
    hold singles, bursts and an oversized pod."""
    from karpenter_tpu_torch import testing as T

    plan = chip_smoke.arrival_plan(T.heterogeneous_pods(100), lambda: 10.0)
    kinds = [k for k, _ in plan]
    assert (kinds.count("single"), kinds.count("burst"), kinds.count("quiet"),
            kinds.count("oversized")) == (200, 10, 10, 5)
    head = kinds[:chip_smoke.ARRIVAL_CUT]
    assert {"single", "burst", "quiet", "oversized"} <= set(head)
    assert all(2 <= len(pods) <= 8 for k, pods in plan if k == "burst")
    big = [new() for k, new in plan if k == "oversized"]
    assert all(p[0].requests.cpu >= chip_smoke.OVERSIZED_CPU for p in big)


def test_phase9_drive_on_the_cpu():
    """Phase 9's drive at a small size on the CPU: consolidation acts, the
    drive stops after `CONSOLIDATION_QUIET` quiet ticks with every pod
    bound, each tick's line carries its actions and the ledger's
    disruption events, and a second drive reaches the same events and
    `testing.operator_state`."""
    from karpenter_tpu_torch import testing as T

    env, before, ticks, events, profiled = chip_smoke.drive_consolidation("cpu", n_pods=600)
    assert profiled == [] and not env.kube.pending_pods()
    assert sum(t["actions"] for t in ticks) >= 1
    assert all(not t["actions"] for t in ticks[-chip_smoke.CONSOLIDATION_QUIET:])
    assert chip_smoke.live_fleet(env)["nodes"] < before["nodes"]
    assert sum(t["disrupted"] for t in ticks) == sum(1 for e in events if e[1] == "NodeDisrupted")
    assert all(set(t["controllers_ms"]) == set(chip_smoke.CONTROLLERS) for t in ticks)
    assert any(t["speculation"].get("adopted") for t in ticks)
    again, _, ticks2, events2, _ = chip_smoke.drive_consolidation("cpu", n_pods=600)
    assert events2 == events and len(ticks2) == len(ticks)
    assert T.operator_state(again) == T.operator_state(env)


def test_phase8_admit_helpers():
    """`admit_bound` counts the class's slots and configs from the data,
    the latency floor counts the kernel's barriers and load rounds at the
    block `admit_layout` gives, `percentiles` reads p50 and p99 by nearest
    rank, `admit_args` picks the score's inputs out of a pack's
    arguments."""
    args, _, _ = _tiny_pack()
    got = chip_smoke.admit_args(args)
    assert [a.shape for a in got] == [(2, 1), (2,), (2, 4), (4, 1), (4,), (3, 1), (3,)]
    b = chip_smoke.admit_bound(got, 0)
    # class 0 requests its one axis; slot 0 (config 2, feasible) is the one
    # slot it may use; config 0 fits and is openable, so the sweep stops
    # there: feasibility bytes at configs 2 and 0, openable at config 0
    assert b["bytes"] == 4 + 4 + 3 * 4 + 2 + 1 + 1 * 8 + 1 * 4 + 5 * 4
    assert b["operations"] == 1 * (5 + 3) + 1 * (4 + 1)
    assert b["bound_by"] == "bytes"
    # class 1: slot 0's config 2 not feasible; config 1 is feasible and
    # openable but too small, so no config fits and all four are swept
    b1 = chip_smoke.admit_bound(got, 1)
    assert b1["bytes"] == 4 + 4 + 3 * 4 + 4 + 1 + 1 * 4 + 5 * 4
    assert b1["operations"] == 1 * (4 + 1)
    # the floor's chain: 2 barriers, 2 load rounds, one more for each
    # further group of 2 slot rounds that holds a live slot
    from karpenter_tpu_torch.ops.fused_packer import admit_threads

    assert (chip_smoke.ADMIT_BARRIERS, chip_smoke.ADMIT_FIXED_LOADS) == (2, 2)
    assert admit_threads(256, 4096) == 512  # phase 8's resident state: 1 slot round
    assert admit_threads(4096, 8192) == 512  # the live cluster: 8 slot rounds
    assert admit_threads(16384, 512) == 512  # 32 slot rounds: staged
    assert admit_threads(0, 0) == 128 and admit_threads(1000, 300) == 256
    assert admit_threads(256, 512) == 128  # the edge cases' shape
    assert admit_threads(256, 20000) == 512
    assert [chip_smoke.admit_loads(K, C, n) for K, C, n in
            ((256, 4096, 150), (4096, 8192, 2000), (4096, 8192, 0), (4096, 8192, 4096))] \
        == [2, 3, 2, 5]
    p = chip_smoke.percentiles([float(x) for x in range(1, 101)])
    assert p == {"n": 100, "p50": 50.5, "p99": 100.0}
    assert chip_smoke.percentiles([]) == {"n": 0}


def test_phase7_tail_timer():
    """`TailTimer` times the operator's diagnosis tail and its SLO
    evaluation, anomaly scan and flight record, one entry a tick, and phase
    7's tick line carries it."""
    from karpenter_tpu_torch.api import Pod, Resources
    from karpenter_tpu_torch.testing import Environment

    env = Environment(device="cpu")
    env.default_node_class()
    env.default_node_pool()
    timer = chip_smoke.TailTimer(env.operator)
    env.kube.put_pod(Pod(requests=Resources(cpu=0.5, memory="1Gi")))
    t = chip_smoke.operator_tick(env, 1, tail=timer)
    chip_smoke.operator_tick(env, 2, tail=timer)
    assert len(timer.ticks) == 2 and env.operator.flight.dump_lines()[1:]
    for tick in timer.ticks:
        assert set(tick) == {"tail", "slo", "detect", "flight"}
        assert tick["tail"] >= tick["slo"] + tick["detect"] + tick["flight"] > 0
    assert t["tail_ms"] == timer.ticks[0]


def test_phase10_sim_run_on_the_cpu():
    """Phase 10's reading of one scenario on the CPU: the trace and the
    report, the figures it prints, and the checks it holds an anchor to;
    a second run writes the same trace."""
    run = chip_smoke.sim_run("anchor-6600-density-smoke", 1, 12, "cpu")
    assert run["trace"].splitlines()[0].startswith('{"')
    assert run["violations"] == [] and run["nodes"] == 2 and run["pods"] == 220
    assert run["settle_budget_s"] == 600.0 and 0.0 <= run["settle_s"] <= 600.0
    assert run["ticks"]["n"] > 12 and run["price_per_hour"] > 0
    assert "trace" not in chip_smoke.sim_line(run)
    chip_smoke.sim_checks("anchor-6600-density-smoke", run)
    with pytest.raises(SystemExit):
        chip_smoke.sim_checks("anchor-6600-density", run)  # 2 nodes, not 60
    assert chip_smoke.sim_run("anchor-6600-density-smoke", 1, 12, "cpu")["trace"] == run["trace"]
    assert [c[0] for c in chip_smoke.SIM_CELLS][-2:] == list(chip_smoke.ANCHOR_NODES)


def test_phase11_service_cell_on_the_cpu():
    """Phase 11's cell at a small size on the CPU: four bench tenants of 24
    pods in one solve group, their bursts through the multi-tenant server
    equal to the sidecar's answers, the batched path taken, the rounds
    timed and the pool's bytes read."""
    probs = chip_smoke.bench_tenants(4, 24)
    r = chip_smoke.service_cell("bench-small", probs, "cpu", rounds=2)
    assert r["mismatches"] == 0 and r["batched"] > 0
    assert r["info"] == {"platform": "cpu", "device_count": 1, "multi_tenant": True}
    assert len(r["concurrent_ms"]) == len(r["sequential_ms"]) == 2
    assert r["speedup_vs_sidecars"] > 0 and r["pool_bytes"] > 0
    assert max(r["batch_sizes"]) >= 2


def test_phase11_config2_tenants_form_one_group():
    """Config 2's fleet cell: its tenants (seeded 95 % subsets) compile to
    one solve group at config 2's shapes; tenants of other shapes fail the
    phase instead of running solo."""
    probs = chip_smoke.config2_tenants(4)
    key = chip_smoke.one_group("service-16-config2", probs)
    assert key[:2] == (256, "nodes") and key[2] == ((320, 6), "<f4")
    mixed = dict(probs, other=next(iter(chip_smoke.bench_tenants(1, 8).values())))
    with pytest.raises(SystemExit):
        chip_smoke.one_group("mixed", mixed)


def test_phase12_drive_on_the_cpu():
    """Phase 12's drive at a small size on the CPU: both clients negotiate
    bin1, A binds the pods and churns, B takes over after A's crash and
    launches nothing for A's pods, A leads again after B's release; every
    launch from the round's leader; the summary reads the failover, the
    compile caches, the flush and sync times and the store plane; a second
    drive gives the same readings, what the card's run is held to."""
    h = chip_smoke.ha_harness("cpu")
    try:
        marks = chip_smoke.ha_run(h, n_pods=200, churn_rounds=(1, 1, 1), churn_pods=10)
        s = chip_smoke.ha_summary(h, marks)
        plane = chip_smoke.store_plane(h)
        first = chip_smoke.ha_readings(h)
    finally:
        h.close()
    assert {t["term"] for t in h.ticks} == {"A1", "B1", "A2"}
    assert s["failover"]["rounds"] >= 1 and s["failover"]["sim_s"] > 15.0
    assert s["failover"]["b_first_solve"]["kind"] == "cold"
    assert s["failover"]["a_second_term_first_solve"]["round"] > marks["crash_round"]
    assert set(s["compile_cache"]) == {"replica-a", "replica-b"}
    assert s["wait_synced_ms"]["p50"] >= 0 and s["flush_ms"]["replica-b"]["p50"] > 0
    for name in ("replica-a", "replica-b"):
        assert plane[name]["rpcs"]["lease_acquire"]["n"] >= 1
        assert set(plane[name]["bytes_sent"]) == {"bin1", "json"}
    assert plane["server"]["requests"]["put"] >= 200
    h2 = chip_smoke.ha_harness("cpu")
    try:
        chip_smoke.ha_run(h2, n_pods=200, churn_rounds=(1, 1, 1), churn_pods=10)
        assert chip_smoke.ha_readings(h2) == first
    finally:
        h2.close()


def test_phase12_attribution_check():
    """A launch by a replica that did not lead its round, two leaders in a
    round, or a claim launched twice fails the drive's checks
    (`testing.ha_attribution`, which phase 12's `ha_run` runs)."""
    from karpenter_tpu_torch import testing as T

    ticks = [{"round": 1, "replica": "replica-a", "led": True},
             {"round": 1, "replica": "replica-b", "led": False},
             {"round": 2, "replica": "replica-b", "led": True}]
    T.ha_attribution(ticks, [(1, "replica-a", "c1"), (2, "replica-b", "c2")])
    for launches in ([(1, "replica-b", "c1")], [(1, "replica-a", "c1"), (2, "replica-b", "c1")],
                     [(3, "replica-a", "c3")]):
        with pytest.raises(AssertionError):
            T.ha_attribution(ticks, launches)
    with pytest.raises(AssertionError):
        T.ha_attribution(ticks + [{"round": 2, "replica": "replica-a", "led": True}], [])


def test_phase12_flush_timer():
    """The harness times each client's ``_flush_dirty`` by wrapping the
    method on the client: a call a lease operation, summed into the tick
    that made it."""
    from karpenter_tpu_torch import testing as T

    h = chip_smoke.ha_harness("cpu")
    try:
        for name, kube in h.kubes.items():
            assert kube._flush_dirty.__name__ == "timed_flush"
            assert h.flush_ms[name] == []
        recs = h.round()
        assert [r["replica"] for r in recs] == list(T.HA_REPLICAS)
        for r in recs:
            assert h.flush_ms[r["replica"]] and r["flush_ms"] == pytest.approx(
                sum(h.flush_ms[r["replica"]]))
        h.ops["replica-a"].elector.release()
        assert len(h.flush_ms["replica-a"]) == 2
    finally:
        h.close()


def test_phase13_scaled_fleet_on_the_cpu():
    """Phase 13's scaled cell at a small size on the CPU: ``solver-fleet``
    over config 2's catalog with its two pools and 200 of its pods put
    through op-0's client before tick 0, 3 operators, 6 ticks; no double
    launch, no violation, no refusal; the probe reads every operator's
    flushes, each new leader's first remote solve with the tenant tensors
    the service uploaded for it, and the ticks from each crash to the next
    nomination; a trace and launch list unequal to the twin's fail the
    checks."""
    run = chip_smoke.fleet_run("solver-fleet", 0, 6, 3, "cpu", n_pods=200)
    assert run["violations"] == [] and run["double_launches"] == 0 and run["refused"] == 0
    assert run["report"]["operators"] == 3 and run["launches"]
    assert set(run["flush_ms"]) == {"op-0", "op-1", "op-2"}
    assert all(f["n"] >= 1 and f["p50"] > 0 for f in run["flush_ms"].values())
    assert run["ticks"]["n"] >= 6 and run["kernel_launches"] == {}
    first = run["first_solves"]
    assert first and first[0]["uploaded"]["tenant_resident"] > 0
    # a first solve is one that follows another replica's
    assert all(a["replica"] != b["replica"] for a, b in zip(first, first[1:]))
    assert sum(run["solves_by_tenant"].values()) >= len(first)
    assert run["crash_rounds"] and all(r is not None and r >= 0 for r in run["crash_rounds"])
    # the cell's pods went in before tick 0: the first solve placed them
    trace = [json.loads(line) for line in run["trace"].splitlines()]
    assert trace[0]["fleet"] and trace[0]["scenario"] == "solver-fleet"
    noms = [x for x in trace if x["t"] == "led" and x["type"] == "PodNominated"]
    assert len(noms) >= 200
    assert "trace" not in chip_smoke.fleet_line(run)
    chip_smoke.fleet_checks("small", run, run)
    for bad in (dict(run, trace=run["trace"] + "x"), dict(run, launches=run["launches"][1:])):
        with pytest.raises(SystemExit):
            chip_smoke.fleet_checks("small", run, bad)
    with pytest.raises(SystemExit):
        chip_smoke.fleet_checks("small", dict(run, refused=1), run)


def test_phase13_crash_rounds_and_launch_columns():
    """The ticks from each ``op_crash`` to the next ``PodNominated``, and a
    kernels-line row's launch columns: one a phase, ``fleet_launches`` (phase
    13's scaled cell) the newest, 0 where a phase launched nothing."""
    lines = [{"t": "ev", "tick": 2, "kind": "op_crash"},
             {"t": "led", "tick": 2, "type": "NodeLaunched"},
             {"t": "led", "tick": 4, "type": "PodNominated"},
             {"t": "ev", "tick": 9, "kind": "op_crash"}]
    trace = "\n".join(json.dumps(x) for x in lines)
    assert chip_smoke.crash_rounds(trace) == [2, None]
    per_phase = {"operator_launches": {"choose_config": 6}, "consolidation_launches": {},
                 "sim_launches": {}, "service_launches": {}, "ha_launches": {},
                 "fleet_launches": {"choose_config": 9}}
    row = chip_smoke.phase_launches("choose_config", per_phase)
    assert list(row)[-1] == "fleet_launches"
    assert row == {"operator_launches": 6, "consolidation_launches": 0, "sim_launches": 0,
                   "service_launches": 0, "ha_launches": 0, "fleet_launches": 9}
    assert chip_smoke.LAST_PHASE == 17
    assert [c[0] for c in chip_smoke.FLEET_CELLS] == [
        "store-fleet-chaos", "store-fleet-shard-chaos", "solver-fleet"]
    assert chip_smoke.FLEET_REPLAYED == "solver-fleet"


def test_phase14_lint_discovery():
    """Phase 14 (a)'s discovery line: the launch wrappers of the CUDA
    library and the upload sites, each found on the port's tree."""
    wrappers, sites = chip_smoke.lint_discovery()
    assert "karpenter_tpu_torch/ops/fused_packer.py:choose_config" in wrappers
    assert "karpenter_tpu_torch/ops/packer.py:admit_kernel" in wrappers
    assert "karpenter_tpu_torch/obs/device.py:DeviceObservatory.put" in sites
    assert chip_smoke.LINT_RULES == 18


def test_phase14_legacy_drive_on_the_cpu():
    """Phase 14 (c) on the CPU: the converted Provisioner and
    AWSNodeTemplate provision every pod, nominated within the drive's
    ticks (no kernel counts on the CPU), and a second drive's state equals
    the first's (the card drive is held to the CPU's so)."""
    from karpenter_tpu_torch import testing as T

    env, tick, counts = chip_smoke.legacy_drive("cpu")
    assert 1 <= tick <= chip_smoke.LEGACY_TICKS and counts == {}
    assert env.operator.provisioner.scheduler.last_kernel == "reference"
    assert len(env.kube.pods) == chip_smoke.LEGACY_PODS and not env.kube.pending_pods()
    pool = env.kube.node_pools["default"]
    assert [t.key for t in pool.taints] == ["dedicated"]
    again, _, _ = chip_smoke.legacy_drive("cpu")
    assert T.operator_state(env) == T.operator_state(again)


def test_phase14_launch_column():
    """The kernels line's newest launch column is phase 14's."""
    per_phase = {"fleet_launches": {"choose_config": 9},
                 "legacy_launches": {"choose_config": 1, "ffd_scan": 1}}
    row = chip_smoke.phase_launches("ffd_scan", per_phase)
    assert list(row) == ["fleet_launches", "legacy_launches"]
    assert row == {"fleet_launches": 0, "legacy_launches": 1}


def test_phase15_launch_column():
    """The kernels line's newest launch column is phase 15's main path, and
    the five mesh kernels' rows name their source and what they replace."""
    per_phase = {"legacy_launches": {"choose_config": 1},
                 "mesh_launches": {"ffd_shard_cap": 1284, "choose_config_shard": 8}}
    row = chip_smoke.phase_launches("ffd_shard_cap", per_phase)
    assert list(row) == ["legacy_launches", "mesh_launches"]
    assert row == {"legacy_launches": 0, "mesh_launches": 1284}
    from karpenter_tpu_torch.ops import fused_packer

    assert chip_smoke.MESH_KERNELS == fused_packer.MESH_KERNELS
    assert set(chip_smoke.MESH_REPLACES) == set(chip_smoke.MESH_KERNELS)
    root = pathlib.Path(chip_smoke.__file__).parent
    assert root.joinpath(chip_smoke.MESH_SOURCE).exists()
    for k, source in chip_smoke.MESH_SOURCES.items():
        assert k in chip_smoke.MESH_KERNELS and root.joinpath(source).exists()
    # the choice tile and the one-launch scan are the shard modes of
    # choose_config_kernel and ffd_scan_cluster_kernel, which the profiler
    # reports under those kernels' names
    assert chip_smoke.PROFILE_SYMBOL["choose_config_shard"] == "choose_config_kernel"
    assert chip_smoke.PROFILE_SYMBOL["ffd_shard_scan"] == "ffd_scan_cluster_kernel"
    src = root.joinpath(chip_smoke.KERNEL_SOURCE).read_text()
    assert "ffd_choose_config_shard" in src and "int mesh_shard_scan(" in src
    assert chip_smoke.MESH_SOURCES["ffd_shard_scan"] == chip_smoke.KERNEL_SOURCE


def test_phase15_lockstep_on_cpu_shards():
    """`mesh_lockstep` and `mesh_whole_scan` on a mesh of CPU shards (both
    sides the plain versions there): the wrap case and a frontier element
    step by step and whole, their outputs the plain pack's; the bound
    helpers on their outputs."""
    import numpy as np

    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as port_mesh

    mesh = T.cpu_mesh()
    cpu = torch.device("cpu")
    for args in (T.wrap_arrays(256, at=62), T.frontier_pack("wrap", 0)):
        k_out, p_out, e_choose = chip_smoke.mesh_lockstep(torch, "cpu", mesh, args, "nodes")
        assert e_choose == 0.0
        want = P.pack_reference(*P.to_device(args, cpu))
        assert chip_smoke.max_abs_err(torch, k_out, want) == 0.0
        assert chip_smoke.max_abs_err(torch, p_out, want) == 0.0
        for objective in ("nodes", "cost"):
            want = P.pack_reference(*P.to_device(args, cpu), objective=objective)
            s_out, err = chip_smoke.mesh_whole_scan(torch, "cpu", mesh, args, objective,
                                                    single=want)
            assert err == 0.0 and chip_smoke.max_abs_err(torch, s_out, want) == 0.0
            pair = chip_smoke.mesh_pair_pack(
                *port_mesh.pack_layout(mesh, args, site="mesh_smoke"), objective)
            assert chip_smoke.max_abs_err(torch, pair, want) == 0.0
    plan = P.mesh_plan(mesh.devices, args[0].shape[0], args[5].shape[0], args[8].shape[0])
    scan_bound = chip_smoke.mesh_scan_bound(torch, plan, args, s_out)
    assert scan_bound["bound_ms"] > 0 and scan_bound["bound_by"] in ("bytes", "operations")
    bounds = chip_smoke.mesh_bounds(plan, args, k_out, 2)
    assert set(bounds) == {"ffd_shard_cap", "ffd_shard_apply", "choose_config_shard"}
    assert all(b["bound_ms"] > 0 and b["bound_by"] in ("bytes", "operations")
               for b in bounds.values())
    take, _, cfg = (t.numpy() for t in k_out[:3])
    at = chip_smoke.open_steps(take, cfg, args[11])
    live = (cfg >= 0) & (np.arange(len(cfg)) < args[11])
    assert (at[live] == 0).all() and (at[cfg < 0] > take.shape[0]).all()
    step = T.mesh_step_problem()
    assert chip_smoke.assemble_bound(step)["bytes"] == (
        4 * 16 + 12 * 64 + 4 * (8 + 2 + 2) + 16 * 64)


def test_phase15_assemble_cases_on_cpu():
    """`assemble_cases` on CPU tensors (both sides the plain version
    there): the factorized step's problem and rows of 60,000 types give
    17 cases, every one bit-equal with the bytes outside its tiles
    untouched, and none of the 17 calls launches on the CPU."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import packer as P

    step = T.mesh_step_problem(classes=40, types=64)
    for arrays in (tuple(step[k] for k in T.MESH_STEP_ARGS[:7]),
                   T.assemble_arrays(C=300, S=4, T=60000)):
        diff, launches = chip_smoke.assemble_cases(torch, P.to_device(arrays,
                                                                      torch.device("cpu")))
        assert len(diff) == 17 and not any(diff.values()), diff
        assert launches == [0] * 17
    assert chip_smoke.ASSEMBLE_SENTINEL not in (0, 1)


def test_profiler_blind_windows_take_the_fallback(monkeypatch, capsys):
    """A kernel the profiler never sees (here: no card, so no device time
    at all) is timed by the caller's fallback after `PROFILE_ATTEMPTS`
    windows, and fails the run where there is none."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    asked = []

    def fallback(missing):
        asked.append(list(missing))
        return {k: 1.5 for k in missing}

    fn = lambda: torch.ones(3).sum()
    assert chip_smoke.profiled_launches_ms(torch, fn, ("k",), 1, fallback) == {"k": 1.5}
    assert asked == [["k"]]
    assert "timed by CUDA events instead" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.profiled_ms(torch, fn, "k", 1)


def test_phase16_argv_mapping():
    """A rendered argv as this host runs it: only the service hostnames
    (and the bind-all address), the ports and the settings mount change;
    a port the map lacks is an error, not a port left as it was."""
    argv = ["python", "-m", "karpenter_tpu_torch", "--settings-file=/etc/karpenter/settings.json",
            "--interval=1.0", "--metrics-port=8080", "--solver-address=karpenter-tpu-solver:8081",
            "--store-address=karpenter-tpu-store:8082", "--leader-elect", "--device=cuda",
            "--host=0.0.0.0", "--events-cap=4096", "--shard-index=0"]
    ports = {8080: 40001, 8081: 40002, 8082: 40003}
    mapped, changed = chip_smoke.map_argv(argv, ports, "/tmp/x")
    assert changed == [
        ("--settings-file=/etc/karpenter/settings.json", "--settings-file=/tmp/x/settings.json"),
        ("--metrics-port=8080", "--metrics-port=40001"),
        ("--solver-address=karpenter-tpu-solver:8081", "--solver-address=127.0.0.1:40002"),
        ("--store-address=karpenter-tpu-store:8082", "--store-address=127.0.0.1:40003"),
        ("--host=0.0.0.0", "--host=127.0.0.1"),
    ]
    assert [a for a in mapped if a not in dict(changed).values()] == [
        a for a in argv if a not in dict(changed)]
    with pytest.raises(KeyError):
        chip_smoke.map_argv(["--port=9999"], ports, "/tmp/x")
    assert chip_smoke.listen_ports(argv) == [8080]
    assert chip_smoke.implicit_ports("store", ["--port=8082"]) == ["--telemetry-port=8083"]
    assert chip_smoke.implicit_ports("store", ["--telemetry-port=1"]) == []
    assert chip_smoke.implicit_ports("solver", ["--port=8081"]) == []


def test_phase16_claims_multiset():
    """Two clusters with the same claims under other names and launch order
    compare equal; a pod nominated to another claim, or a claim in another
    zone, does not."""
    claims = {"nodeclaim-0": ("m.large", "zone-a", "spot"),
              "nodeclaim-1": ("m.large", "zone-a", "spot"),
              "nodeclaim-2": ("c.xlarge", "zone-b", "on-demand")}
    nominated = {"default/p0": "nodeclaim-0", "default/p1": "nodeclaim-0",
                 "default/p2": "nodeclaim-1", "default/p3": "nodeclaim-2"}
    twin_claims = {"nodeclaim-7": ("c.xlarge", "zone-b", "on-demand"),
                   "nodeclaim-8": ("m.large", "zone-a", "spot"),
                   "nodeclaim-9": ("m.large", "zone-a", "spot")}
    twin_nominated = {"default/p3": "nodeclaim-7", "default/p2": "nodeclaim-8",
                      "default/p0": "nodeclaim-9", "default/p1": "nodeclaim-9"}
    got = chip_smoke.claims_multiset(claims, nominated)
    want = chip_smoke.claims_multiset(twin_claims, twin_nominated)
    assert got == want
    assert got[0] == ("c.xlarge", "zone-b", "on-demand", ("default/p3",))
    assert chip_smoke.multiset_diff(got, want) == ([], [])
    moved = chip_smoke.claims_multiset(claims, {**nominated, "default/p2": "nodeclaim-0"})
    extra, missing = chip_smoke.multiset_diff(moved, want)
    assert ("m.large", "zone-a", "spot", ("default/p0", "default/p1", "default/p2")) in extra
    assert ("m.large", "zone-a", "spot", ("default/p2",)) in missing
    zoned = chip_smoke.claims_multiset({**claims, "nodeclaim-2": ("c.xlarge", "zone-c",
                                                                  "on-demand")}, nominated)
    assert chip_smoke.multiset_diff(zoned, want) == (
        [("c.xlarge", "zone-c", "on-demand", ("default/p3",))],
        [("c.xlarge", "zone-b", "on-demand", ("default/p3",))])


def test_phase16_rss_against_limit():
    """Memory quantities as Kubernetes writes them, and the processes whose
    peak RSS passes their rendered limit (none where there is no limit)."""
    assert chip_smoke.memory_bytes("512Mi") == 512 * 2 ** 20
    assert chip_smoke.memory_bytes("1Gi") == 2 ** 30
    assert chip_smoke.memory_bytes("1.5Gi") == 3 * 2 ** 29
    assert chip_smoke.memory_bytes("800M") == 800 * 10 ** 6
    assert chip_smoke.memory_bytes("4096") == 4096
    with pytest.raises(ValueError):
        chip_smoke.memory_bytes("1 gig")
    peaks = {"store": 600 * 2 ** 20, "solver": 9 * 2 ** 30, "controller-0": 2 ** 30,
             "controller-1": 2 ** 30 + 1}
    limits = {"store": "512Mi", "solver": None, "controller-0": "1Gi", "controller-1": "1Gi"}
    assert chip_smoke.rss_over_limit(peaks, limits) == ["controller-1", "store"]
    import os

    mem = chip_smoke.proc_memory(os.getpid())
    assert mem["VmRSS"] > 0 and mem["VmHWM"] >= mem["VmRSS"]


# phase 17's problems at their main path's padded pack shapes (K, R, S, C),
# as a cold solve of the port pads them at full scale
CONFIG_SHAPES = {
    "config3": (256, 6, 2, 4096),
    "config5": (512, 6, 2, 16384),
    **{f"coloc-{v}": (256, 6, 2, 4096) for v in ("tensor", "crossclass", "inequiv", "prefer")},
    "relax": (256, 6, 2, 4096),
    "hybrid": (512, 6, 2, 4096),
    "resident100k": (2048, 6, 2, 4096),
}


@pytest.mark.parametrize("name", list(CONFIG_SHAPES))
def test_phase17_expected_scan(name):
    """Each of phase 17's problems picks, at its padded shapes on an H100's
    15 co-resident clusters, the scan `CONFIG_SCAN` expects: the resident
    scan, config 5 at its 169,344-byte layout (the ring of eight 16 KB
    feasibility rows) and the 100k tick at 2 slots a thread."""
    K, R, S, C = CONFIG_SHAPES[name]
    assert set(CONFIG_SHAPES) == set(chip_smoke.CONFIG_PROBLEMS)
    assert fused_packer.scan_kernel(K, R, S, C, max_clusters=15) == chip_smoke.CONFIG_SCAN[name]
    per_thread, smem = fused_packer.resident_layout(K, R, S, C)
    assert per_thread <= fused_packer.MAX_SLOTS_PER_THREAD
    assert smem <= fused_packer.SMEM_PER_BLOCK
    if name == "config5":
        assert smem == 169_344 and fused_packer.SCAN_RING * C == 131_072
    if name == "resident100k":
        assert per_thread == 2


def test_phase17_tables():
    """Config 5 runs in both objectives, the others in the nodes one; the
    JAX package's path, continuation and relaxed count at full scale;
    phase 3 holds the kernels at four of the problems; the kernels line
    carries phase 17's launches as ``configs_launches``."""
    assert chip_smoke.CONFIG_OBJECTIVES == {"config5": ("nodes", "cost")}
    assert chip_smoke.CONFIG_EXPECT["hybrid"] == ("hybrid", "join", 0)
    assert chip_smoke.CONFIG_EXPECT["relax"] == ("tensor", "", 3000)
    assert {chip_smoke.CONFIG_EXPECT[n] for n in chip_smoke.CONFIG_PROBLEMS
            if n not in ("hybrid", "relax")} == {("tensor", "", 0)}
    assert set(chip_smoke.PHASE3_CONFIGS) < set(chip_smoke.CONFIG_PROBLEMS)
    assert chip_smoke.CONFIG_DELTA in chip_smoke.CONFIG_PROBLEMS
    row = chip_smoke.phase_launches("ffd_scan", {"configs_launches": {"ffd_scan": 7}})
    assert row == {"configs_launches": 7}


def test_phase17_problems_are_the_ports(monkeypatch):
    """`config_problems` builds each problem with the port's function in
    ``testing.py`` (here at a tiny scale), as (pools, inventory, pods,
    existing)."""
    from karpenter_tpu_torch import testing as T

    for fn in ("affinity_topology_problem", "multipool_spot_problem", "relax_problem",
               "hybrid_problem", "resident_100k_problem"):
        monkeypatch.setattr(T, fn, lambda real=getattr(T, fn): real(0.01))
    monkeypatch.setattr(T, "coloc_problem", lambda v, real=T.coloc_problem: real(v, 0.01))
    specs = chip_smoke.config_problems()
    assert list(specs) == list(chip_smoke.CONFIG_PROBLEMS)
    assert all(len(spec) == 4 for spec in specs.values())
    assert len(specs["hybrid"][3]) == 1 and len(specs["resident100k"][3]) == 10
    assert not specs["config3"][3]


def test_imports_no_jax_package_nor_bench():
    """chip_smoke.py imports neither the JAX package nor bench.py: it runs
    on a machine with the port alone."""
    import ast

    tree = ast.parse(pathlib.Path(chip_smoke.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "karpenter_tpu_torch" in names
    assert not names & {"bench", "karpenter_tpu", "jax", "jaxlib"}
