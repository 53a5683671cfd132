"""`TorchScheduler` against the JAX package's `TensorScheduler`.

The same cluster, built in both packages from one spec (tests/torch_specs.py),
must decode to the same canonical `SchedulingResult` — per new node the
pool, feasible types, zone, capacity type and pod names; the existing
placements; the unschedulable pods — for a tensor-only batch, a hybrid
batch (oracle continuation and preference relaxation), live nodes with a
co-location join, and the slot-overflow retry, and for the two bench
problems cut to 500 pods."""

import pytest

import bench
import torch_specs
from karpenter_tpu.api import labels as jax_labels
from karpenter_tpu.scheduling import TensorScheduler
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api import reset_name_sequences
from karpenter_tpu_torch.scheduling.solver import TorchScheduler


def _solve_both(scenario, objective="nodes"):
    js = torch_specs.side("karpenter_tpu")
    ps = torch_specs.side("karpenter_tpu_torch")
    pools, inv, existing, pods = torch_specs.build(js, scenario)
    ref_sched = TensorScheduler(pools, inv, existing=existing, objective=objective)
    ref = ref_sched.solve(pods)
    pools, inv, existing, pods = torch_specs.build(ps, scenario)
    sched = TorchScheduler(
        pools, inv, existing=existing, objective=objective, device="cpu"
    )
    got = sched.solve(pods)
    return ref_sched, ref, sched, got


@pytest.mark.parametrize("scenario", torch_specs.SCENARIOS)
def test_result_matches_reference(scenario):
    ref_sched, ref, sched, got = _solve_both(scenario)
    assert torch_specs.canonical(got, L) == torch_specs.canonical(ref, jax_labels)
    assert sched.last_path == ref_sched.last_path
    assert sched.last_continuation == ref_sched.last_continuation
    assert sched.last_kernel == "reference"
    assert got.total_price() == pytest.approx(ref.total_price(), rel=0, abs=0)


def test_scenarios_cover_their_paths():
    paths = {}
    for scenario in ("hybrid", "existing"):
        _, _, sched, got = _solve_both(scenario)
        paths[scenario] = (sched.last_path, sched.last_continuation, got)
    assert paths["hybrid"][0] == "hybrid"
    assert paths["existing"][1] == "join"
    assert paths["existing"][2].existing_placements


def test_overflow_retry_doubles_slots(monkeypatch):
    """The first pack runs on the resident tensors' 512 slots; the retry
    pads the problem to twice that and uploads it."""
    from karpenter_tpu_torch.ops import packer
    from karpenter_tpu_torch.scheduling import solver

    padded, fetched = [], []
    real_pad, real_fetch = packer.pad_problem, solver.fetch_pack

    def spy_pad(prob, k_slots=0):
        args, kp = real_pad(prob, k_slots)
        padded.append(kp)
        return args, kp

    def spy_fetch(outs):
        res = real_fetch(outs)
        fetched.append(res.node_cfg.shape[0])
        return res

    monkeypatch.setattr(packer, "pad_problem", spy_pad)
    monkeypatch.setattr(solver, "fetch_pack", spy_fetch)
    ref_sched, ref, sched, got = _solve_both("overflow")
    assert fetched == [512, 1024] and padded == [1024]
    assert sched.last_resident and ref_sched.last_resident
    assert len(got.new_nodes) == 600 and not got.unschedulable
    assert torch_specs.canonical(got, L) == torch_specs.canonical(ref, jax_labels)


@pytest.mark.parametrize("objective", ["nodes", "cost"])
@pytest.mark.parametrize("problem", ["flagship", "heterogeneous"])
def test_bench_problem_matches_reference(monkeypatch, problem, objective):
    monkeypatch.setattr(bench, "SCALE", 0.05)  # 500 pods
    from karpenter_tpu.api.objects import reset_name_sequences as jax_reset

    jax_reset()
    if problem == "flagship":
        pool, types, pods = bench.build_problem()
        ref = TensorScheduler([pool], {pool.name: types}, objective=objective).solve(pods)
        reset_name_sequences()
        pool, types, pods = T.flagship_problem(scale=0.05)
        sched = TorchScheduler(
            [pool], {pool.name: types}, objective=objective, device="cpu"
        )
    else:
        pools, inv, pods = bench.build_heterogeneous()
        ref = TensorScheduler(pools, inv, objective=objective).solve(pods)
        reset_name_sequences()
        pools, inv, pods = T.heterogeneous_problem(scale=0.05)
        sched = TorchScheduler(pools, inv, objective=objective, device="cpu")
    got = sched.solve(pods)
    assert sched.last_path == "tensor"
    assert not got.unschedulable
    assert torch_specs.canonical(got, L) == torch_specs.canonical(ref, jax_labels)


def test_phases_sum_to_wall_time():
    import time

    pools, inv, pods = T.heterogeneous_problem(scale=0.02)
    sched = TorchScheduler(pools, inv, device="cpu")
    t0 = time.perf_counter()
    sched.solve(pods)
    wall = time.perf_counter() - t0
    phases = sched.last_phases
    # the first solve compiles, seeds the resident tensors under "delta"
    # and packs from them: no "pad" phase
    assert sched.last_resident
    assert {"partition", "compile", "delta", "dispatch", "device_block", "decode"} <= set(phases)
    assert "pad" not in phases
    assert all(v >= 0 for v in phases.values())
    assert sum(phases.values()) == pytest.approx(wall, rel=0.05)


def test_cuda_device_without_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pools, inv, _ = T.heterogeneous_problem(scale=0.001)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchScheduler(pools, inv)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchScheduler(pools, inv, device="cuda")
