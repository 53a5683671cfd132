"""The simulator on the port against the JAX package's, trace for trace.

Each scenario runs through both packages' `run_scenario` at the seed and
tick count of the reference test that runs it (the JAX package on the CPU,
as tier 1 runs it; the port with ``device="cpu"``), and the two traces
must agree line for line under `torch_sim.assert_twin_traces`: every
``meta``, ``tick``, ``ev``, ``api``, ``led`` and ``dig`` line byte-equal,
the ``report`` byte-equal but for its ``device`` section, which is held as
the operator twin holds the observatory.  The port's own run/run and
run/replay byte identity is `tests/test_torch_sim_suite.py` (the cases of
``tests/test_sim.py``) and `tests/test_torch_sim_acceptance.py`, which
also holds the twins of ``single-pod-trickle`` and ``consolidation-storm``.

The full-size anchors (500 anti-affine pods on 500 nodes; 6,600 pods on 60
nodes) carry the ``slow`` mark, as the reference's own do; the card runs
them in ``chip_smoke.py``'s phase 10.
"""

import pytest

from torch_sim import PORT, assert_twin_traces, run

# (scenario, seed, ticks) as the reference tests run them
TWINS = [
    ("steady", 3, 40),  # tests/test_sim.py
    ("diurnal", 7, 100),  # tests/test_sim.py::test_scenario_invariants
    ("resident-churn", 21, 70),  # tests/test_sim.py
    ("anchor-500-antiaffinity-smoke", 1, 12),  # tests/test_load.py
    ("anchor-6600-density-smoke", 1, 12),  # tests/test_load.py
]
FULL_ANCHORS = [
    ("anchor-500-antiaffinity", 1, 15, 500),
    ("anchor-6600-density", 1, 15, 60),
]


@pytest.mark.sim
@pytest.mark.parametrize("name,seed,ticks", TWINS)
def test_trace_equals_the_jax_package(name, seed, ticks):
    ref_text, ref_report, _ = run("karpenter_tpu", name, seed, ticks)
    port_text, port_report, _ = run(PORT, name, seed, ticks)
    assert port_report["invariants"]["violations"] == []
    assert_twin_traces(ref_text, port_text)


@pytest.mark.slow
@pytest.mark.sim
@pytest.mark.parametrize("name,seed,ticks,nodes", FULL_ANCHORS)
def test_full_anchor_equals_the_jax_package(name, seed, ticks, nodes):
    ref_text, _, _ = run("karpenter_tpu", name, seed, ticks)
    port_text, report, runner = run(PORT, name, seed, ticks)
    assert report["invariants"]["violations"] == []
    assert len(runner.env.kube.nodes) == nodes
    assert 0.0 <= report["fleet"]["time_to_settle_s"] <= report["fleet"]["settle_budget_s"]
    assert_twin_traces(ref_text, port_text)


def test_sim_runs_on_the_card_unless_asked(capsys):
    """``run_scenario`` and ``python -m karpenter_tpu_torch sim`` run on the
    card by default; without one they raise instead of carrying on on the
    CPU."""
    import torch

    from karpenter_tpu_torch.__main__ import main
    from karpenter_tpu_torch.sim.runner import run_scenario

    if torch.cuda.is_available():
        runner, _ = run_scenario("steady", 1, 2)
        assert runner.env.operator.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario("steady", 1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["sim", "--scenario", "steady", "--ticks", "2", "--trace", "/dev/null"])


def test_cli_runs_and_replays_a_fleet_scenario(tmp_path, capsys):
    """``python -m karpenter_tpu_torch sim`` runs a fleet scenario
    (``sim/fleet.py``) on the asked device, lists the JAX package's fleet
    scenarios, and replays a fleet trace through the fleet runner,
    reproducing its report and its bytes."""
    import json

    from karpenter_tpu.sim.fleet import FLEET_SCENARIOS as REFERENCE_FLEET
    from karpenter_tpu_torch.sim.cli import main

    assert main(["--list"]) == 0
    listed = {line.split(":")[0] for line in capsys.readouterr().out.splitlines()}
    assert set(REFERENCE_FLEET) <= listed
    trace = tmp_path / "fleet.jsonl"
    assert main(["--scenario", "store-fleet-chaos", "--seed", "0", "--ticks", "8",
                 "--device", "cpu", "--trace", str(trace)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["scenario"] == "store-fleet-chaos" and report["operators"] == 3
    assert report["invariants"]["violations"] == [] and report["double_launches"] == 0
    replayed = tmp_path / "fleet.replayed.jsonl"
    assert main(["--replay", str(trace), "--device", "cpu", "--trace", str(replayed)]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out) == report
    assert "report matches the recorded one" in out.err
    assert replayed.read_text() == trace.read_text()
