"""bench.py's three device lines in the port, held to the JAX package.

``karpenter_tpu_torch/testing.py`` drives each line as its ``bench.py``
function does, with bench's constants: `admission_drive`
(``run_admission_fastpath``), `pipelined_tick_drive`
(``run_pipelined_tick``, one schedule a call) and `load_harness_drive`
(``run_load_harness``).  Here each runs on the CPU at a small size beside
the same steps on the JAX package (``bench.SCALE`` set as in
`tests/test_torch_configs.py`), with no tolerance:

- admission at scale 0.05, 20 timed attempts a pass: every attempt of both
  packages nominated, onto the same node in the same order, no mismatch;
- the pipelined tick at 12 ticks, both schedules in both packages: each
  tick's state (the claims deleted, the disruption controller's pending
  set, each pod's node, as ``tests/test_pipeline.py``'s twin test takes it)
  equal across all four runs, and the speculation outcomes of each tick
  equal between the packages;
- the load harness at 12 ticks: the events, the ticks checked on the
  vectorized invariant plane and the report equal, the report's device
  section held as `torch_sim.device_view` holds it, the traces under
  `torch_sim.assert_twin_traces`.
"""

import time

import pytest

import bench
from karpenter_tpu.api import Pod as JaxPod
from karpenter_tpu.api import Resources as JaxResources
from karpenter_tpu.api.objects import reset_name_sequences as jax_reset
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.api import reset_name_sequences
from torch_sim import assert_twin_traces, device_view

SCALE = 0.05
ADMISSION_ITERS = 20
PIPELINE_TICKS = 12
LOAD_TICKS = 12


def test_constants_are_bench_s():
    assert T.ADMISSION_ITERS == 200 and T.ADMISSION_WARMUP == bench.WARMUP
    assert T.PIPELINE_TICKS == bench.PIPELINE_TICKS
    assert T.PIPELINE_SEED == bench.PIPELINE_SEED
    assert T.PIPELINE_TICK_GAP_S == bench.PIPELINE_TICK_GAP_S
    assert T.TICK_CONTROLLERS == bench._TICK_CONTROLLERS
    assert T.LOAD_HARNESS_TICKS == bench.LOAD_HARNESS_TICKS
    assert T.LOAD_HARNESS_SEED == bench.LOAD_HARNESS_SEED
    assert T.LOAD_HARNESS_MAX_FRACTION == bench.LOAD_HARNESS_MAX_FRACTION


# ------------------------------------------------------------- admission
def _ref_admission(iters: int) -> dict:
    """``bench.run_admission_fastpath``'s steps on the JAX package at
    ``bench.SCALE``, each attempt recorded as `T.admission_drive` records
    it."""
    from karpenter_tpu.scheduling import TensorScheduler, fastpath

    pools, inventory, _, existing = bench.build_resident_100k()
    ts = TensorScheduler(pools, inventory, existing=list(existing))
    size = JaxResources(cpu=0.25, memory="512Mi")
    outcomes, nodes = {}, []

    def admit() -> None:
        res = fastpath.try_admit(ts, [JaxPod(requests=size)])
        outcomes[res.outcome] = outcomes.get(res.outcome, 0) + 1
        nodes.append(next(iter(res.placements.values()))
                     if res.outcome == "nominated" else None)

    ts.solve([JaxPod(requests=size)])
    assert ts._resident.states
    admit()
    ts._resident.note_sync(ts)
    for _ in range(bench.WARMUP + 2 * iters):
        admit()
    return {"outcomes": outcomes, "nodes": nodes}


def test_admission_matches_the_jax_package(monkeypatch):
    monkeypatch.setattr(bench, "SCALE", SCALE)
    jax_reset()
    ref = _ref_admission(ADMISSION_ITERS)
    reset_name_sequences()
    got = T.admission_drive("cpu", scale=SCALE, iters=ADMISSION_ITERS)
    attempts = 1 + T.ADMISSION_WARMUP + 2 * ADMISSION_ITERS
    assert got["seeded"] and got["attempts"] == attempts
    assert got["live_nodes"] == len(bench.build_resident_100k()[3])
    assert got["outcomes"] == ref["outcomes"] == {"nominated": attempts}
    assert got["nodes"] == ref["nodes"]
    # the warm window launches no new signature and samples every attempt
    assert got["new_signatures_warm"] == 0 and got["new_signatures_cold"] > 0
    assert 0 < got["p50_ms"] <= got["p99_ms"]
    assert set(got["p99_phases_ms"]) >= {"delta", "dispatch", "oracle", "decode"}
    assert got["link_floor_ms"] > 0


# --------------------------------------------------------- pipelined tick
def _ref_pipelined(pipelined: bool, ticks: int) -> dict:
    """One schedule of ``bench.run_pipelined_tick`` on the JAX package:
    each tick's state and speculation outcomes, as `T.pipelined_tick_drive`
    returns them."""
    from karpenter_tpu.sim.runner import SCENARIOS, ScenarioRunner

    scn = SCENARIOS[T.PIPELINE_SCENARIO](ticks)
    runner = ScenarioRunner(scn, seed=bench.PIPELINE_SEED, ticks=ticks)
    op = runner.env.operator
    op.pipeline.enabled = pipelined
    op.disruption.search_population = 256
    reg = runner.env.registry
    states, by_tick = [], []
    for t in range(ticks):
        events = [ev for w in scn.workloads for ev in w.events(t, runner.rng, runner.view)]
        before = T._outcomes(reg)
        runner._tick(t, scn.tick_s, "run", events)
        after = T._outcomes(reg)
        by_tick.append({k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)})
        states.append(T.pipeline_state(runner.env))
        time.sleep(bench.PIPELINE_TICK_GAP_S)
    return {"states": states, "outcomes_by_tick": by_tick, "outcomes": T._outcomes(reg),
            "mismatch": reg.counter("karpenter_consolidation_verdict_mismatch_total")}


def test_pipelined_tick_matches_the_jax_package():
    runs = {}
    for pipelined in (False, True):
        runs["jax", pipelined] = _ref_pipelined(pipelined, PIPELINE_TICKS)
        runs["port", pipelined] = T.pipelined_tick_drive("cpu", pipelined, ticks=PIPELINE_TICKS)
    want = runs["jax", False]["states"]
    assert len(want) == PIPELINE_TICKS
    for key, run in runs.items():
        assert run["states"] == want, key
    for pipelined in (False, True):
        assert (runs["port", pipelined]["outcomes_by_tick"]
                == runs["jax", pipelined]["outcomes_by_tick"]), pipelined
    assert runs["port", False]["outcomes"] == {}
    assert runs["port", True]["outcomes"] == runs["jax", True]["outcomes"]
    assert runs["port", True]["outcomes"].get("adopted", 0) > 0
    assert runs["port", True]["verdict_mismatch"] == 0
    assert runs["jax", True]["mismatch"] == 0
    seq, pipe = runs["port", False], runs["port", True]
    assert seq["overlap_seconds"] == 0 and pipe["overlap_seconds"] > 0
    assert pipe["max_phase"] in T.TICK_CONTROLLERS
    assert pipe["p50_vs_max_phase"] == pipe["p50_ms"] / pipe["max_phase_ms"]


# ------------------------------------------------------------ load harness
def test_load_harness_matches_the_jax_package():
    from karpenter_tpu.sim.runner import run_scenario
    from karpenter_tpu.sim.trace import TraceWriter as JaxTraceWriter
    from karpenter_tpu_torch.sim.trace import TraceWriter

    ref_trace = JaxTraceWriter()
    ref_runner, ref_report = run_scenario(T.LOAD_HARNESS_SCENARIO, bench.LOAD_HARNESS_SEED,
                                          LOAD_TICKS, trace=ref_trace)
    trace = TraceWriter()
    got = T.load_harness_drive("cpu", ticks=LOAD_TICKS, trace=trace)
    ref_reg = ref_runner.env.registry
    assert got["events"] == sum(ref_runner.event_counts.values()) > 0
    assert got["event_counts"] == dict(sorted(ref_runner.event_counts.items()))
    assert got["vector_checked_ticks"] == ref_reg.counter(
        "karpenter_load_vector_checked_ticks_total") > 0
    assert got["violations"] == [] == ref_report["invariants"]["violations"]
    report, ref = dict(got["report"]), dict(ref_report)
    dev, ref_dev = report.pop("device"), ref.pop("device")
    assert report == ref
    assert device_view(dev, False) == device_view(ref_dev, True)
    assert_twin_traces(ref_trace.text(), trace.text())
    assert set(got["phases_s"]) == {"generate", "apply", "reconcile", "invariants"}
    assert got["harness_fraction"] == pytest.approx(got["harness_s"] / got["phase_total_s"])
