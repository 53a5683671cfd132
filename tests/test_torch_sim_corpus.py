"""The load corpus's scenarios and the diagnosis and consolidation
scenarios on the port, trace for trace against the JAX package.

Each runs through both packages' `run_scenario` at the seed and tick count
of the reference test that runs it (the JAX package on the CPU, the port
with ``device="cpu"``), and the two traces must agree under
`torch_sim.assert_twin_traces`, as in `tests/test_torch_sim.py`; the
port's run must end with no invariant violation.  ``million-events`` runs
at 12 ticks here and at the reference test's 60 with the ``slow`` mark, as
the reference's own test has it; the card runs it at ``bench.py``'s 850
ticks in ``chip_smoke.py``'s phase 18.  The storm scenarios are
`tests/test_torch_sim_storms.py`: two files, so that ``--dist loadfile``
spreads them over two workers.
"""

import pytest

from torch_sim import PORT, assert_twin_traces, run

# (scenario, seed, ticks) as the reference tests run them
TWINS = [
    ("gang-slice", 7, 30),  # tests/test_load.py:345-351
    ("spot-shock-drought", 7, 32),  # tests/test_load.py:345-351
    ("catalog-deprecations", 7, 30),  # tests/test_load.py:345-351
    ("slo-burn", 3, 30),  # tests/test_diagnosis.py:836
    ("chaos-soak", 3, 60),  # tests/test_consolidation_batch.py:110-124
    ("million-events", 23, 12),  # tests/test_load.py:378-395, cut to 12 ticks
]


def _twin(name, seed, ticks):
    ref_text, _, _ = run("karpenter_tpu", name, seed, ticks)
    port_text, report, runner = run(PORT, name, seed, ticks)
    assert report["invariants"]["violations"] == []
    assert_twin_traces(ref_text, port_text)
    return runner


@pytest.mark.sim
@pytest.mark.parametrize("name,seed,ticks", TWINS)
def test_trace_equals_the_jax_package(name, seed, ticks):
    _twin(name, seed, ticks)


@pytest.mark.slow
@pytest.mark.sim
def test_million_events_60_ticks_equals_the_jax_package():
    runner = _twin("million-events", 23, 60)
    assert runner.env.registry.counter("karpenter_load_vector_checked_ticks_total") > 0
    assert sum(runner.event_counts.values()) > 50_000
