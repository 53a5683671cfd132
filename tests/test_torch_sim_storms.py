"""The simulator's storm and wave scenarios on the port, trace for trace
against the JAX package.

Each runs through both packages' `run_scenario` at the seed and tick count
of the reference test that runs it (the JAX package on the CPU, the port
with ``device="cpu"``), and the two traces must agree under
`torch_sim.assert_twin_traces`, as in `tests/test_torch_sim.py`; the
port's run must end with no invariant violation.  The load corpus's
scenarios are `tests/test_torch_sim_corpus.py`.
"""

import pytest

from torch_sim import PORT, assert_twin_traces, run

# (scenario, seed, ticks) as the reference tests run them
TWINS = [
    ("batch-waves", 7, 50),  # tests/test_sim.py:130-138
    ("flash-crowd", 7, 50),  # tests/test_sim.py:130-138
    ("interruption-storm", 5, 60),  # tests/test_sim.py:65
    ("api-storm+catalog-roll", 7, 100),  # tests/test_sim.py:130-138
    ("diurnal+interruption-storm", 11, 40),  # tests/test_pipeline.py:410
]


@pytest.mark.sim
@pytest.mark.parametrize("name,seed,ticks", TWINS)
def test_trace_equals_the_jax_package(name, seed, ticks):
    ref_text, _, _ = run("karpenter_tpu", name, seed, ticks)
    port_text, report, _ = run(PORT, name, seed, ticks)
    assert report["invariants"]["violations"] == []
    assert_twin_traces(ref_text, port_text)
