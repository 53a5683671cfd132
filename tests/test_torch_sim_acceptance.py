"""The simulator's acceptance scenarios of the admission fast path, the
consolidation search and the pipelined reconcile, on the port.

The twins: ``single-pod-trickle`` (seed 11, 60 ticks) and
``consolidation-storm`` (seed 7, 60 ticks) through both packages, held to
`torch_sim.assert_twin_traces` as in `tests/test_torch_sim.py`.

Then the reference's ``sim`` tests of these paths run on the port
(`torch_ported.port_tests`, the operators on the CPU):
``tests/test_fastpath.py``'s ``test_single_pod_trickle_byte_identical``
and its doctor test, ``tests/test_consolidation_batch.py``'s
``test_parity_sim_snapshot``, ``tests/test_consolidation_search.py``'s
``test_population_parity_storm_snapshot`` and
``test_consolidation_storm_byte_identical``, and
``tests/test_pipeline.py``'s ``test_sim_runner_forces_pipeline_off`` and
``test_diurnal_interruption_storm_byte_identical``.  The other cases of
those files have their twins in ``tests/test_torch_fastpath.py``,
``tests/test_torch_disruption.py`` and ``tests/test_torch_pipeline.py``;
``tests/test_fastpath.py`` imports the reference's ``TensorScheduler``,
which is the port's ``TorchScheduler``.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401
from torch_sim import PORT, assert_twin_traces, run

TWINS = [
    ("single-pod-trickle", 11, 60),  # tests/test_fastpath.py
    ("consolidation-storm", 7, 60),  # tests/test_consolidation_search.py
]


@pytest.mark.sim
@pytest.mark.parametrize("name,seed,ticks", TWINS)
def test_trace_equals_the_jax_package(name, seed, ticks):
    ref_text, _, _ = run("karpenter_tpu", name, seed, ticks)
    port_text, report, _ = run(PORT, name, seed, ticks)
    assert report["invariants"]["violations"] == []
    assert_twin_traces(ref_text, port_text)


for _file, _names in (
    ("test_fastpath.py", ("test_single_pod_trickle_byte_identical",
                          "test_doctor_names_fallback_storm_and_mismatch")),
    ("test_consolidation_batch.py", ("test_parity_sim_snapshot",)),
    ("test_consolidation_search.py", ("test_population_parity_storm_snapshot",
                                      "test_consolidation_storm_byte_identical")),
    ("test_pipeline.py", ("test_sim_runner_forces_pipeline_off",
                          "test_diurnal_interruption_storm_byte_identical")),
):
    _text = [("TensorScheduler", "TorchScheduler")] if _file == "test_fastpath.py" else []
    for _name, _test in port_tests(_file, only=_names, text=_text).items():
        globals()[_name] = pytest.mark.usefixtures("on_the_cpu")(_test)
