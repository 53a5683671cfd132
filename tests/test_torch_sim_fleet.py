"""The fleet simulator on the port (``sim/fleet.py``): several real
operators against one store server, four durable store shards, or one
multi-tenant solver service.

Every case of ``tests/test_sim_fleet.py`` and of
``tests/test_sim_fleet_shards.py`` runs on the port
(`torch_ported.port_tests`), its slow cases carrying the reference's mark.
Their module-scoped runs are built before the `on_the_cpu` fixture, so the
named `text` replacements of each file
(`torch_ported.FLEET_ON_THE_CPU`) ask every `run_fleet` and `replay_fleet`
call for the CPU.

Then the twins: each of the three fleet scenarios at the size of the
reference test that runs it gives, on the port's CPU, a trace byte-equal,
whole, to the JAX package's.  A fleet trace has no device section, so
nothing is set aside.  The store scenarios reuse the ported files' own runs
(``fleet_run``, ``shard_run``); ``solver-fleet`` reuses
``tests/test_service_tenants.py``'s ``solver_fleet_run``, run here on the
CPU.
"""

import logging

import pytest

from torch_ported import FLEET_ON_THE_CPU as ON_THE_CPU
from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_sim_fleet.py", text=ON_THE_CPU["test_sim_fleet.py"],
                            fixtures=("fleet_run",)))
globals().update(port_tests("test_sim_fleet_shards.py",
                            text=ON_THE_CPU["test_sim_fleet_shards.py"],
                            fixtures=("shard_run",)))
globals().update(port_tests("test_service_tenants.py", only=(),
                            text=ON_THE_CPU["test_service_tenants.py"],
                            fixtures=("solver_fleet_run",)))


def jax_trace(scenario: str, ticks: int, operators: int) -> str:
    """The JAX package's fleet trace of ``scenario`` at seed 0."""
    from karpenter_tpu.sim.fleet import run_fleet

    logging.disable(logging.WARNING)
    try:
        runner, _ = run_fleet(scenario, 0, ticks, operators=operators)
    finally:
        logging.disable(logging.NOTSET)
    return runner.trace.text()


@pytest.mark.sim
@pytest.mark.parametrize("scenario,run,ticks,operators", [
    ("store-fleet-chaos", "fleet_run", 36, 3),  # tests/test_sim_fleet.py
    ("store-fleet-shard-chaos", "shard_run", 36, 3),  # tests/test_sim_fleet_shards.py
    ("solver-fleet", "solver_fleet_run", 24, 12),  # tests/test_service_tenants.py
])
def test_fleet_trace_equals_the_jax_package(scenario, run, ticks, operators, request):
    runner, report = request.getfixturevalue(run)
    assert (runner.ticks, runner.n_operators) == (ticks, operators)
    assert report["invariants"]["violations"] == []
    port = runner.trace.text()
    ref = jax_trace(scenario, ticks, operators)
    assert len(port.splitlines()) == len(ref.splitlines())
    for i, (a, b) in enumerate(zip(ref.splitlines(), port.splitlines())):
        assert a == b, (i, a, b)
    assert port == ref
