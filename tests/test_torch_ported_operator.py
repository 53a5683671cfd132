"""The JAX package's suites of the operator under stress, run on the port:
chaos, races, the scale tests, volumes and the device observatory.

Every case of ``tests/test_chaos.py``, ``test_race.py``, ``test_scale.py``,
``test_volumes.py`` and ``test_device_obs.py`` runs on the port
(`torch_ported.port_tests`), with the operators and schedulers on the CPU,
but five of ``test_device_obs.py``'s: they count the compiles and
transfers of ``jax.jit`` functions and a ``put`` without a device, and the
port's observatory counts launch signatures of its CUDA wrappers instead
(``tests/test_torch_observatory.py`` holds it to the reference's on the
same solves).  The reference says ``TensorScheduler`` where the port says
``TorchScheduler``.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_chaos.py"))
globals().update(port_tests("test_race.py"))
globals().update(port_tests("test_scale.py"))
globals().update(port_tests("test_volumes.py", fixtures=("env",)))
globals().update(port_tests(
    "test_device_obs.py",
    text=[("TensorScheduler", "TorchScheduler")],
    left_out=("TestDispatchSeam.test_counts_compiles_transfers_and_dispatches",
              "TestDispatchSeam.test_disabled_observatory_is_a_passthrough",
              "TestDispatchSeam.test_tick_section_deltas",
              "TestPutSeam.test_counts_leaf_bytes_and_returns_device_value",
              "TestExport.test_delta_export_and_warm_events"),
))
