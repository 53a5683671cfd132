"""The port's simulator held to the JAX package's simulator suite.

Every case of ``tests/test_sim.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU: run/run and
run/replay byte identity, the trace's structure, the invariant checker's
teeth, the scenarios, the CLI.  The CLI's device is explicit on the port
(``--device``, the card by default), so its case passes ``--device cpu``.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests(
    "test_sim.py",
    text=[('"--trace", trace]', '"--trace", trace, "--device", "cpu"]'),
          ('"--trace", replay_trace]', '"--trace", replay_trace, "--device", "cpu"]')],
))
