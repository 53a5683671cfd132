"""The JAX package's suites of the scheduler, run on the port: the
scheduler's cases, the seeded fuzz of the tensor solve against the oracle,
pool spill and replacement.

Every case of ``tests/test_scheduler.py``, ``test_fuzz_parity.py``,
``test_pool_spill.py`` and ``test_replacement.py`` runs on the port
(`torch_ported.port_tests`), with the schedulers and operators on the CPU.
The reference says ``TensorScheduler`` where the port says
``TorchScheduler``.  ``test_fuzz_parity.py``'s module-scoped ``setup``
builds its `Environment` before `on_the_cpu` runs, so it asks for the CPU
itself (a ``text`` replacement).  The three files' ``env`` fixtures are
``Environment()`` word for word; the port file takes
``test_scheduler.py``'s.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

SCHEDULER = ("TensorScheduler", "TorchScheduler")

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_scheduler.py", text=[SCHEDULER], fixtures=("env",)))
globals().update(port_tests(
    "test_fuzz_parity.py",
    text=[SCHEDULER, ("    env = Environment()\n", '    env = Environment(device="cpu")\n')],
    fixtures=("setup",),
))
globals().update(port_tests("test_pool_spill.py"))
globals().update(port_tests("test_replacement.py"))
