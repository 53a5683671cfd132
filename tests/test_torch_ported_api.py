"""The JAX package's suites of the API types, the validation and link
checks, the tensor/oracle routing spec and the metrics, run on the port.

Every case of ``tests/test_objects.py``, ``test_requirements.py``,
``test_resources.py``, ``test_validation_link.py``, ``test_router_spec.py``
and ``test_metrics.py`` runs on the port (`torch_ported.port_tests`), with
the operators on the CPU.  ``env`` is ``test_metrics.py``'s own fixture
(an `Environment` with an interruption queue).
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_objects.py"))
globals().update(port_tests("test_requirements.py"))
globals().update(port_tests("test_resources.py"))
globals().update(port_tests("test_validation_link.py"))
globals().update(port_tests("test_router_spec.py"))
globals().update(port_tests("test_metrics.py", fixtures=("env",)))
