"""The port's runtime lock sanitizer held to the JAX package's suite.

Every case of ``tests/test_sanitizer.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU: the forged
violations (a scripted lock inversion, blocking under an unsanctioned
lock, an unprotected shared write, a foreign release, each firing exactly
once, and their clean twins firing nothing), the witness artifact
(byte-identical across runs, round trip, version check), the deadlock
watchdog, the operator's wiring (the watchdog armed only with the
sanitizer, the disabled seam handing out stdlib objects), and the
cross-validation of the witness against the port's static lock model
(``analysis/locks.py``; the module-scoped ``static_model`` fixture builds
it over the port's tree): `TestCrossValidation` and the four sanitized
drives (the FakeCloud API storm, the store-plane writer storm with a live
subscriber, the election mini-storm, the pipelined operator twin), each
with zero findings and a witness the static model predicts.  The drives
keep the name they ran under while the static model was missing,
`TestSanitizedSuitesOnThePort`: it is the reference's
``TestSanitizedSuites``, the static cross-check included.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
_cases = port_tests("test_sanitizer.py", fixtures=("_sanitizer_isolated", "static_model"))
TestSanitizedSuitesOnThePort = _cases.pop("TestSanitizedSuites")
globals().update(_cases)
