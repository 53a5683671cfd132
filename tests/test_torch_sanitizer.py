"""The port's runtime lock sanitizer held to the JAX package's suite.

The cases of ``tests/test_sanitizer.py`` run on the port
(`torch_ported.port_tests`), with the operators on the CPU: the forged
violations (a scripted lock inversion, blocking under an unsanctioned
lock, an unprotected shared write, a foreign release, each firing exactly
once, and their clean twins firing nothing), the witness artifact
(byte-identical across runs, round trip, version check), the deadlock
watchdog, and the operator's wiring (the watchdog armed only with the
sanitizer, the disabled seam handing out stdlib objects).

Left out: ``TestCrossValidation`` and ``TestSanitizedSuites``, which hold
the witness to the static lock model (``analysis/core.PackageSnapshot``,
``analysis/locks.py``, the lint CLI), not ported (ROADMAP A8b).  In place
of the second, `TestSanitizedSuitesOnThePort` runs its four sanitized
drives on the port (the FakeCloud API storm, the store-plane writer storm
with a live subscriber, the election mini-storm, the pipelined operator
twin) with the reference's assertions and zero findings, without the
static cross-check.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests(
    "test_sanitizer.py",
    left_out=("TestCrossValidation", "TestSanitizedSuites"),
    fixtures=("_sanitizer_isolated",),
))
_suites = port_tests("test_sanitizer.py", only=("TestSanitizedSuites",))["TestSanitizedSuites"]


@pytest.fixture
def static_model():
    """The static lock model is not ported: the drives' witnesses are held
    to zero findings alone."""
    return None


class TestSanitizedSuitesOnThePort(_suites):
    def _assert_clean(self, san, static_model):
        findings = san.findings()
        assert findings == [], "\n".join(f.render() for f in findings)
