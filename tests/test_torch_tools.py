"""The port's operational tools held to the JAX package's suite.

Every case of ``tests/test_tools.py`` runs on the port
(`torch_ported.port_tests`): allocatable-diff against the port's operator
(its solver on the CPU), kompat, and the metrics page's freshness.  The
port's generator renders its own page, ``docs/torch/metrics.md`` (each
entry names the port's modules; ``docs/metrics.md`` is the JAX package's
and stays as it is), so the freshness case reads that page (a ``text``
replacement).
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests(
    "test_tools.py",
    text=[('doc = pkg.parent / "docs" / "metrics.md"',
           'doc = pkg.parent / "docs" / "torch" / "metrics.md"')],
))
