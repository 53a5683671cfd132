"""The port's load harness (``load/``): the columnar event tapes, the
vectorized invariant plane, the corpus with the two scale anchors, the
quantile sketch.

Every case of ``tests/test_load.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU; none needs an
A3e or A8 module.  The full-size anchors keep the reference's ``slow``
mark (500 anti-affine pods on 500 nodes; 6,600 pods at 110 a node on 60
nodes); ``chip_smoke.py``'s phase 10 runs them on the card.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_load.py"))
