"""The port's observability plane: the trace context, the event ledger, the
registry's exposition, the telemetry endpoint (``obs/http.py``), the
ledger's decision sites, the renderer (``obs/render.py``) and the
simulator's ledger lines.

Every case of ``tests/test_obs.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU, the trace ID
carried from a `RemoteKubeStore` write into the `StoreServer`'s spans
(``TestStorePropagation``) too.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_obs.py"))
