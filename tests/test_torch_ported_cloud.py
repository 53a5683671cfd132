"""The JAX package's suites of the cloud side, run on the port: the fake
cloud, the cloud provider, the instance-type and launch-template
providers, bootstrap and the retry policy.

Every case of ``tests/test_fake_cloud.py``, ``test_cloudprovider.py``,
``test_instancetype_provider.py``, ``test_launchtemplate.py``,
``test_bootstrap.py`` and ``test_retry.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU.  Three of
these files define an ``env`` fixture and two a ``setup`` one, each
``Environment()`` and its default pool and node class word for word, so
the port file takes them once, from ``test_cloudprovider.py``.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_fake_cloud.py", fixtures=("cloud",)))
globals().update(port_tests("test_cloudprovider.py", fixtures=("env", "setup")))
globals().update(port_tests("test_instancetype_provider.py"))
globals().update(port_tests("test_launchtemplate.py"))
globals().update(port_tests("test_bootstrap.py"))
globals().update(port_tests("test_retry.py"))
