"""The port's leader election held to the JAX package's election tests.

Every case of ``tests/test_leader.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU: the Lease's
acquire, renew, exclusion, expiry and holder-only release in the store,
and two operators with `LeaderElector`s over one store, of which only the
leader reconciles, the standby takes over after the leader's crash (lease
expiry) or at once after its graceful release, and a leader that loses
its lease mid-tick runs no further controller.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_leader.py"))
