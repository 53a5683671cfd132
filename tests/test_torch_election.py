"""The port's election storm: two port operators over one shared store.

Every case of ``tests/test_election_storm.py`` runs on the port
(`torch_ported.port_tests`), with the operators on the CPU: two
`Operator`s with `LeaderElector`s dial one `StoreServer` through
`RemoteKubeStore` clients over real sockets, under the shuffled-controller
fuzzer, through a leader crash, a graceful release mid-tick and a renewal
loss; every launch came from the replica that held the lease that round,
no claim launched twice, and the converged state passes the consistency
checker.  ``test_failover_preserves_scheduled_state``: the new leader
re-launches nothing for pods the old one placed.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_election_storm.py"))
