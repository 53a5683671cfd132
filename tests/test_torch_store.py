"""The port's shared cluster store held to the JAX package's store tests.

Every case of ``tests/test_store_server.py`` (the server, the remote store
and its mirror, the wire form, conflicts and reconnects),
``tests/test_store_shards.py`` (the shard router, the durable replay log,
the wire fault injectors of ``sim/faults.py``, epochs across restarts,
the watch client's pacing) and ``tests/test_store_scale.py`` (the ``bin1``
codec and its negotiation, delta resyncs, bounded fan-out, read replicas)
runs on the port (`torch_ported.port_tests`), with any operator on the
CPU.  Both reference files that define the ``server`` fixture define the
same one (a `StoreServer` on a free port, stopped after the case).
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_store_server.py", fixtures=("server",)))
globals().update(port_tests("test_store_shards.py"))
globals().update(port_tests("test_store_scale.py"))
