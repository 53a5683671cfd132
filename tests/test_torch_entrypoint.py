"""The port's entry point as the reference deploys it.

Every case of ``tests/test_entrypoint.py`` runs on the port
(`torch_ported.port_tests`): the settings layers, ``--dump-settings``, a
controller process serving /healthz and /metrics until SIGTERM, the
device observatory's /debug/device after the demo workload's solve, two
``--store-address`` replicas failing over through the Lease, and the
preflight.  The named `text` replacements (`DEVICE_CPU`, `OWN_PORTS`):
each controller process runs with ``--device cpu`` (the port's default is
the card), and the two fixed metrics ports become ports of this file's
own, so that it can run beside the reference's file.  The in-process
preflight builds its operator on the CPU (the `on_the_cpu` fixture).
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

DEVICE_CPU = [
    ('"karpenter_tpu_torch",\n                "--interval",',
     '"karpenter_tpu_torch",\n                "--device",\n                "cpu",\n'
     '                "--interval",'),
    ('"--interval", "0.05",\n                    "--metrics-port", str(metrics_port),',
     '"--device", "cpu", "--interval", "0.05",\n'
     '                    "--metrics-port", str(metrics_port),'),
]
OWN_PORTS = [("18123", "18133"), ("18127", "18137")]

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_entrypoint.py", text=DEVICE_CPU + OWN_PORTS))
