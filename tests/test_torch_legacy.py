"""The port's v1alpha5 -> v1beta1 conversion held to the JAX package's suite.

Every case of ``tests/test_legacy.py`` runs on the port
(`torch_ported.port_tests`): ``api/legacy.py``'s `convert_provisioner` and
`convert_aws_node_template` map the legacy fields, apply the legacy
dialect's defaults, refuse what has no v1beta1 form, and the converted
objects drive the port's controller loop, its solver on the CPU.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_legacy.py"))
