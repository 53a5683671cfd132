"""The port's deployment tools held to the JAX package's chart and CRDs.

Every case of ``tests/test_deploy.py`` runs on the port
(`torch_ported.port_tests`): the port's ``tools/render_chart.py`` renders
``deploy/chart`` into the same manifests, whose settings load as the
port's `Settings`, and the port's ``tools/gen_crds.py`` regenerates
``deploy/crds`` byte for byte from the port's ``api/objects.py``.  The
chart is the JAX package's and stays as it is: it still starts ``python -m
karpenter_tpu`` and asks for the TPU, so the two asserts on those words
keep the reference's (``text`` replacements undo the rename there).  The
port's own chart is ``deploy/chart_torch``; ``tests/test_torch_chart.py``
runs the same cases over it in the port's words.

`test_render_chart_equals_the_reference` holds the two packages'
renderers byte-equal on the same values.
"""

import pytest

from torch_ported import port_tests

globals().update(port_tests(
    "test_deploy.py",
    text=[
        ('["python", "-m", "karpenter_tpu_torch"]', '["python", "-m", "karpenter_tpu"]'),
        ('"karpenter_tpu_torch.service.server"', '"karpenter_tpu.service.server"'),
    ],
))

VALUE_SETS = [
    {"settings.cluster_name": "prod-cluster"},
    {"settings.cluster_name": "ha", "replicas": "2", "store.enabled": "true"},
    {"settings.cluster_name": "x", "service.multiTenant.enabled": "true",
     "service.multiTenant.inflightCap": "8"},
]


@pytest.mark.parametrize("values", VALUE_SETS, ids=["default", "ha", "tenants"])
def test_render_chart_equals_the_reference(values):
    from karpenter_tpu.tools.render_chart import render_chart as ref_render
    from karpenter_tpu_torch.tools.render_chart import render_chart

    port = render_chart("deploy/chart", dict(values))
    assert port and port == ref_render("deploy/chart", dict(values))
