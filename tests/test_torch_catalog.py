"""The port's instance types against the JAX package's `Environment`.

Same shapes, same pool: names, capacity, overhead, offerings (zone,
capacity type, price, availability) and requirements must be equal."""

import pytest

from karpenter_tpu.api import Resources as JaxResources
from karpenter_tpu.cloud.fake.backend import generate_catalog as jax_generate_catalog
from karpenter_tpu.testing import Environment
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.api import NodePool, Resources
from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog


def _canon(it):
    return (
        it.name,
        sorted(it.capacity.items()),
        sorted(it.overhead.kube_reserved.items()),
        sorted(it.overhead.system_reserved.items()),
        sorted(it.overhead.eviction_threshold.items()),
        [(o.zone, o.capacity_type, o.price, o.available) for o in it.offerings],
        repr(it.requirements),
    )


CATALOGS = {
    "default": ({}, {}),
    "flagship": (
        dict(generations=(1, 2, 3, 4, 5),
             cpus=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192)),
        {},
    ),
    "kubelet_overrides": (
        dict(generations=(1, 2), cpus=(2, 8, 32)),
        dict(kubelet_max_pods=58, kubelet_pods_per_core=4),
    ),
}


@pytest.mark.parametrize("catalog", sorted(CATALOGS))
def test_instance_types_match_reference(catalog):
    shape_kw, pool_kw = CATALOGS[catalog]
    env = Environment(shapes=jax_generate_catalog(**shape_kw))
    jpool = env.default_node_pool(**pool_kw)
    ref = env.instance_types.list(jpool, env.default_node_class())
    got = T.instance_types(
        T.default_node_pool(**pool_kw), generate_catalog(**shape_kw)
    )
    assert [it.name for it in got] == [it.name for it in ref]
    for a, b in zip(got, ref):
        assert _canon(a) == _canon(b)


def test_reserved_overrides_match_reference():
    kw = dict(generations=(1,), cpus=(4, 16))
    env = Environment(shapes=jax_generate_catalog(**kw))
    jpool = env.default_node_pool(
        kubelet_kube_reserved=JaxResources(cpu=0.5),
        kubelet_eviction_hard=JaxResources(memory="200Mi"),
    )
    ref = env.instance_types.list(jpool, env.default_node_class())
    pool = T.default_node_pool(
        kubelet_kube_reserved=Resources(cpu=0.5),
        kubelet_eviction_hard=Resources(memory="200Mi"),
    )
    got = T.instance_types(pool, generate_catalog(**kw))
    assert [_canon(a) for a in got] == [_canon(b) for b in ref]


def test_spot_falls_back_to_on_demand_before_refresh():
    from karpenter_tpu_torch.providers.instancetype import (
        SeedPrices,
        build_instance_types,
    )

    shapes = generate_catalog(generations=(1,), cpus=(2,))
    types = build_instance_types(
        shapes, T.ZONES, T.REGION, SeedPrices.from_shapes(shapes),
        pool=NodePool(name="p"),
    )
    for it in types:
        prices = {o.capacity_type: o.price for o in it.offerings}
        assert prices["spot"] == prices["on-demand"]
