"""Fixtures for the port: pools, the synthetic catalog, the bench problems.

The counterpart of ``karpenter_tpu/testing.py``'s `Environment` for what
the solve reads: a default pool, instance types over `generate_catalog`
in zones ``zone-a/b/c`` of ``region-1``, and the two north-star problems of
``bench.py`` (`build_problem`, `build_heterogeneous`) with a ``scale`` on
the pod count.

Prices are those the reference environment serves after its operator's
start-up price refresh: on-demand from the shapes' seed prices, spot at the
fake cloud's default discount of the on-demand price in every zone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import (
    InstanceType,
    NodePool,
    Pod,
    Resources,
    Taint,
    Toleration,
)
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.fake.catalog import MachineShape, generate_catalog
from karpenter_tpu_torch.providers.instancetype import (
    SeedPrices,
    build_instance_types,
)

ZONES = ("zone-a", "zone-b", "zone-c")
REGION = "region-1"
SPOT_DISCOUNT = 0.3  # the fake cloud's spot price = on-demand x this
N_PODS = 10_000  # the bench problems' batch size at scale 1


def default_node_pool(name: str = "default", **kw) -> NodePool:
    return NodePool(name=name, node_class_ref="default", **kw)


def refreshed_prices(shapes: Sequence[MachineShape]) -> SeedPrices:
    """Seed on-demand prices plus the spot table a refresh returns."""
    spot = {
        (s.name, z): s.od_price * SPOT_DISCOUNT for s in shapes for z in ZONES
    }
    return SeedPrices.from_shapes(shapes, spot)


def instance_types(
    pool: Optional[NodePool] = None,
    shapes: Optional[Sequence[MachineShape]] = None,
) -> List[InstanceType]:
    """The catalog as the reference's ``env.instance_types.list(pool, nc)``
    returns it for the default node class."""
    shapes = list(shapes) if shapes is not None else generate_catalog()
    return build_instance_types(
        shapes, ZONES, REGION, refreshed_prices(shapes), pool=pool
    )


def _n(scale: float) -> int:
    return max(1, int(N_PODS * scale))


def flagship_problem(
    scale: float = 1.0,
) -> Tuple[NodePool, List[InstanceType], List[Pod]]:
    """Config 1 of ``bench.py``: 10k pods of eight request sizes over the
    five-generation catalog."""
    shapes = generate_catalog(
        generations=(1, 2, 3, 4, 5),
        cpus=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192),
    )
    pool = default_node_pool()
    types = instance_types(pool, shapes)
    sizes = [
        Resources(cpu=0.25, memory="512Mi"),
        Resources(cpu=0.5, memory="1Gi"),
        Resources(cpu=1, memory="2Gi"),
        Resources(cpu=1, memory="4Gi"),
        Resources(cpu=2, memory="4Gi"),
        Resources(cpu=2, memory="8Gi"),
        Resources(cpu=4, memory="8Gi"),
        Resources(cpu=8, memory="32Gi"),
    ]
    pods = [Pod(requests=sizes[i % len(sizes)]) for i in range(_n(scale))]
    return pool, types, pods


def heterogeneous_problem(
    scale: float = 1.0,
) -> Tuple[List[NodePool], Dict[str, List[InstanceType]], List[Pod]]:
    """Config 2 of ``bench.py``: 10k pods with near-continuous request
    sizes, a tainted dedicated pool and nodeSelector variety over the
    three-generation catalog (~300 types x 3 zones x 2 capacity types)."""
    shapes = generate_catalog(
        generations=(1, 2, 3),
        cpus=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192),
    )
    general = default_node_pool(name="general")
    dedicated = default_node_pool(
        name="dedicated",
        taints=[Taint(key="dedicated", value="batch", effect="NoSchedule")],
    )
    inventory = {
        "general": instance_types(general, shapes),
        "dedicated": instance_types(dedicated, shapes),
    }
    tol = (Toleration(key="dedicated", value="batch", effect="NoSchedule"),)
    selector_variants = [
        {},  # anything
        {L.LABEL_ARCH: "amd64"},
        {L.LABEL_INSTANCE_CATEGORY: "compute"},
        {L.LABEL_INSTANCE_CATEGORY: "memory"},
    ]
    pods = []
    for i in range(_n(scale)):
        # 80 cpu sizes x 4 memory ratios = 320 request classes per signature
        cpu = 0.05 * (1 + i % 80)
        mem_gib = max(0.25, cpu * (1, 2, 4, 8)[(i // 80) % 4])
        req = Resources(cpu=round(cpu, 2), memory=f"{int(mem_gib * 1024)}Mi")
        variant = i % 10
        if variant < 7:
            pods.append(
                Pod(
                    requests=req,
                    node_selector=dict(selector_variants[variant % 4]),
                )
            )
        else:  # 30%: tainted-pool workload
            pods.append(
                Pod(
                    requests=req,
                    tolerations=list(tol),
                    node_selector={L.LABEL_NODEPOOL: "dedicated"},
                )
            )
    return [general, dedicated], inventory, pods
