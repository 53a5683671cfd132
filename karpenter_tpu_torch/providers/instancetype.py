"""Instance types from machine shapes: the pure build path.

Port of the build half of ``karpenter_tpu/providers/instancetype.py``
(`_build`, `_capacity`, `_requirements`, `_offerings`, `kube_reserved_*`):
shapes x zones x a region x seed prices -> `InstanceType`s.  Offerings are
always available here (no ICE cache), and there are no provider caches or
metrics; those wait for the operator slice.

Prices follow ``karpenter_tpu/providers/pricing.py``: on-demand from the
shapes' seed prices, spot per (type, zone) from a refreshed table, falling
back to on-demand until a refresh has landed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import (
    InstanceType,
    NodePool,
    Offering,
    Offerings,
    Overhead,
    Requirement,
    Requirements,
    Resources,
)
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.requirements import Op
from karpenter_tpu_torch.cloud.fake.catalog import MachineShape

# settings.go:48-61 default, as ``karpenter_tpu/api/settings.py``
VM_MEMORY_OVERHEAD_PERCENT = 0.075


@dataclass
class SeedPrices:
    """On-demand seed prices by type plus the spot table of the last
    refresh (empty until one lands)."""

    on_demand: Dict[str, float]
    spot: Dict[Tuple[str, str], float] = field(default_factory=dict)

    @classmethod
    def from_shapes(
        cls, shapes: Sequence[MachineShape],
        spot: Optional[Dict[Tuple[str, str], float]] = None,
    ) -> "SeedPrices":
        return cls({s.name: s.od_price for s in shapes}, dict(spot or {}))

    def on_demand_price(self, instance_type: str) -> Optional[float]:
        return self.on_demand.get(instance_type)

    def spot_price(self, instance_type: str, zone: str) -> Optional[float]:
        """Per-zone spot price; the on-demand price until a refresh."""
        if self.spot:
            p = self.spot.get((instance_type, zone))
            if p is not None:
                return p
        return self.on_demand.get(instance_type)


def _overlay(base: Resources, override) -> Resources:
    """Per-key override merge: keys present in `override` replace the
    computed default; absent keys keep it."""
    if override is None:
        return base
    q = {a: v for a, v in base.items()}
    for a, v in override.items():
        q[a] = v
    return Resources(q)


def kube_reserved_cpu(cpu_cores: float) -> float:
    """Piecewise kubelet CPU reservation (reference types.go:343-362):
    6% of the first core, 1% of the second, 0.5% of cores 3-4, 0.25% of the
    rest."""
    reserved = 0.0
    remaining = cpu_cores
    for band, frac in ((1, 0.06), (1, 0.01), (2, 0.005), (float("inf"), 0.0025)):
        take = min(remaining, band)
        if take <= 0:
            break
        reserved += take * frac
        remaining -= take
    return reserved


def kube_reserved_memory(max_pods: int) -> float:
    """11 MiB per pod + 255 MiB (reference types.go:338)."""
    return (11 * max_pods + 255) * 2**20


def build_instance_types(
    shapes: Sequence[MachineShape],
    zones: Sequence[str],
    region: str,
    prices: SeedPrices,
    pool: Optional[NodePool] = None,
) -> List[InstanceType]:
    """Every shape's InstanceType, sorted by name, with offerings in
    ``zones`` (``InstanceTypeProvider.list`` without its caches)."""
    reserved = (
        (
            pool.kubelet_kube_reserved,
            pool.kubelet_system_reserved,
            pool.kubelet_eviction_hard,
        )
        if pool is not None
        else (None, None, None)
    )
    return [
        build_instance_type(
            shape, list(zones),
            pool.kubelet_max_pods if pool is not None else None,
            reserved,
            pool.kubelet_pods_per_core if pool is not None else None,
            region=region, prices=prices,
        )
        for shape in sorted(shapes, key=lambda s: s.name)
    ]


def build_instance_type(
    shape: MachineShape,
    zones: Sequence[str],
    max_pods_override: Optional[int],
    reserved_overrides: tuple = (None, None, None),
    pods_per_core: Optional[int] = None,
    *,
    region: str,
    prices: SeedPrices,
) -> InstanceType:
    """One shape's InstanceType (``InstanceTypeProvider._build``)."""
    max_pods = (
        max_pods_override if max_pods_override is not None else shape.max_pods
    )
    if pods_per_core:
        # dynamic pod density (reference pod-density.md:43): density
        # scales with the instance's logical cores, capped by maxPods
        max_pods = min(max_pods, int(pods_per_core * shape.cpu))
    capacity = _capacity(shape, max_pods)
    kube_o, system_o, evict_o = reserved_overrides
    overhead = Overhead(
        # kubeletConfiguration overrides replace the computed default
        # PER RESOURCE KEY; absent keys keep the curve (reference
        # types.go:326-399 merges the provisioner's kubeReserved /
        # systemReserved / evictionHard the same way)
        kube_reserved=_overlay(
            Resources(
                cpu=kube_reserved_cpu(shape.cpu),
                memory=kube_reserved_memory(max_pods),
            ),
            kube_o,
        ),
        system_reserved=_overlay(Resources(), system_o),
        eviction_threshold=_overlay(
            Resources(memory=100 * 2**20), evict_o
        ),
    )
    return InstanceType(
        name=shape.name,
        requirements=_requirements(shape, zones, region),
        capacity=capacity,
        overhead=overhead,
        offerings=_offerings(shape, zones, prices),
    )


def _capacity(shape: MachineShape, max_pods: int) -> Resources:
    q = {
        L.RESOURCE_CPU: shape.cpu,
        # VM overhead shaves reported memory (types.go:196-206)
        L.RESOURCE_MEMORY: shape.memory
        * (1 - VM_MEMORY_OVERHEAD_PERCENT),
        L.RESOURCE_PODS: float(max_pods),
        L.RESOURCE_EPHEMERAL_STORAGE: 20 * 2**30
        + shape.local_nvme,  # root volume + instance store
    }
    if shape.gpu_count:
        q[L.RESOURCE_GPU] = float(shape.gpu_count)
    if shape.tpu_chips:
        q[L.RESOURCE_TPU] = float(shape.tpu_chips)
    return Resources(q)


def _requirements(
    shape: MachineShape, zones: Sequence[str], region: str
) -> Requirements:
    reqs = Requirements(
        [
            Requirement(L.LABEL_INSTANCE_TYPE, Op.IN, [shape.name]),
            Requirement(L.LABEL_ARCH, Op.IN, [shape.arch]),
            Requirement(L.LABEL_OS, Op.IN, [shape.os]),
            Requirement(L.LABEL_ZONE, Op.IN, zones),
            Requirement(L.LABEL_REGION, Op.IN, [region]),
            Requirement(
                L.LABEL_CAPACITY_TYPE,
                Op.IN,
                [L.CAPACITY_TYPE_ON_DEMAND, L.CAPACITY_TYPE_SPOT],
            ),
            Requirement(L.LABEL_INSTANCE_CATEGORY, Op.IN, [shape.category]),
            Requirement(L.LABEL_INSTANCE_FAMILY, Op.IN, [shape.family]),
            Requirement(
                L.LABEL_INSTANCE_GENERATION, Op.IN, [str(shape.generation)]
            ),
            Requirement(L.LABEL_INSTANCE_SIZE, Op.IN, [shape.size]),
            Requirement(L.LABEL_INSTANCE_CPU, Op.IN, [str(int(shape.cpu))]),
            Requirement(
                L.LABEL_INSTANCE_MEMORY,
                Op.IN,
                [str(int(shape.memory / 2**20))],  # MiB, as the reference
            ),
            Requirement(
                L.LABEL_INSTANCE_NETWORK_BANDWIDTH,
                Op.IN,
                [str(int(shape.network_bandwidth * 1000))],  # Mbps
            ),
            Requirement(L.LABEL_INSTANCE_HYPERVISOR, Op.IN, [shape.hypervisor]),
        ]
    )
    if shape.gpu_count:
        reqs.add(Requirement(L.LABEL_INSTANCE_GPU_NAME, Op.IN, [shape.gpu_name]))
        reqs.add(
            Requirement(L.LABEL_INSTANCE_GPU_COUNT, Op.IN, [str(shape.gpu_count)])
        )
    if shape.tpu_chips:
        reqs.add(
            Requirement(
                L.LABEL_INSTANCE_ACCELERATOR_NAME,
                Op.IN,
                [shape.accelerator_name or "tpu"],
            )
        )
        reqs.add(
            Requirement(
                L.LABEL_INSTANCE_ACCELERATOR_MANUFACTURER,
                Op.IN,
                [shape.accelerator_manufacturer or "tpu-vendor"],
            )
        )
        reqs.add(
            Requirement(
                L.LABEL_INSTANCE_ACCELERATOR_COUNT, Op.IN, [str(shape.tpu_chips)]
            )
        )
    if shape.local_nvme:
        reqs.add(
            Requirement(
                L.LABEL_INSTANCE_LOCAL_NVME,
                Op.IN,
                [str(int(shape.local_nvme / 2**30))],
            )
        )
    return reqs


def _offerings(
    shape: MachineShape, zones: Sequence[str], prices: SeedPrices
) -> Offerings:
    out = Offerings()
    for zone in zones:
        od = prices.on_demand_price(shape.name)
        if od is not None:
            out.append(
                Offering(
                    zone=zone,
                    capacity_type=L.CAPACITY_TYPE_ON_DEMAND,
                    price=od,
                    available=True,
                )
            )
        spot = prices.spot_price(shape.name, zone)
        if spot is not None:
            out.append(
                Offering(
                    zone=zone,
                    capacity_type=L.CAPACITY_TYPE_SPOT,
                    price=spot,
                    available=True,
                )
            )
    return out
