"""InstanceType provider: catalog + offerings + overhead -> InstanceTypes.

Port of ``karpenter_tpu/providers/instancetype.py``.  The build itself
(`build_instance_type`, `_capacity`, `_requirements`, `_offerings`,
`kube_reserved_*`) is a set of pure functions: shapes x zones x a region x
prices -> `InstanceType`s, offerings masked by an optional ICE cache.
`build_instance_types` calls them directly over seed prices (the solve
tests' catalog); `InstanceTypeProvider` is the reference's provider class,
its TTL cache, gauges and zone resolution, building through the same
functions.

Prices follow ``karpenter_tpu/providers/pricing.py``: on-demand from the
shapes' seed prices, spot per (type, zone) from a refreshed table, falling
back to on-demand until a refresh has landed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import (
    InstanceType,
    NodeClass,
    NodePool,
    Offering,
    Offerings,
    Overhead,
    Requirement,
    Requirements,
    Resources,
    Settings,
)
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.requirements import Op
from karpenter_tpu_torch.cache.ttl import INSTANCE_TYPES_ZONES_TTL, TTLCache
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud
from karpenter_tpu_torch.cloud.fake.catalog import MachineShape
from karpenter_tpu_torch.providers.pricing import PricingProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.utils.clock import Clock

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


class InstanceTypeProvider:
    def __init__(
        self,
        cloud: FakeCloud,
        pricing: PricingProvider,
        subnets: SubnetProvider,
        unavailable: UnavailableOfferings,
        settings: Settings,
        clock: Clock,
        registry=None,
    ):
        self.cloud = cloud
        self.pricing = pricing
        self.subnets = subnets
        self.unavailable = unavailable
        self.settings = settings
        self._cache = TTLCache(clock, INSTANCE_TYPES_ZONES_TTL)
        self.catalog_seq = 0  # bump when the catalog changes
        if registry is None:
            from karpenter_tpu_torch.metrics.registry import REGISTRY as registry
        self.registry = registry
        # (metric, label tuple) keys this provider has emitted, so stale
        # series for types/offerings that left the catalog get pruned
        self._exported: set = set()
        self._export_epoch: tuple = ()

    # ------------------------------------------------------------------ list
    def list(
        self, pool: Optional[NodePool] = None, node_class: Optional[NodeClass] = None
    ) -> List[InstanceType]:
        """All instance types with offerings restricted to the node class's
        resolved subnets' zones (reference instancetype.go:85-121)."""
        zones = self._zones(node_class)
        max_pods = pool.kubelet_max_pods if pool is not None else None
        pods_per_core = pool.kubelet_pods_per_core if pool is not None else None
        reserved = (
            (
                pool.kubelet_kube_reserved,
                pool.kubelet_system_reserved,
                pool.kubelet_eviction_hard,
            )
            if pool is not None
            else (None, None, None)
        )
        key = (
            tuple(sorted(zones)),
            max_pods,
            pods_per_core,
            tuple(None if r is None else tuple(sorted(r.items())) for r in reserved),
            self.catalog_seq,
            self.unavailable.seq_num,
        )
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        shapes = {s.name: s for s in self.cloud.describe_instance_types()}
        offered = self.cloud.describe_instance_type_offerings()
        zones_by_type: Dict[str, List[str]] = {}
        for t, z in offered:
            if z in zones:
                zones_by_type.setdefault(t, []).append(z)
        out = [
            self._build(
                shape, zones_by_type.get(name, []), max_pods, reserved,
                pods_per_core,
            )
            for name, shape in sorted(shapes.items())
        ]
        self._cache.set(key, out)
        self._export_gauges(out)
        return out

    def _export_gauges(self, types: List[InstanceType]) -> None:
        """Per-type vCPU/memory/price gauges (reference
        pkg/providers/instancetype/metrics.go:1-56).  The emitted key set
        is tracked so series for types/offerings no longer in the catalog
        are pruned (a family-wide reset would be wrong: different node
        classes legitimately emit different zone subsets)."""
        emitted: set = set()

        def put(metric: str, value: float, labels: dict) -> None:
            self.registry.set(metric, value, labels)
            emitted.add((metric, tuple(sorted(labels.items()))))

        for it in types:
            label = {"instance_type": it.name}
            put(
                "karpenter_cloudprovider_instance_type_cpu_cores",
                it.capacity.cpu,
                label,
            )
            put(
                "karpenter_cloudprovider_instance_type_memory_bytes",
                it.capacity.memory,
                label,
            )
            for off in it.offerings:
                put(
                    "karpenter_cloudprovider_instance_type_price_estimate",
                    off.price,
                    {
                        "instance_type": it.name,
                        "capacity_type": off.capacity_type,
                        "zone": off.zone,
                    },
                )
        # prune only when the CATALOG changed: within one epoch, calls for
        # different node classes legitimately emit different zone subsets,
        # and their union is the live series set
        epoch = (self.catalog_seq, self.unavailable.seq_num)
        if epoch != self._export_epoch:
            for metric, key in self._exported - emitted:
                self.registry.unset(metric, dict(key))
            self._exported = emitted
            self._export_epoch = epoch
        else:
            self._exported |= emitted

    def _zones(self, node_class: Optional[NodeClass]) -> List[str]:
        if node_class is not None and node_class.subnet_selector_terms:
            subnets = self.subnets.list(node_class)
            return sorted({s.zone for s in subnets})
        return list(self.cloud.zones)

    # ----------------------------------------------------------------- build
    def _build(
        self,
        shape: MachineShape,
        zones: Sequence[str],
        max_pods_override: Optional[int],
        reserved_overrides: tuple = (None, None, None),
        pods_per_core: Optional[int] = None,
    ) -> InstanceType:
        return build_instance_type(
            shape, zones, max_pods_override, reserved_overrides,
            pods_per_core, region=self.cloud.region, prices=self.pricing,
            unavailable=self.unavailable,
            vm_overhead=self.settings.vm_memory_overhead_percent,
        )


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
    prices,
    unavailable: Optional[UnavailableOfferings] = None,
    vm_overhead: float = VM_MEMORY_OVERHEAD_PERCENT,
) -> InstanceType:
    """One shape's InstanceType (``InstanceTypeProvider._build``).
    ``prices`` answers ``on_demand_price(type)`` and ``spot_price(type,
    zone)`` (`SeedPrices` or the `PricingProvider`); ``unavailable``
    masks the offerings the ICE cache holds."""
    max_pods = (
        max_pods_override if max_pods_override is not None else shape.max_pods
    )
    if pods_per_core:
        # dynamic pod density (reference pod-density.md:43): density
        # scales with the instance's logical cores, capped by maxPods
        max_pods = min(max_pods, int(pods_per_core * shape.cpu))
    capacity = _capacity(shape, max_pods, vm_overhead)
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
        offerings=_offerings(shape, zones, prices, unavailable),
    )


def _capacity(
    shape: MachineShape, max_pods: int,
    vm_overhead: float = VM_MEMORY_OVERHEAD_PERCENT,
) -> Resources:
    q = {
        L.RESOURCE_CPU: shape.cpu,
        # VM overhead shaves reported memory (types.go:196-206)
        L.RESOURCE_MEMORY: shape.memory
        * (1 - vm_overhead),
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
    shape: MachineShape, zones: Sequence[str], prices,
    unavailable: Optional[UnavailableOfferings] = None,
) -> Offerings:
    def available(capacity_type: str, zone: str) -> bool:
        return unavailable is None or not unavailable.is_unavailable(
            capacity_type, shape.name, zone
        )

    out = Offerings()
    for zone in zones:
        od = prices.on_demand_price(shape.name)
        if od is not None:
            out.append(
                Offering(
                    zone=zone,
                    capacity_type=L.CAPACITY_TYPE_ON_DEMAND,
                    price=od,
                    available=available(L.CAPACITY_TYPE_ON_DEMAND, zone),
                )
            )
        spot = prices.spot_price(shape.name, zone)
        if spot is not None:
            out.append(
                Offering(
                    zone=zone,
                    capacity_type=L.CAPACITY_TYPE_SPOT,
                    price=spot,
                    available=available(L.CAPACITY_TYPE_SPOT, zone),
                )
            )
    return out
