"""The synthetic machine-shape catalog.

Port copy of the catalog half of ``karpenter_tpu/cloud/fake/backend.py``
(`MachineShape`, `_FAMILY_SPECS`, `_size_name`, `generate_catalog`): the
deterministic shapes and on-demand prices the instance-type build runs over.
``backend.py`` (the rest of the fake cloud) imports them from here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


@dataclass
class MachineShape:
    """Catalog row (analogue of one DescribeInstanceTypes entry)."""

    name: str
    cpu: float
    memory: float  # bytes
    arch: str = "amd64"
    os: str = "linux"
    category: str = "general"  # general | compute | memory | accelerated
    family: str = "std"
    generation: int = 1
    size: str = "large"
    gpu_count: int = 0
    gpu_name: str = ""
    tpu_chips: int = 0
    accelerator_name: str = ""
    accelerator_manufacturer: str = ""
    local_nvme: float = 0.0  # bytes of instance storage
    network_bandwidth: float = 1.0  # Gbps
    max_pods: int = 110
    bare_metal: bool = False
    hypervisor: str = "nitro"
    od_price: float = 0.1  # on-demand $/h


_FAMILY_SPECS = {
    # family -> (category, mem GiB per cpu, $ per cpu-hour, arch, accels/8cpu)
    "std": ("general", 4, 0.048, "amd64", 0),
    "cpu": ("compute", 2, 0.042, "amd64", 0),
    "mem": ("memory", 8, 0.062, "amd64", 0),
    "arm": ("general", 4, 0.038, "arm64", 0),
    "armc": ("compute", 2, 0.034, "arm64", 0),
    "gpu": ("accelerated", 8, 0.35, "amd64", 1),
    "tpu": ("accelerated", 16, 0.30, "amd64", 2),
}

_SIZE_NAMES = {
    1: "small", 2: "medium", 4: "large", 8: "xlarge", 16: "2xlarge",
    32: "4xlarge", 48: "6xlarge", 64: "8xlarge", 96: "12xlarge",
    128: "16xlarge", 192: "24xlarge",
}


def _size_name(cpu: int) -> str:
    return _SIZE_NAMES.get(cpu, f"{cpu}cpu")


def generate_catalog(
    families: Sequence[str] = tuple(_FAMILY_SPECS),
    generations: Sequence[int] = (1, 2, 3),
    cpus: Sequence[int] = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192),
) -> List[MachineShape]:
    """Deterministic synthetic catalog with plausible shapes/prices.

    Newer generations are ~5% cheaper and have ~10% more network bandwidth,
    giving the price-aware scheduler real structure to exploit.
    """
    out: List[MachineShape] = []
    for fam in families:
        category, mem_per_cpu, price_per_cpu, arch, accels_per_8 = _FAMILY_SPECS[fam]
        for gen in generations:
            for cpu in cpus:
                if fam in ("gpu", "tpu") and cpu < 4:
                    continue
                price = cpu * price_per_cpu * (0.95 ** (gen - 1))
                accel_count = (cpu // 8) * accels_per_8 if accels_per_8 else 0
                if fam in ("gpu", "tpu"):
                    accel_count = max(accel_count, 1)
                is_tpu = fam == "tpu"
                out.append(
                    MachineShape(
                        name=f"{fam}{gen}.{_size_name(cpu)}",
                        cpu=float(cpu),
                        memory=cpu * mem_per_cpu * 2**30,
                        arch=arch,
                        category=category,
                        family=f"{fam}{gen}",
                        generation=gen,
                        size=_size_name(cpu),
                        gpu_count=0 if is_tpu or not accel_count else accel_count,
                        gpu_name="gpu-a" if accel_count and not is_tpu else "",
                        tpu_chips=accel_count if is_tpu else 0,
                        accelerator_name=f"tpu-v{4 + gen}e" if is_tpu else "",
                        accelerator_manufacturer="tpu-vendor" if is_tpu else "",
                        network_bandwidth=min(100.0, cpu / 4 * (1.1 ** (gen - 1))),
                        max_pods=min(110, max(8, 3 * cpu + 2)),
                        od_price=round(price, 5),
                    )
                )
    return out
