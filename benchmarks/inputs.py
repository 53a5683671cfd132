"""The benchmark's inputs as plain data, made from the seed.

Both sides read these: the harness builds the program's objects from them
(`benchmarks/program.py`), and the plain reference (`benchmarks/reference/`)
derives everything it needs from them again.  Nothing here imports the
program.

- `machine_shapes`: the fake cloud's synthetic catalog, copied from its
  generator (families, generations, sizes, on-demand prices), one dict a
  machine shape with the keys of the program's ``MachineShape``.
- `pending_pod`: config 2's pod formula (``BASELINE.json`` config 2):
  80 cpu sizes x 4 memory ratios, four nodeSelector variants, 30 % on the
  tainted ``dedicated`` pool.
- `config2_batch`: the config's pending pods in a seeded order.
- `live_cluster`: seeded live nodes of the catalog's types in the
  ``general`` pool, each holding a seeded number of bound pods of the mix;
- `churned`: a live cluster with a seeded set of bound pods replaced.

A pod is ``{"name", "cpu", "memory", "selector", "tolerations"}`` (memory
in bytes, tolerations as ``(key, value, effect)`` triples); a node is
``{"name", "type", "zone", "pool", "capacity_type", "pods"}``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

ZONES = ("zone-a", "zone-b", "zone-c")
REGION = "region-1"
SPOT_DISCOUNT = 0.3  # the fake cloud's spot price = on-demand x this
LABEL_ARCH = "kubernetes.io/arch"
LABEL_CATEGORY = "karpenter.tpu/instance-category"
LABEL_NODEPOOL = "karpenter.sh/nodepool"
ON_DEMAND = "on-demand"

# family -> (category, GiB of memory a cpu, $ a cpu-hour, arch, accelerators
# a 8 cpus): the fake cloud's table
FAMILY_SPECS = {
    "std": ("general", 4, 0.048, "amd64", 0),
    "cpu": ("compute", 2, 0.042, "amd64", 0),
    "mem": ("memory", 8, 0.062, "amd64", 0),
    "arm": ("general", 4, 0.038, "arm64", 0),
    "armc": ("compute", 2, 0.034, "arm64", 0),
    "gpu": ("accelerated", 8, 0.35, "amd64", 1),
    "tpu": ("accelerated", 16, 0.30, "amd64", 2),
}
SIZE_NAMES = {
    1: "small", 2: "medium", 4: "large", 8: "xlarge", 16: "2xlarge",
    32: "4xlarge", 48: "6xlarge", 64: "8xlarge", 96: "12xlarge",
    128: "16xlarge", 192: "24xlarge",
}


def size_name(cpu: int) -> str:
    return SIZE_NAMES.get(cpu, f"{cpu}cpu")


def machine_shapes(families: Sequence[str], generations: Sequence[int],
                   cpus: Sequence[int]) -> List[dict]:
    """The fake cloud's deterministic catalog: newer generations ~5 %
    cheaper, ~10 % more network bandwidth."""
    out = []
    for fam in families:
        category, mem_per_cpu, price_per_cpu, arch, accels_per_8 = FAMILY_SPECS[fam]
        for gen in generations:
            for cpu in cpus:
                if fam in ("gpu", "tpu") and cpu < 4:
                    continue
                price = cpu * price_per_cpu * (0.95 ** (gen - 1))
                accel = (cpu // 8) * accels_per_8 if accels_per_8 else 0
                if fam in ("gpu", "tpu"):
                    accel = max(accel, 1)
                is_tpu = fam == "tpu"
                out.append(dict(
                    name=f"{fam}{gen}.{size_name(cpu)}",
                    cpu=float(cpu),
                    memory=cpu * mem_per_cpu * 2**30,
                    arch=arch,
                    category=category,
                    family=f"{fam}{gen}",
                    generation=gen,
                    size=size_name(cpu),
                    gpu_count=0 if is_tpu or not accel else accel,
                    gpu_name="gpu-a" if accel and not is_tpu else "",
                    tpu_chips=accel if is_tpu else 0,
                    accelerator_name=f"tpu-v{4 + gen}e" if is_tpu else "",
                    accelerator_manufacturer="tpu-vendor" if is_tpu else "",
                    network_bandwidth=min(100.0, cpu / 4 * (1.1 ** (gen - 1))),
                    max_pods=min(110, max(8, 3 * cpu + 2)),
                    od_price=round(price, 5),
                ))
    return out


def spot_prices(shapes: Sequence[dict]) -> Dict[tuple, float]:
    """The spot table after the operator's start-up price refresh."""
    return {(s["name"], z): s["od_price"] * SPOT_DISCOUNT for s in shapes for z in ZONES}


def pending_pod(mix: dict, i: int, name: str) -> dict:
    """Pod ``i`` of config 2's formula, named ``name``."""
    steps = mix["cpu_steps"]
    cpu = mix["cpu_step"] * (1 + i % steps)
    ratios = mix["memory_ratios"]
    mem_gib = max(mix["min_memory_gib"], cpu * ratios[(i // steps) % len(ratios)])
    variant = i % 10
    if variant < mix["general_of_10"]:
        selector = dict(mix["selectors"][variant % len(mix["selectors"])])
        tolerations = ()
    else:
        selector = {LABEL_NODEPOOL: mix["dedicated_pool"]}
        tolerations = tuple(tuple(t) for t in mix["tolerations"])
    return dict(name=name, cpu=round(cpu, 2), memory=float(int(mem_gib * 1024) * 2**20),
                selector=selector, tolerations=tolerations)


def config2_batch(mix: dict, rng: np.random.Generator, tag: str) -> List[dict]:
    """All of the config's pending pods, in a seeded order: every batch has
    the same sizes and classes, only their order and names differ."""
    order = rng.permutation(mix["pods"])
    return [pending_pod(mix, int(i), f"{tag}-{j}") for j, i in enumerate(order)]


def bound_pod(mix: dict, rng: np.random.Generator, name: str) -> dict:
    """A bound pod: a pod of config 2's general-pool mix (its nodeSelector
    kept), drawn from the seed."""
    while True:
        p = pending_pod(mix, int(rng.integers(mix["pods"])), name)
        if not p["tolerations"]:
            return p


def fits(shape: dict, pods: Sequence[dict]) -> bool:
    """Whether ``pods`` fit the machine's allocatable cpu, memory and pod
    slots."""
    from benchmarks.reference.solve import allocatable

    cpu, mem, slots = allocatable(shape)
    return (sum(p["cpu"] for p in pods) <= cpu and sum(p["memory"] for p in pods) <= mem
            and len(pods) <= slots)


def admits(shape: dict, pod: dict) -> bool:
    """Whether a machine's labels admit a bound pod's nodeSelector."""
    labels = {LABEL_ARCH: shape["arch"], LABEL_CATEGORY: shape["category"]}
    return all(labels.get(k) == v for k, v in pod["selector"].items())


def live_cluster(cluster: dict, mix: dict, shapes: Sequence[dict],
                 rng: np.random.Generator) -> List[dict]:
    """``cluster["nodes"]`` live nodes: node i of a seeded type of the
    catalog, in zone ``ZONES[i % 3]``, on demand, in the cluster's pool,
    holding a seeded ``per_node`` range of bound pods of ``mix``, bound by first fit
    in draw order and given up after ``misses`` draws in a row that do
    not fit."""
    by_name = {s["name"]: s for s in shapes}
    types = [s["name"] for s in shapes]
    lo, hi = cluster["per_node"]
    nodes = []
    for i in range(cluster["nodes"]):
        t = types[int(rng.integers(len(types)))]
        name = f"node-{i}"
        pods: List[dict] = []
        want, misses, j = int(rng.integers(lo, hi + 1)), 0, 0
        while len(pods) < want and misses < cluster["misses"]:
            p = bound_pod(mix, rng, f"{name}-{j}")
            j += 1
            if admits(by_name[t], p) and fits(by_name[t], pods + [p]):
                pods.append(p)
                misses = 0
            else:
                misses += 1
        nodes.append(dict(name=name, type=t, zone=ZONES[i % len(ZONES)],
                          pool=cluster["pool"], capacity_type=ON_DEMAND, pods=pods))
    return nodes


def churned(mix: dict, base: List[dict], shapes: Sequence[dict],
            rng: np.random.Generator, n: int, tag: str) -> List[dict]:
    """``base`` with ``n`` seeded bound pods deleted and ``n`` new pods of
    the mix bound, each by first fit over the nodes from a seeded one.
    Every call starts again from ``base``, so the cluster's load is the
    same in every pass however many passes a run makes.  New node dicts
    where anything changed, ``base``'s own elsewhere."""
    by_name = {s["name"]: s for s in shapes}
    out = list(base)
    holders = [i for i, nd in enumerate(out) if nd["pods"]]
    for i in rng.choice(holders, size=min(n, len(holders)), replace=False):
        nd = out[int(i)]
        pods = list(nd["pods"])
        del pods[int(rng.integers(len(pods)))]
        out[int(i)] = dict(nd, pods=pods)
    for j in range(n):
        p = bound_pod(mix, rng, f"{tag}{j}")
        start = int(rng.integers(len(out)))
        for step in range(len(out)):
            i = (start + step) % len(out)
            nd = out[i]
            shape = by_name[nd["type"]]
            if admits(shape, p) and fits(shape, nd["pods"] + [p]):
                out[i] = dict(nd, pods=nd["pods"] + [p])
                break
    return out
