"""The program under test, as the harness drives it: its objects built from
the benchmark's plain inputs, and its results read back as plain data.

This is the one module of the harness that imports the program
(``karpenter_tpu_torch``), and it imports only the system under test: its
API objects, its instance-type build and its scheduler.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from benchmarks import inputs as I
from benchmarks.reference.solve import allocatable, node_labels


def pools(config: dict):
    from karpenter_tpu_torch.api import NodePool, Taint

    return [NodePool(name=p["name"], node_class_ref="default",
                     taints=[Taint(key=k, value=v, effect=e) for k, v, e in p.get("taints", ())])
            for p in config["pools"]]


def inventory(config: dict, shapes: Sequence[dict], node_pools) -> Dict[str, list]:
    """Each pool's instance types as the program's instance-type provider
    builds them from the raw shapes and prices."""
    from karpenter_tpu_torch.cloud.fake.catalog import MachineShape
    from karpenter_tpu_torch.providers.instancetype import SeedPrices, build_instance_types

    ms = [MachineShape(**s) for s in shapes]
    prices = SeedPrices.from_shapes(ms, I.spot_prices(shapes))
    return {p.name: build_instance_types(ms, I.ZONES, I.REGION, prices, pool=p) for p in node_pools}


def pod(raw: dict, **kw):
    from karpenter_tpu_torch.api import Pod, Resources, Toleration

    return Pod(name=raw["name"], requests=Resources(cpu=raw["cpu"], memory=raw["memory"]),
               node_selector=dict(raw["selector"]),
               tolerations=[Toleration(key=k, value=v, effect=e) for k, v, e in raw["tolerations"]],
               **kw)


def state_node(raw: dict, shape: dict):
    """A live node holding its bound pods, their requests counted in its
    usage."""
    from karpenter_tpu_torch.api import Resources
    from karpenter_tpu_torch.state.cluster import StateNode

    bound = [pod(p, node_name=raw["name"], phase="Running") for p in raw["pods"]]
    used = Resources()
    for p in bound:
        used = used + p.requests
    cpu, mem, npods = allocatable(shape)
    return StateNode(name=raw["name"], provider_id=f"i-{raw['name']}",
                     labels=node_labels(raw, shape), taints=[],
                     allocatable=Resources({"cpu": cpu, "memory": mem, "pods": npods}),
                     pods=bound, used=used)


def cluster(nodes: Sequence[dict], shapes: Sequence[dict]) -> List:
    by_name = {s["name"]: s for s in shapes}
    return [state_node(n, by_name[n["type"]]) for n in nodes]


def canonical(result) -> tuple:
    """A solve's `SchedulingResult` as plain data: each new node's pool,
    types, zone options, capacity type and pod names; the existing
    placements by pod name; the unschedulable pods by name."""
    nodes = []
    for vn in result.new_nodes:
        ct = next((r.single_value() for r in vn.requirements
                   if r.key == "karpenter.sh/capacity-type"), None)
        nodes.append((vn.pool.name, tuple(t.name for t in vn.feasible_types),
                      tuple(sorted(vn.zone_options())), ct,
                      tuple(sorted(p.name for p in vn.pods))))
    strip = lambda key: key.split("/", 1)[1]
    return (sorted(nodes), sorted((strip(k), v) for k, v in result.existing_placements.items()),
            sorted(strip(k) for k in result.unschedulable))
