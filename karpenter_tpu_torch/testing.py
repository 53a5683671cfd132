"""Fixtures for the port: pools, the synthetic catalog, the bench problems.

The counterpart of ``karpenter_tpu/testing.py``'s `Environment` for what
the solve reads: a default pool, instance types over `generate_catalog`
in zones ``zone-a/b/c`` of ``region-1``, the two north-star problems of
``bench.py`` (`build_problem`, `build_heterogeneous`) with a ``scale`` on
the pod count, a cluster of live nodes, pack inputs on which the scan's
int32 sums wrap, pack inputs on which the new-node choice must break ties
by first index, and live clusters whose nodes hold bound pods, for the
consolidation verdicts (`consolidation_cluster`, `settled_cluster`,
`ranked_candidates`).

Prices are those the reference environment serves after its operator's
start-up price refresh: on-demand from the shapes' seed prices, spot at the
fake cloud's default discount of the on-demand price in every zone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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
from karpenter_tpu_torch.state.cluster import StateNode

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


def live_cluster(n: int) -> List[StateNode]:
    """``n`` running nodes of 4 vCPU / 16 GiB spread over the zones, none
    carrying a pool label: what a batch of pending pods meets in a cluster
    of that size."""
    return [
        StateNode(
            name=f"node-{i}",
            provider_id=f"i-{i}",
            labels={
                L.LABEL_ARCH: "amd64",
                L.LABEL_OS: "linux",
                L.LABEL_ZONE: ZONES[i % len(ZONES)],
            },
            taints=[],
            allocatable=Resources(cpu=4, memory="16Gi", pods=110),
        )
        for i in range(n)
    ]


def wrap_arrays(k_slots: int = 256, classes: int = 10, at: int = 0) -> tuple:
    """Pack inputs (numpy, in `pack_reference`'s order) on which the scan's
    int32 sums wrap, as ``_pack_core``'s do.  Slots ``at`` .. ``at`` + 3
    are prefilled and the first free slot is ``at`` + 4.  Classes 0-7
    request no axis, so 2^30 copies fit each of the four prefilled feasible
    slots: the fourth one's prefix, 3 x 2^30, wraps to -2^30 and it takes
    2^30 pods, the class's leftover count goes negative and its window of
    new slots has negative length, so the first free slot steps down by one
    per class, to ``at`` - 4.  Class 8 (cpu and memory) then opens its
    window from there, over the first prefilled slots; class 9 is capped at
    3 a node.  With ``at`` = 0 that window starts below slot 0; with ``at``
    = k_slots / 2 - 2 the prefilled slots straddle slot k_slots / 2, the
    boundary between two CTAs of the cluster scan.  ``classes`` keeps the
    first that many."""
    rng = np.random.default_rng(7)
    G, C, R, S, E = 10, 8, 6, 8, 4
    big = 2**30
    req = np.zeros((G, R), np.float32)
    req[8, :2] = (1.0, 2.0)
    req[9, :2] = (0.5, 0.25)
    cnt = np.array([5, 6, 7, 8, 9, 10, 11, 12, 400, 7], np.int32)
    maxper = np.array([big] * 9 + [3], np.int32)
    slot = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0, 1], np.int32)
    feas = np.ones((G, C), bool)
    feas[9, 5:] = False
    alloc = np.tile(np.array([8, 32, 110, 0, 0, 0], np.float32), (C, 1))
    alloc[:, 0] *= np.arange(1, C + 1, dtype=np.float32)
    alloc[:, 1] *= np.arange(1, C + 1, dtype=np.float32)
    price = (np.arange(1, C + 1) * 0.1 + rng.random(C) * 0.01).astype(np.float32)
    openable = np.ones(C, bool)
    used0 = np.zeros((k_slots, R), np.float32)
    cfg0 = np.full(k_slots, -1, np.int32)
    pre = slice(at, at + E)
    cfg0[pre] = (0, 3, 1, 2)
    used0[pre, :2] = ((2, 4), (1, 8), (0.5, 1), (3, 3))
    npods0 = np.zeros(k_slots, np.int32)
    npods0[pre] = (2, 1, 1, 3)
    sig0 = np.zeros((S, k_slots), np.int32)
    g = slice(0, classes)
    return (req[g], cnt[g], maxper[g], slot[g], feas[g], alloc, price, openable,
            used0, cfg0, npods0, at + E, sig0)


def _quad_config(m: int, t: int, i: int) -> int:
    """The config that thread ``t`` of the ``choose_config`` kernel (256
    threads) holds as config ``i`` of its ``m``-th quad: quads t, t + 256,
    t + 512, ... of 4 configs each."""
    return 4 * (m * 256 + t) + i


def tie_arrays(configs: int = 4096, k_slots: int = 256) -> tuple:
    """Pack inputs (numpy, in `pack_reference`'s order) on which the
    new-node choice has to pick the first of equal scores, both objectives.

    - Class 0: duplicate alloc rows and prices (a config four times larger
      than any other, at one price) at configs that the card's kernel holds
      in different threads, warps and quads, four in every 4096 configs:
      the lowest index must win.
    - Class 1 (cpu only): a cost tie, price 2 on 2 pods at the higher index
      against price 1 on 1 pod at the lower; the other configs it fits
      cost more a pod.
    - Class 2 fits no config (c_star 0, new_ok 0); class 3 has ``maxper``
      0 (c_star 0, new_ok 0, per 1).
    - Classes 4-9: random requests and feasibility.

    ``configs`` is a multiple of 4096."""
    if configs % 4096:
        raise ValueError(f"configs={configs} is not a multiple of 4096")
    rng = np.random.default_rng(11)
    G, C, R, S = 10, configs, 6, 4
    c = np.arange(C)
    cpu = (2 + c % 61).astype(np.float32)
    alloc = np.zeros((C, R), np.float32)
    alloc[:, 0] = cpu
    alloc[:, 1] = cpu * (2 + 2 * (c % 4))
    alloc[:, 2] = 110
    price = (cpu * 0.05 + alloc[:, 1] * 0.004 + rng.random(C) * 0.01).astype(np.float32)
    openable = rng.random(C) < 0.9
    feas = rng.random((G, C)) < 0.5
    req = np.zeros((G, R), np.float32)
    req[:, :3] = rng.choice([0.25, 0.5, 1.0, 2.0], size=(G, 3))
    req[:, 2] = 1.0  # pods
    maxper = np.full(G, 2**30, np.int32)
    maxper[7] = 3
    # class 0: the first of four equal champions wins
    dups = [_quad_config(4 * b + k, t, i) for b in range(C // 4096)
            for k, t, i in ((0, 3, 1), (1, 40, 2), (2, 130, 0), (3, 255, 3))]
    alloc[dups] = (500.0, 2000.0, 1000.0, 0.0, 0.0, 0.0)
    price[dups] = 7.0
    openable[dups] = True
    req[0, :3] = (1.0, 1.0, 1.0)
    feas[0, dups] = True
    # class 1: price 2 / cap 2 (higher index) ties price 1 / cap 1 (lower)
    a, b, worse = _quad_config(1, 5, 2), _quad_config(0, 9, 1), _quad_config(2, 17, 3)
    alloc[[a, b, worse], :3] = ((8.0, 16.0, 110.0), (4.0, 8.0, 110.0), (12.0, 24.0, 110.0))
    price[[a, b, worse]] = (2.0, 1.0, 4.0)
    openable[[a, b, worse]] = True
    req[1] = (4.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    feas[1] = False
    feas[1, [a, b, worse]] = True
    feas[2] = False  # class 2 fits nothing
    maxper[3] = 0  # class 3 holds no pod anywhere
    cnt = rng.integers(5, 60, G).astype(np.int32)
    slot = (np.arange(G) % S).astype(np.int32)
    used0 = np.zeros((k_slots, R), np.float32)
    cfg0 = np.full(k_slots, -1, np.int32)
    cfg0[:2] = (5, 17)
    used0[:2, :3] = ((2.0, 4.0, 3.0), (1.0, 1.0, 1.0))
    npods0 = np.zeros(k_slots, np.int32)
    npods0[:2] = (3, 1)
    sig0 = np.zeros((S, k_slots), np.int32)
    return (req, cnt, maxper, slot, feas, alloc, price, openable,
            used0, cfg0, npods0, 2, sig0)


def first_configs(args: tuple, n: int) -> tuple:
    """Pack inputs (numpy, in `pack_reference`'s order) cut to their first
    ``n`` configs (every prefilled slot's config must be below ``n``)."""
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    return (req, cnt, maxper, slot, np.ascontiguousarray(feas[:, :n]), alloc[:n].copy(),
            price[:n].copy(), openable[:n].copy(), used0, cfg0, npods0, next0, sig0)


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


# ---------------------------------------------------------------------------
# Live clusters for the consolidation verdicts
# ---------------------------------------------------------------------------

# the pod sizes of bench.py's consolidation configs (4b, 4c)
BOUND_SIZES = (
    Resources(cpu=0.5, memory="1Gi"),
    Resources(cpu=1, memory="2Gi"),
)


def node_of_type(
    name: str, it: InstanceType, zone: str, pool: str,
    capacity_type: str = L.CAPACITY_TYPE_ON_DEMAND, pods: Sequence[Pod] = (),
) -> StateNode:
    """A live node of instance type ``it`` in ``zone`` holding ``pods``
    (their requests counted in its usage)."""
    used = Resources()
    for p in pods:
        used = used + p.requests
    return StateNode(
        name=name,
        provider_id=f"i-{name}",
        labels={
            L.LABEL_ARCH: "amd64",
            L.LABEL_OS: "linux",
            L.LABEL_ZONE: zone,
            L.LABEL_NODEPOOL: pool,
            L.LABEL_INSTANCE_TYPE: it.name,
            L.LABEL_CAPACITY_TYPE: capacity_type,
            L.LABEL_HOSTNAME: name,
        },
        taints=[],
        allocatable=it.allocatable(),
        capacity=it.capacity,
        pods=list(pods),
        used=used,
    )


def ranked_candidates(existing: Sequence[StateNode]) -> list:
    """Every node as a `RemovalCandidate` (its bound pods to reschedule),
    ranked as consolidation ranks them: fewest pods first, then node
    order."""
    from karpenter_tpu_torch.scheduling.solver import RemovalCandidate

    order = sorted(range(len(existing)), key=lambda i: (len(existing[i].pods), i))
    return [RemovalCandidate(existing[i].name, tuple(existing[i].pods)) for i in order]


def consolidation_cluster(
    seed: int,
    nodes: int,
    types: Sequence[InstanceType],
    pool: str = "general",
    per_node: Tuple[int, int] = (1, 4),
    sizes: Sequence[Resources] = BOUND_SIZES,
) -> Tuple[List[StateNode], list]:
    """A live cluster, deterministic from ``seed`` (numpy's generator):
    node i is ``node-i`` of a seeded type of ``types`` in zone ``ZONES[i %
    3]``, on demand, in ``pool``, holding those of a seeded ``per_node[0]``
    to ``per_node[1]`` bound pods of seeded ``sizes`` (``node-i-j``) that
    fit it.
    Returns ``(existing, ranked_candidates(existing))``."""
    rng = np.random.RandomState(seed)
    existing = []
    for i in range(nodes):
        it = types[rng.randint(len(types))]
        name = f"node-{i}"
        pods, used = [], Resources()
        for j in range(rng.randint(per_node[0], per_node[1] + 1)):
            pod = Pod(name=f"{name}-{j}", requests=sizes[rng.randint(len(sizes))],
                      node_name=name, phase="Running")
            if (used + pod.requests).fits(it.allocatable()):
                pods.append(pod)
                used = used + pod.requests
        existing.append(node_of_type(name, it, ZONES[i % len(ZONES)], pool, pods=pods))
    return existing, ranked_candidates(existing)


def settled_cluster(result) -> List[StateNode]:
    """A solve's new nodes as live nodes holding their pods, as they stand
    once launched and bound: node i of the node's committed type (its first
    feasible type), zone and capacity type."""
    out = []
    for i, vn in enumerate(result.new_nodes):
        name = f"node-{i}"
        ct = next(
            r.single_value() for r in vn.requirements if r.key == L.LABEL_CAPACITY_TYPE
        )
        pods = [dataclasses.replace(p, node_name=name, phase="Running") for p in vn.pods]
        out.append(node_of_type(
            name, vn.feasible_types[0], sorted(vn.zone_options())[0], vn.pool.name,
            ct, pods,
        ))
    return out


def node_prices(
    existing: Sequence[StateNode], inventory: Dict[str, List[InstanceType]],
) -> List[float]:
    """Each node's price: its type's offering in its zone and capacity
    type, from its pool's inventory."""
    out = []
    for sn in existing:
        it = next(t for t in inventory[sn.pool_name] if t.name == sn.instance_type_name)
        out.append(next(
            o.price for o in it.offerings
            if o.zone == sn.zone and o.capacity_type == sn.capacity_type
        ))
    return out


def consolidation_sweep(pods: int = 560, device="cpu"):
    """The cluster of ``bench.py``'s consolidation configs (4b, 4c): ``pods``
    pods alternating 0.5 vCPU / 1 GiB and 1 vCPU / 2 GiB over the
    two-generation catalog of 4 and 8 vCPU shapes, solved cold by the port
    on ``device``; the nodes it opens become the live cluster, every node a
    candidate.  Returns ``(pools, inventory, existing, candidates)``."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pool = default_node_pool()
    shapes = generate_catalog(generations=(1, 2), cpus=(4, 8))
    inventory = {pool.name: instance_types(pool, shapes)}
    batch = [Pod(requests=BOUND_SIZES[i % 2]) for i in range(pods)]
    result = TorchScheduler([pool], inventory, device=device).solve(batch)
    existing = settled_cluster(result)
    return [pool], inventory, existing, ranked_candidates(existing)
