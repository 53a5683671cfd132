"""One cluster spec, built in both packages.

The port's parity tests build the same pools, catalogs, live nodes and pods
in the JAX package and in karpenter_tpu_torch from one spec, calling each
package's `reset_name_sequences` first so pod names agree.  `side` gathers
one package's constructors and its tensor scheduler; `build` turns a
scenario name into ``(pools, inventory, existing, pods)`` on that side.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np

SMALL_SHAPES = dict(generations=(1, 2), cpus=(1, 2, 4, 8, 16, 32, 64, 128))


def side(pkg: str) -> SimpleNamespace:
    api = importlib.import_module(f"{pkg}.api")
    objects = importlib.import_module(f"{pkg}.api.objects")
    cluster = importlib.import_module(f"{pkg}.state.cluster")
    s = SimpleNamespace(pkg=pkg, api=api, L=api, objects=objects)
    s.Pod, s.Resources, s.Requirement = api.Pod, api.Resources, api.Requirement
    s.Requirements, s.Op = api.Requirements, api.Op
    s.Taint, s.Toleration = api.Taint, api.Toleration
    s.PodAffinityTerm = objects.PodAffinityTerm
    s.TopologySpreadConstraint = objects.TopologySpreadConstraint
    s.StateNode = cluster.StateNode
    s.reset = objects.reset_name_sequences
    if pkg == "karpenter_tpu":
        from karpenter_tpu.cloud.fake.backend import generate_catalog
        from karpenter_tpu.scheduling import TensorScheduler
        from karpenter_tpu.state.kube import Node
        from karpenter_tpu.testing import Environment

        def catalog(pools, shape_kw):
            env = Environment(shapes=generate_catalog(**shape_kw))
            nc = env.default_node_class()
            return {p.name: env.instance_types.list(p, nc) for p in pools}

        def pool(name, **kw):
            return s.api.NodePool(name=name, node_class_ref="default", **kw)

        scheduler = TensorScheduler
        from karpenter_tpu.scheduling.solver import RemovalCandidate
    else:
        from karpenter_tpu_torch import testing as T
        from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog
        from karpenter_tpu_torch.scheduling.solver import TorchScheduler
        from karpenter_tpu_torch.state.kube import Node

        def catalog(pools, shape_kw):
            shapes = generate_catalog(**shape_kw)
            return {p.name: T.instance_types(p, shapes) for p in pools}

        pool = T.default_node_pool

        def scheduler(pools, inventory, **kw):
            return TorchScheduler(pools, inventory, device="cpu", **kw)

        from karpenter_tpu_torch.scheduling.solver import RemovalCandidate

    s.catalog, s.pool, s.Node = catalog, pool, Node
    s.RemovalCandidate = RemovalCandidate
    # the side's tensor scheduler (the port's on the CPU)
    s.scheduler = scheduler
    return s


def _sizes(s):
    R = s.Resources
    return [
        R(cpu=0.25, memory="512Mi"),
        R(cpu=0.5, memory="1Gi"),
        R(cpu=1, memory="2Gi"),
        R(cpu=2, memory="8Gi"),
        R(cpu=3, memory="4Gi"),
    ]


def _tensor_mix(s):
    """Pods the tensor path expresses: sizes, node selectors, a zone
    requirement, a tainted pool with tolerating pods, a hostname
    anti-affinity group, a zone spread group and a co-location pair."""
    L = s.L
    general = s.pool("general")
    dedicated = s.pool(
        "dedicated",
        taints=[s.Taint(key="dedicated", value="batch", effect="NoSchedule")],
    )
    pools = [general, dedicated]
    sizes = _sizes(s)
    tol = [s.Toleration(key="dedicated", value="batch", effect="NoSchedule")]
    pods = []
    for i in range(120):
        p = s.Pod(requests=sizes[i % len(sizes)])
        if i % 4 == 1:
            p.node_selector = {L.LABEL_ARCH: "arm64"}
        if i % 6 == 2:
            p.node_selector = {L.LABEL_INSTANCE_CATEGORY: "memory"}
        if i % 5 == 3:
            p.required_affinity = [
                s.Requirement(L.LABEL_ZONE, s.Op.IN, ["zone-a", "zone-b"])
            ]
        if i % 7 == 4:
            p.tolerations = list(tol)
            p.node_selector = {L.LABEL_NODEPOOL: "dedicated"}
        pods.append(p)
    anti = (("app", "solo"),)
    pods += [
        s.Pod(
            labels={"app": "solo"},
            requests=s.Resources(cpu=0.5, memory="1Gi"),
            pod_affinity=[
                s.PodAffinityTerm(
                    topology_key=L.LABEL_HOSTNAME, label_selector=anti, anti=True
                )
            ],
        )
        for _ in range(6)
    ]
    spread = (("app", "web"),)
    pods += [
        s.Pod(
            labels={"app": "web"},
            requests=s.Resources(cpu=1, memory="1Gi"),
            topology_spread=[
                s.TopologySpreadConstraint(
                    max_skew=1, topology_key=L.LABEL_ZONE, label_selector=spread
                )
            ],
        )
        for _ in range(9)
    ]
    pair = (("app", "pair"),)
    pods += [
        s.Pod(
            labels={"app": "pair"},
            requests=s.Resources(cpu=0.5, memory="512Mi"),
            pod_affinity=[
                s.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME, label_selector=pair)
            ],
        )
        for _ in range(2)
    ]
    return pools, pods


def _live_nodes(s, pools, inventory, n=3, bound_label=None):
    """Live nodes of the general pool with a few bound pods each."""
    L = s.L
    types = {it.name: it for it in inventory["general"]}
    it = types["std1.xlarge"]
    out = []
    for i in range(n):
        bound = [
            s.Pod(
                name=f"bound-{i}-{j}",
                labels=dict(bound_label or {}),
                requests=s.Resources(cpu=0.5, memory="1Gi"),
                node_name=f"live-{i}",
                phase="Running",
            )
            for j in range(2)
        ]
        used = s.Resources()
        for bp in bound:
            used = used + bp.requests
        out.append(
            s.StateNode(
                name=f"live-{i}",
                provider_id=f"i-live-{i}",
                labels={
                    L.LABEL_ARCH: "amd64",
                    L.LABEL_OS: "linux",
                    L.LABEL_ZONE: ("zone-a", "zone-b", "zone-c")[i % 3],
                    L.LABEL_NODEPOOL: "general",
                    L.LABEL_INSTANCE_TYPE: it.name,
                    L.LABEL_CAPACITY_TYPE: "on-demand",
                    L.LABEL_HOSTNAME: f"live-{i}",
                },
                taints=[],
                allocatable=it.allocatable(),
                capacity=it.capacity,
                pods=bound,
                used=used,
            )
        )
    return out


def build(s, scenario: str):
    """``(pools, inventory, existing, pods)`` of a scenario on side ``s``."""
    s.reset()
    L = s.L
    if scenario == "tensor":
        pools, pods = _tensor_mix(s)
        return pools, s.catalog(pools, SMALL_SHAPES), [], pods
    if scenario == "hybrid":
        # pod affinity on a custom topology key and a one-sided coupling
        # are oracle-only; preferences that cannot hold go through relax
        pools, pods = _tensor_mix(s)
        rack = (("app", "rackmate"),)
        pods += [
            s.Pod(
                labels={"app": "rackmate"},
                requests=s.Resources(cpu=0.5, memory="1Gi"),
                pod_affinity=[s.PodAffinityTerm(topology_key=L.LABEL_ZONE, label_selector=rack)],
                topology_spread=[
                    s.TopologySpreadConstraint(
                        max_skew=1, topology_key=L.LABEL_HOSTNAME,
                        label_selector=(("app", "web"),),
                    )
                ],
            )
            for _ in range(3)
        ]
        pods += [
            s.Pod(
                requests=s.Resources(cpu=1, memory="2Gi"),
                preferred_affinity=[
                    s.Requirement(L.LABEL_INSTANCE_CATEGORY, s.Op.IN, ["nonexistent"])
                ],
            )
            for _ in range(4)
        ]
        return pools, s.catalog(pools, SMALL_SHAPES), [], pods
    if scenario == "existing":
        # live nodes take plain pods first; a co-location group joins the
        # live node holding its anchor pod
        pools, pods = _tensor_mix(s)
        inventory = s.catalog(pools, SMALL_SHAPES)
        existing = _live_nodes(s, pools, inventory, bound_label={"role": "anchor"})
        anchor = (("role", "anchor"),)
        pods += [
            s.Pod(
                labels={"app": "joiner"},
                requests=s.Resources(cpu=0.25, memory="256Mi"),
                pod_affinity=[
                    s.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME, label_selector=anchor)
                ],
            )
            for _ in range(2)
        ]
        return pools, inventory, existing, pods
    if scenario == "overflow":
        # 600 pods of which each needs a node to itself: the first slot
        # bucket (512, the resident state's bucket(256 + 1)) runs out and
        # the solver retries with twice the slots
        pools = [s.pool("general")]
        pods = [
            s.Pod(requests=s.Resources(cpu=70, memory="8Gi")) for _ in range(600)
        ]
        return pools, s.catalog(pools, SMALL_SHAPES), [], pods
    raise ValueError(scenario)


SCENARIOS = ("tensor", "hybrid", "existing", "overflow")


def canonical(result, L):
    """A `SchedulingResult` as comparable plain data: per new node the pool,
    feasible types, zone options, capacity type and pod names; the existing
    placements; the unschedulable pods."""

    def ct(vn):
        for r in vn.requirements:
            if r.key == L.LABEL_CAPACITY_TYPE:
                return r.single_value()
        return None

    nodes = sorted(
        (
            vn.pool.name,
            tuple(t.name for t in vn.feasible_types),
            tuple(sorted(vn.zone_options())),
            ct(vn),
            tuple(sorted(p.name for p in vn.pods)),
        )
        for vn in result.new_nodes
    )
    return (
        nodes,
        sorted(result.existing_placements.items()),
        sorted(result.unschedulable),
    )


# ---------------------------------------------------------------------------
# Consolidation clusters: live nodes holding bound pods
# ---------------------------------------------------------------------------


def consolidation_sizes(s, mixed: bool):
    """The bound pods' sizes: bench.py's consolidation pair, or (``mixed``)
    two sizes of one FFD sort key (cpu + memory / 4 GiB = 2) beside a
    smaller one, so a subset's class order follows first occurrence."""
    R = s.Resources
    if mixed:
        return [R(cpu=1, memory="4Gi"), R(cpu=1.5, memory="2Gi"), R(cpu=0.5, memory="1Gi")]
    return [R(cpu=0.5, memory="1Gi"), R(cpu=1, memory="2Gi")]


def consolidation_types(inventory):
    """The general pool's 2 and 4 vCPU types, by name."""
    return sorted(
        (it for it in inventory["general"] if it.capacity.get("cpu") in (2.0, 4.0)),
        key=lambda it: it.name,
    )


def consolidation(s, seed: int, nodes: int, mixed: bool = False):
    """``(pools, inventory, existing, candidates)`` of a seeded live cluster
    on side ``s``, the JAX package's and the port's alike: node i is
    ``node-i`` of a seeded 2 or 4 vCPU type of the general pool in zone i %
    3, holding those of a seeded 2-6 bound pods of seeded sizes that fit it;
    every node is a candidate, ranked by pod count, then node order.  The same draws as
    ``karpenter_tpu_torch.testing.consolidation_cluster``."""
    s.reset()
    L = s.L
    pools = [s.pool("general")]
    inventory = s.catalog(pools, SMALL_SHAPES)
    types = consolidation_types(inventory)
    sizes = consolidation_sizes(s, mixed)
    rng = np.random.RandomState(seed)
    existing = []
    for i in range(nodes):
        it = types[rng.randint(len(types))]
        name = f"node-{i}"
        pods, used = [], s.Resources()
        for j in range(rng.randint(2, 7)):
            pod = s.Pod(name=f"{name}-{j}", requests=sizes[rng.randint(len(sizes))],
                        node_name=name, phase="Running")
            if (used + pod.requests).fits(it.allocatable()):
                pods.append(pod)
                used = used + pod.requests
        zone = ("zone-a", "zone-b", "zone-c")[i % 3]
        existing.append(
            s.StateNode(
                name=name,
                provider_id=f"i-{name}",
                labels={
                    L.LABEL_ARCH: "amd64",
                    L.LABEL_OS: "linux",
                    L.LABEL_ZONE: zone,
                    L.LABEL_NODEPOOL: "general",
                    L.LABEL_INSTANCE_TYPE: it.name,
                    L.LABEL_CAPACITY_TYPE: "on-demand",
                    L.LABEL_HOSTNAME: name,
                },
                taints=[],
                allocatable=it.allocatable(),
                capacity=it.capacity,
                pods=pods,
                used=used,
            )
        )
    order = sorted(range(nodes), key=lambda i: (len(existing[i].pods), i))
    candidates = [
        s.RemovalCandidate(existing[i].name, tuple(existing[i].pods)) for i in order
    ]
    return pools, inventory, existing, candidates


def node_content(existing):
    """Live nodes as comparable plain data."""
    return [
        (
            sn.name,
            sorted(sn.labels.items()),
            sorted(sn.allocatable.items()),
            sorted(sn.used.items()),
            [(p.name, sorted(p.requests.items()), p.node_name) for p in sn.pods],
        )
        for sn in existing
    ]
