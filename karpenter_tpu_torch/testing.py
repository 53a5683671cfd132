"""Fixtures for the port: pools, the synthetic catalog, the bench problems,
and the operator's test environment.

The counterpart of ``karpenter_tpu/testing.py``'s `Environment` for what
the solve reads: a default pool, instance types over `generate_catalog`
in zones ``zone-a/b/c`` of ``region-1``, the two north-star problems of
``bench.py`` (`build_problem`, `build_heterogeneous`) with a ``scale`` on
the pod count and its other solve problems (configs 3-5, co-location,
relaxation, the hybrid line, the 100k-pod tick: `affinity_topology_problem`
and the functions beside it, each count scaled as ``bench._n`` scales it),
a cluster of live nodes, pack inputs on which the scan's
int32 sums wrap, pack inputs on which the new-node choice must break ties
by first index, removal-verdict inputs on which the verdict rows must
(`verdict_tie_arrays`), removal-verdict inputs that put the elements'
frontiers in and past the frontier-window scan's window
(`frontier_arrays`), admission inputs at the admission kernel's edges
(`admit_edge_arrays`), live clusters whose nodes hold bound pods, for the
consolidation verdicts (`consolidation_cluster`, `settled_cluster`,
`ranked_candidates`), and for the device mesh a mesh of CPU shards
(`cpu_mesh`), the factorized admission problem of the JAX package's mesh
tests (`mesh_step_problem`) and a deep class axis (`deep_class_pods`).

`Environment` (with `FakeKubelet` and `FAST_BATCH_WINDOWS`) is a copy of
the reference's: the port's `Operator` over the fake cloud, a fake clock
and a kubelet that registers nodes and binds nominated pods, its solver on
``device``.

Prices are those the reference environment serves after its operator's
start-up price refresh: on-demand from the shapes' seed prices, spot at the
fake cloud's default discount of the on-demand price in every zone.
"""

from __future__ import annotations

import dataclasses
import time
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
from karpenter_tpu_torch.api import NodeClass, Settings
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import SelectorTerm, tolerates_all
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud
from karpenter_tpu_torch.cloud.fake.catalog import MachineShape, generate_catalog
from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.operator import Operator, solve_kind, solver_counters
from karpenter_tpu_torch.providers.instancetype import (
    SeedPrices,
    build_instance_types,
)
from karpenter_tpu_torch.state.cluster import StateNode
from karpenter_tpu_torch.state.kube import KubeStore, Node
from karpenter_tpu_torch.utils.clock import FakeClock

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


FLEET_CASES = ("dyadic", "inexact", "wrap")


def fleet_tenant_arrays(case: str, seed: int, k_slots: int = 64) -> tuple:
    """One tenant's pack inputs (numpy, in `pack_reference`'s order) for a
    fleet pack: tenants of one case share every shape (G 24, C 64, R 4, S
    4; wrap: `wrap_arrays`' shapes) and differ, by ``seed``, in every array
    and in the first free slot.

    - ``dyadic``: requests in multiples of 0.25 (binary floats hold every
      sum exactly), sparse feasibility, unopenable configs, 2 to 6
      prefilled slots, capped classes sharing signature rows;
    - ``inexact``: the same with requests in multiples of 0.05 vCPU (config
      2's sizes, which binary floats hold inexactly) and counts in the
      hundreds, so ``used + take * req`` rounds;
    - ``wrap``: `wrap_arrays` (int32 sums that wrap) with the prefilled
      slots at ``seed % 4``, and the prices and the counts of its last two
      classes drawn from the seed."""
    rng = np.random.default_rng(seed)
    if case == "wrap":
        args = list(wrap_arrays(k_slots, at=seed % 4))
        C = args[5].shape[0]
        args[6] = (np.arange(1, C + 1) * 0.1 + rng.random(C) * 0.01).astype(np.float32)
        args[1] = args[1].copy()
        args[1][8] += rng.integers(0, 100)
        args[1][9] += rng.integers(0, 8)
        return tuple(args)
    G, C, R, S, K = 24, 64, 4, 4, k_slots
    if case == "dyadic":
        req = rng.choice([0.0, 0.25, 0.5, 1.0, 1.5, 3.0], size=(G, R)).astype(np.float32)
        req[:, 0] = np.maximum(req[:, 0], 0.25)
        cnt = rng.integers(0, 40, G).astype(np.int32)
        alloc = (rng.integers(1, 17, (C, R)) * 0.5).astype(np.float32)
    elif case == "inexact":
        req = (0.05 * rng.integers(1, 81, (G, R))).astype(np.float32)
        cnt = rng.integers(0, 400, G).astype(np.int32)
        alloc = (rng.integers(1, 17, (C, R)) * 4 + np.float32(0.45)).astype(np.float32)
    else:
        raise ValueError(f"unknown fleet case {case!r}")
    maxper = np.where(rng.random(G) < 0.3, rng.integers(1, 4, G), 2**30).astype(np.int32)
    slot = rng.integers(0, S, G).astype(np.int32)
    feas = rng.random((G, C)) < 0.6
    price = (rng.random(C) * 3 + 0.05).astype(np.float32)
    openable = rng.random(C) < 0.85
    E = int(rng.integers(2, 7))
    used0 = np.zeros((K, R), np.float32)
    cfg0 = np.full(K, -1, np.int32)
    cfg0[:E] = rng.integers(0, C, E)
    used0[:E] = alloc[cfg0[:E]] * rng.random((E, R)).astype(np.float32) * 0.5
    npods0 = np.zeros(K, np.int32)
    npods0[:E] = rng.integers(0, 5, E)
    sig0 = np.zeros((S, K), np.int32)
    sig0[:, :E] = rng.integers(0, 2, (S, E))
    return (req, cnt, maxper, slot, feas, alloc, price, openable,
            used0, cfg0, npods0, E, sig0)


def fleet_columns(tenants: Sequence[tuple]) -> tuple:
    """B tenants' argument tuples as the fleet pack's 13 columns."""
    return tuple(tuple(t[i] for t in tenants) for i in range(13))


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


def population_arrays(candidates: int, classes: int, k_slots: int, members: int,
                      seed: int = 0) -> tuple:
    """Population-prologue inputs (numpy, in ``population_prologue``'s
    order: ``cand_cnt``, ``cand_slot``, ``cand_occ``, ``sort_rank``,
    ``occ_span``, ``masks``, ``k_slots``) at any shape: counts of 0-3 with
    half the pairs empty, slots in [0, k_slots] (k_slots: not live), first
    occurrences below ``occ_span`` (POP_OCC_ABSENT where a candidate has no
    pod of the class), dense ranks with ties, and masks selecting about a
    third of the candidates (member 0 none, member 1 all)."""
    rng = np.random.default_rng(seed)
    U, G, P = candidates, classes, members
    cand_cnt = rng.integers(0, 4, (U, G)).astype(np.int32)
    cand_cnt[rng.random((U, G)) < 0.5] = 0
    cand_slot = rng.integers(0, k_slots + 1, U).astype(np.int32)
    occ_span = 64 * U
    cand_occ = (np.arange(U)[:, None] * 64 + rng.integers(0, 64, (U, G))).astype(np.int32)
    cand_occ[cand_cnt == 0] = 2**29  # POP_OCC_ABSENT
    sort_rank = rng.integers(0, max(G // 3, 1), G).astype(np.int32)
    masks = rng.random((P, U)) < 0.33
    masks[0] = False
    masks[1 % P] = True
    return cand_cnt, cand_slot, cand_occ, sort_rank, occ_span, masks, k_slots


# the configs holding the tie arrays' cheapest shape: warps 0, 1 and 2 of
# the first tile of 256 configs, then the second tile and the 17th
VERDICT_TIE_CONFIGS = (3, 37, 70, 300, 4100)
# `verdict_tie_arrays`' cases: name -> (classes, configs, slots, elements,
# live slots[, axes]).  The first is the live consolidation problem's shape
# (Cp 8192, Kp 4096, B 512); B 40 is not a multiple of 32 elements a group;
# R 200 is past the axes the config pass stages in shared memory.
VERDICT_TIE_CASES = {
    "cp8192-kp4096-b512": (8, 8192, 4096, 512, 2000),
    "gp8-cp8192": (8, 8192, 256, 40, 4),
    "gp40-cp1000": (40, 1000, 512, 40, 4),
    "gp8-cp6": (8, 6, 64, 40, 4),
    "next0-k": (8, 300, 16, 3, 16),
    "next0-0": (8, 300, 32, 5, 0),
    "r200": (8, 300, 64, 40, 4, 200),
}
# `population_arrays`' cases: (candidates, classes, slots, members); the
# first two past a block of 256 threads, the last with rm rows of byte
# stores (K not a multiple of 16)
PROLOGUE_CASES = ((300, 300, 1000, 16), (600, 40, 4096, 8), (64, 8, 4096, 512), (5, 3, 7, 4))


def verdict_tie_arrays(classes: int = 8, configs: int = 8192, k_slots: int = 512,
                       elements: int = 40, live: int = 4, axes: int = 3) -> tuple:
    """Removal-verdict inputs (numpy, in the argument order of the JAX
    package's ``removal_verdict_kernel``: the base arrays, then ``cnt_b``,
    ``rm_b``, ``perm_b``) on which the verdict rows must break ties by first
    index, with their edge cases.

    - One node shape, the largest and the cheapest a pod, at one price in
      the (pool, zone, capacity type) key (0, 0, 0), at the configs of
      `VERDICT_TIE_CONFIGS` below ``configs - 2``: a new node opens on the
      first and its masked price ties at the others.  Class 1 cannot run on
      the first of them and class 2 on the first three, so an element whose
      k_star holds class 1 (2) finds its minimum at the second (fourth).
    - The last two configs are the live nodes' rows: no pool (key -1), not
      openable.  Slots 0 .. ``live`` - 1 are live (``next0`` = ``live``:
      0 and ``k_slots`` are allowed).
    - Element 0 places nothing: no new slot, k_star 0, and with slot 0 live
      every config is masked (``c_min`` 0, ``+inf``).  Element 1 places
      (k_slots - live) // 2 pods of class 3, one a node (``maxper`` 1): as
      many new slots.  The others draw counts of 0-39 a class, a random
      class order and removed live slots.
    - Requests are dyadic (0.5-4 vCPU, 1-8 GiB), so every ``new_load`` sum
      is exact in float32, whatever its order.
    - ``axes`` past the first three are extra resources (`_extra_axes`):
      some configs lack one, some classes request one, live slots use some.

    ``configs`` is at least 6; ``elements`` at least 2; ``axes`` at least 3."""
    if configs < 6 or elements < 2 or not 0 <= live <= k_slots or axes < 3:
        raise ValueError("need configs >= 6, elements >= 2, 0 <= live <= k_slots, axes >= 3")
    rng = np.random.default_rng(13)
    G, C, K, B, E, R, S = classes, configs, k_slots, elements, live, 3, 2
    c = np.arange(C)
    ex = C - 2  # the live nodes' rows
    cpu = (2 + 2 * (c % 7)).astype(np.float32)
    alloc = np.stack([cpu, 4 * cpu, np.full(C, 110, np.float32)], 1)
    price = (0.05 * cpu + 0.01 * rng.random(C)).astype(np.float32)
    openable = rng.random(C) < 0.9
    pool_id = (c % 2).astype(np.int32)
    zone_id = (c // 2 % 3).astype(np.int32)
    ct_id = (c // 6 % 2).astype(np.int32)
    feas = rng.random((G, C)) < 0.7
    champ = [k for k in VERDICT_TIE_CONFIGS if k < ex]
    alloc[champ] = (16.0, 64.0, 110.0)
    price[champ] = 0.5
    openable[champ] = True
    pool_id[champ] = zone_id[champ] = ct_id[champ] = 0
    feas[:, champ] = True
    feas[1 % G, champ[:1]] = False
    feas[2 % G, champ[:3]] = False
    alloc[ex:] = (8.0, 32.0, 110.0)
    price[ex:] = 0.0
    openable[ex:] = False
    pool_id[ex:] = zone_id[ex:] = ct_id[ex:] = -1
    req = np.zeros((G, R), np.float32)
    req[:, 0] = rng.choice([0.5, 1.0, 2.0, 4.0], G)
    req[:, 1] = rng.choice([1.0, 2.0, 4.0, 8.0], G)
    req[:, 2] = 1.0
    maxper = np.full(G, 2**30, np.int32)
    maxper[3 % G] = 1
    slot = (np.arange(G) % S).astype(np.int32)
    compactable = rng.random(G) < 0.8
    used0 = np.zeros((K, R), np.float32)
    cfg0 = np.full(K, -1, np.int32)
    npods0 = np.zeros(K, np.int32)
    cfg0[:E] = ex + np.arange(E) % 2
    npods0[:E] = rng.integers(1, 5, E)
    used0[:E, 0] = rng.choice([1.0, 2.0, 4.0], E)
    used0[:E, 1] = 2 * used0[:E, 0]
    used0[:E, 2] = npods0[:E]
    sig0 = np.zeros((S, K), np.int32)
    if axes > 3:
        req, alloc, used0 = _extra_axes(req, alloc, used0, axes, champ, ex, E, npods0)
    cnt = rng.integers(0, 40, (B, G)).astype(np.int32)
    cnt[rng.random((B, G)) < 0.4] = 0
    cnt[0] = 0
    cnt[1] = 0
    cnt[1, 3 % G] = (K - E) // 2
    rm = np.zeros((B, K), bool)
    rm[:, :E] = rng.random((B, E)) < 0.3
    rm[0] = False
    perm = np.stack([rng.permutation(G) for _ in range(B)]).astype(np.int32)
    cnt_b = np.take_along_axis(cnt, perm, 1)  # counts in permuted positions
    return (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, E, sig0,
            pool_id, zone_id, ct_id, compactable, cnt_b, rm, perm)


# `frontier_arrays`' cases: name -> (slots, live slots, elements, what the
# case is for).  W is `fused_packer.window_layout`'s window at the case's
# shapes: 1024 at 2048 slots, 512 at 512 (R 3, S 2, Cp 304; the wrap case
# R 6, S 8, Cp 8).
FRONTIER_CASES = {
    "inside": (2048, 300, 12, "every element's frontier well inside the window"),
    "exact": (2048, 40, 12, "one element's frontier reaches W exactly"),
    "past": (2048, 40, 12, "two elements pass W mid-scan, the others stay"),
    "next0-past-w": (2048, 1100, 12, "the live slots reach past W: the picked scan alone"),
    "k-within-w": (512, 40, 12, "Kp <= W: the window alone, one frontier at K"),
    "negzero-tail": (2048, 40, 12, "a -0.0 usage in the tail: every element leaves"),
    "negzero-window": (2048, 40, 12, "a -0.0 usage in the window past the live slots: "
                                     "every slot of the window updated each step"),
    "inf-request": (2048, 40, 12, "a request of +inf (the last class): every element leaves"),
    "wrap": (2048, 4, 12, "caps of 2^30: prefix sums wrap, windows of negative length"),
}
FRONTIER_ONE_A_NODE = 3  # the class that takes one pod a node and no live slot


def frontier_arrays(case: str, k_slots: Optional[int] = None, configs: int = 304,
                    batch: Optional[int] = None, at: int = 0) -> tuple:
    """Removal-verdict inputs (numpy, in ``removal_verdict_kernel``'s
    argument order, as `verdict_tie_arrays`) for the frontier-window scan:
    each case of `FRONTIER_CASES` puts the elements' frontiers (the live
    slots and the new slots opened so far) where its description says,
    against the window W that `fused_packer.window_layout` picks at its
    shapes.

    The base: G 8 classes of dyadic requests (cpu, memory, one pod) over Cp
    304 configs (the last two the live nodes' rows, not openable), the
    live slots ``0 .. live - 1``, ``next0`` = live; class
    `FRONTIER_ONE_A_NODE` fits no live node and takes one pod a new node,
    so a count of n opens n slots.  Elements draw counts of 0-20 a class
    (40 % zero), a random class order and removed live slots.  The
    ``wrap`` case is `wrap_arrays` at 2048 slots with such a batch over it
    (every count at least one).  ``k_slots``, ``configs`` (Cp of the other
    cases) and ``batch`` (at least 3) replace the case's Kp, Cp and B; ``at``
    places the wrap case's prefilled slots (`wrap_arrays`)."""
    from karpenter_tpu_torch.ops.fused_packer import window_layout

    K, E, B, _ = FRONTIER_CASES[case]
    K, B = k_slots or K, batch or B
    rng = np.random.default_rng(29)
    if case == "wrap":
        (req, cnt, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0,
         sig0) = wrap_arrays(K, at=at)
        G, C = feas.shape
        pool_id, zone_id, ct_id = (np.zeros(C, np.int32) for _ in range(3))
        compactable = np.ones(G, bool)
        counts = np.maximum(cnt[None, :] - rng.integers(0, 4, (B, G)), 1).astype(np.int32)
        rm = np.zeros((B, K), bool)
        rm[:, at:at + E] = rng.random((B, E)) < 0.25
    else:
        G, C, R, S = 8, configs, 3, 2
        c = np.arange(C)
        ex = C - 2  # the live nodes' rows
        cpu = (2 + 2 * (c % 7)).astype(np.float32)
        alloc = np.stack([cpu, 4 * cpu, np.full(C, 110, np.float32)], 1)
        price = (0.05 * cpu + 0.01 * rng.random(C)).astype(np.float32)
        openable = rng.random(C) < 0.9
        pool_id = (c % 2).astype(np.int32)
        zone_id = (c // 2 % 3).astype(np.int32)
        ct_id = (c // 6 % 2).astype(np.int32)
        feas = rng.random((G, C)) < 0.8
        alloc[ex:] = (8.0, 32.0, 110.0)
        price[ex:] = 0.0
        openable[ex:] = False
        pool_id[ex:] = zone_id[ex:] = ct_id[ex:] = -1
        one = FRONTIER_ONE_A_NODE
        feas[one, ex:] = False
        req = np.zeros((G, R), np.float32)
        req[:, 0] = rng.choice([0.5, 1.0, 2.0], G)
        req[:, 1] = rng.choice([1.0, 2.0, 4.0], G)
        req[:, 2] = 1.0
        maxper = np.full(G, 2**30, np.int32)
        maxper[one] = 1
        slot = (np.arange(G) % S).astype(np.int32)
        compactable = rng.random(G) < 0.8
        used0 = np.zeros((K, R), np.float32)
        cfg0 = np.full(K, -1, np.int32)
        npods0 = np.zeros(K, np.int32)
        cfg0[:E] = ex + np.arange(E) % 2
        npods0[:E] = rng.integers(1, 4, E)
        used0[:E, 0] = rng.choice([0.5, 1.0, 2.0], E)
        used0[:E, 1] = 2 * used0[:E, 0]
        used0[:E, 2] = npods0[:E]
        sig0 = np.zeros((S, K), np.int32)
        next0 = E
        counts = rng.integers(0, 21, (B, G)).astype(np.int32)
        counts[rng.random((B, G)) < 0.4] = 0
        counts[:, one] = np.minimum(counts[:, one], 3)
        rm = np.zeros((B, K), bool)
        rm[:, :E] = rng.random((B, E)) < 0.3
    W = window_layout(K, req.shape[1], sig0.shape[0], feas.shape[1])[0]
    perm = np.stack([rng.permutation(G) for _ in range(B)]).astype(np.int32)
    if case in ("exact", "k-within-w"):
        counts[1] = 0
        counts[1, FRONTIER_ONE_A_NODE] = min(W, K) - E  # its frontier: W (K) exactly
    elif case == "past":
        for b, n in ((1, W - E + 3), (2, 2 * K)):
            counts[b] = np.minimum(counts[b], 2)
            counts[b, FRONTIER_ONE_A_NODE] = n
            rest = [g for g in perm[b] if g != FRONTIER_ONE_A_NODE]
            perm[b] = rest[:G // 2] + [FRONTIER_ONE_A_NODE] + rest[G // 2:]  # mid-scan
    elif case == "negzero-tail":
        used0[W + 7, 1] = -0.0
    elif case == "negzero-window":
        used0[E + 60, 1] = -0.0
    elif case == "inf-request":
        req[G - 1, 0] = np.inf
        perm = np.stack([np.concatenate([p[p != G - 1], [G - 1]]) for p in perm]).astype(np.int32)
    cnt_b = np.take_along_axis(counts, perm, 1)  # counts in permuted positions
    return (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
            pool_id, zone_id, ct_id, compactable, cnt_b, rm, perm)


def frontier_pack(case: str, b: int, **shape) -> tuple:
    """Element ``b`` of a `frontier_arrays` case (``shape``: its keyword
    arguments) as one pack's inputs (numpy, in `pack_reference`'s order):
    the base rows in its class order, its counts, its removed slots'
    configs -1 (what the batched scan scans for it)."""
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     *_, cnt_b, rm, perm) = frontier_arrays(case, **shape)
    pb = perm[b]
    cfg = np.where(rm[b], -1, cfg0).astype(np.int32)
    return (req[pb], cnt_b[b], maxper[pb], slot[pb], feas[pb], alloc, price, openable,
            used0, cfg, npods0, int(next0), sig0)


def element_frontiers(node_cfg, next0: int) -> np.ndarray:
    """Each element's frontier after its scan, from a batched scan's
    ``node_cfg`` [B, K]: ``next0`` or one past its last slot holding a
    config, whichever is larger (every slot a window opens takes the
    class's config, so this is the largest frontier the scan reached)."""
    cfg = np.asarray(node_cfg)
    has = cfg >= 0
    last = np.where(has.any(1), cfg.shape[1] - np.argmax(has[:, ::-1], 1), 0)
    return np.maximum(last, int(next0))


def tail_moves(used0, req, W: int) -> bool:
    """Whether the fused update of a zero take would change a slot past
    the first W: a usage there that is -0.0 or a NaN, or a request that is
    not finite (the frontier-window scan then leaves every element to the
    picked scan)."""
    used0, req = np.asarray(used0), np.asarray(req)
    tail = used0[W:]
    return bool(len(tail) and ((np.isnan(tail) | ((tail == 0) & np.signbit(tail))).any()
                               or not np.isfinite(req).all()))


def window_finishes(used0, req, node_cfg, next0: int, W: int) -> np.ndarray:
    """[B] bool: the elements the frontier-window scan finishes (its
    ``done`` mask where it runs): those whose frontier stays within W,
    where the tail does not move."""
    fits = element_frontiers(node_cfg, next0) <= W
    return fits & (W >= np.asarray(used0).shape[0] or not tail_moves(used0, req, W))


# `admit_edge_arrays`' cases: name -> what the case is for.  The admission
# kernel (``admit_kernel``, csrc/ffd_pack.cu) gives each thread slot rounds
# (up to 8 in registers, K <= 4096; past that a run staged in the output)
# and config rounds (their bytes 16 rounds at a time), and holds up to 4
# requested axes of a row of up to 8 (more take node_cap's loop).
ADMIT_EDGE_CASES = {
    "last-config": "the only config that fits any class is the last, Cp - 1",
    "none-fits": "no config fits any class: the open bit is 0 for every class",
    "nudge": "configs and slots just under a multiple of q (q 3.0): alloc 2.9999 fits "
             "only through the 1e-4 nudge, 2.999 does not",
    "exact": "alloc == q and alloc - used == q exactly on every requested axis",
    "unaligned": "Cp 300: no multiple of 8, and odd classes' feasibility rows start off "
                 "8-byte alignment (byte loads)",
    "k-ragged": "K 1000, no multiple of 32",
    "k-16384": "K 16,384: more slots a thread than its registers hold (caps staged)",
    "k-0": "K 0: only the placed total and the open bit",
    "no-axis": "classes that request no axis: 2^30 room a slot, the int32 prefix wraps",
    "last-class": "the one class with pods is the last row of req, cnt and feas",
    "wide": "R 10 with classes requesting 5 or 6 axes: node_cap's loop",
    "axes": "R 8, classes requesting 0, 1, 2, 4, 5 and 8 axes: each register pass and "
            "node_cap's loop past 4",
    "many-configs": "Cp 20,000: past 16 config rounds a thread, the fitting config last",
    "k-4096": "K 4096, every slot live: 8 slot rounds a thread, each holding live slots",
}
ADMIT_LIVE_ROWS = 16  # config columns 0 .. 15: the live nodes' rows, never openable


def admit_edge_arrays(case: str) -> tuple:
    """Admission inputs (numpy, in ``admit_kernel``'s argument order: req,
    cnt, feas, alloc, openable, used0, cfg0) for one of `ADMIT_EDGE_CASES`.

    The base (seed 23): G 6 classes of requests 0.25-3 over R 3 axes (cpu,
    memory, pods), counts up to 300; Cp 512 configs, the first
    `ADMIT_LIVE_ROWS` the live nodes' rows (never openable), the rest a
    catalog of which 60 % is openable, 80 % feasible; K 256 slots, the
    first 200 live on random configs (mostly live rows) with usage a random
    share of their alloc row."""
    rng = np.random.default_rng(23)
    G, C, K, R, live = 6, 512, 256, 3, 200
    E = ADMIT_LIVE_ROWS
    if case == "unaligned":
        G, C = 7, 300
    elif case == "k-ragged":
        K, live = 1000, 900
    elif case == "k-16384":
        K, live = 16384, 12000
    elif case == "k-0":
        K, live = 0, 0
    elif case == "wide":
        R = 10
    elif case == "axes":
        R = 8
    elif case == "many-configs":
        C = 20_000
    elif case == "k-4096":
        K, live = 4096, 4096
    req = rng.choice([0.25, 0.5, 1.0, 2.0, 3.0], size=(G, R)).astype(np.float32)
    req[:, 2] = 1.0  # one pod
    if R > 3:
        req[:, 3:] = np.where(rng.random((G, R - 3)) < 0.4, req[:, 3:], 0.0)
    cnt = rng.integers(0, 300, G).astype(np.int32)
    feas = rng.random((G, C)) < 0.8
    alloc = rng.choice([2.0, 4.0, 8.0, 16.0, 32.0], size=(C, R)).astype(np.float32)
    alloc[:, 2] = 110.0
    alloc[:E, :2] = (16.0, 64.0)
    openable = rng.random(C) < 0.6
    openable[:E] = False
    cfg0 = np.full(K, -1, np.int32)
    cfg0[:live] = np.where(rng.random(live) < 0.8, rng.integers(0, E, live),
                           rng.integers(0, C, live))
    frac = rng.random((live, R)).astype(np.float32)
    if case == "last-config":
        alloc[E:C - 1, 0] = 0.125  # below every class's cpu request
        openable[C - 1] = True
        feas[:, C - 1] = True
    elif case in ("none-fits", "many-configs"):
        alloc[E:, 0] = 0.125
        if case == "many-configs":  # the last config fits, in a thread's third round
            alloc[C - 1, 0] = 32.0
            openable[C - 1] = feas[:, C - 1] = True
    elif case == "nudge":
        req[:, 0] = 3.0
        alloc[E:, 0] = 2.999
        nudged = E + rng.choice(C - E, 12, replace=False)
        alloc[nudged, 0] = 2.9999
        alloc[:E, 0] = 9.0
    elif case == "exact":
        req[:] = (2.0, 4.0, 1.0)
        alloc[E:] = np.where(rng.random((C - E, 1)) < 0.1, req[0], (2.0, 2.0, 110.0))
        alloc[:E] = (8.0, 16.0, 110.0)
    elif case == "no-axis":
        req[:3] = 0.0
        cnt[:3] = (5, 2**30, 2**31 - 1)
    elif case == "last-class":
        cnt[:] = 0
        cnt[G - 1] = 150
        req[G - 1] = (0.0, 0.0, 1.0)  # its row's last word is the array's last
    elif case == "wide":
        req[:, 3:] = np.where(np.arange(R - 3) < 3, 0.5, 0.0)  # 6 axes a class
        req[0, 5] = 0.0  # and one of 5
    elif case == "axes":
        req[:] = 0.0
        for g, n in enumerate((0, 1, 2, 4, 5, 8)):
            req[g, R - n:] = 0.25  # the last n axes (the pods axis 2 among the wider)
    used0 = np.zeros((K, R), np.float32)
    used0[:live] = (alloc[cfg0[:live]] * frac).astype(np.float32)
    if case == "nudge":  # 9 - 0.0001 holds 3 pods only through the nudge
        used0[:live, 0] = np.where(rng.random(live) < 0.5, np.float32(0.0001), np.float32(0.001))
    elif case == "exact":  # alloc - used == q: one pod exactly
        used0[:live] = np.where(cfg0[:live, None] < E, (6.0, 12.0, 109.0), used0[:live])
    return req, cnt, feas, alloc, openable, used0, cfg0


def _extra_axes(req, alloc, used0, axes: int, champ, ex: int, live: int, npods0) -> tuple:
    """`verdict_tie_arrays`' rows widened to ``axes`` resource axes, drawn
    from no random stream (the first three axes keep their values).  Axis
    r >= 3: configs hold 16-32 of it, none where (c + r) % 13 == 0 (the
    tie configs 64, the live rows 32); class g requests 0.25 where (g + r)
    % 9 == 0; a live slot uses 0.5 a pod where r % 4 == 0.  All dyadic."""
    G, C, K = req.shape[0], alloc.shape[0], used0.shape[0]
    r = np.arange(3, axes)
    c = np.arange(C)[:, None]
    more = (16 + 4 * ((c + r) % 5)).astype(np.float32)
    more[(c + r) % 13 == 0] = 0.0
    more[champ] = 64.0
    more[ex:] = 32.0
    reqx = np.where((np.arange(G)[:, None] + r) % 9 == 0, 0.25, 0.0).astype(np.float32)
    usedx = np.zeros((K, axes - 3), np.float32)
    usedx[:live] = np.where(r % 4 == 0, 0.5, 0.0) * npods0[:live, None]
    return (np.concatenate([req, reqx], 1), np.concatenate([alloc, more], 1),
            np.concatenate([used0, usedx], 1))


# config 2's catalog: three generations of every family at these sizes
CONFIG2_CATALOG = dict(
    generations=(1, 2, 3),
    cpus=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192),
)
DEDICATED_TAINT = Taint(key="dedicated", value="batch", effect="NoSchedule")


def heterogeneous_problem(
    scale: float = 1.0,
) -> Tuple[List[NodePool], Dict[str, List[InstanceType]], List[Pod]]:
    """Config 2 of ``bench.py``: 10k pods with near-continuous request
    sizes, a tainted dedicated pool and nodeSelector variety over the
    three-generation catalog (~300 types x 3 zones x 2 capacity types)."""
    shapes = generate_catalog(**CONFIG2_CATALOG)
    general = default_node_pool(name="general")
    dedicated = default_node_pool(name="dedicated", taints=[DEDICATED_TAINT])
    inventory = {
        "general": instance_types(general, shapes),
        "dedicated": instance_types(dedicated, shapes),
    }
    return [general, dedicated], inventory, heterogeneous_pods(_n(scale))


def heterogeneous_pods(n: int) -> List[Pod]:
    """Config 2's pending pods: near-continuous request sizes, nodeSelector
    variety, 30 % on the tainted dedicated pool."""
    tol = (Toleration(key="dedicated", value="batch", effect="NoSchedule"),)
    selector_variants = [
        {},  # anything
        {L.LABEL_ARCH: "amd64"},
        {L.LABEL_INSTANCE_CATEGORY: "compute"},
        {L.LABEL_INSTANCE_CATEGORY: "memory"},
    ]
    pods = []
    for i in range(n):
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
    return pods


# ---------------------------------------------------------------------------
# bench.py's other solve problems: configs 3-5, co-location, hybrid,
# relaxation and the 100k-pod resident tick
# ---------------------------------------------------------------------------

# the catalog of configs 1 and 3-5: five generations of every family
FLAGSHIP_CATALOG = dict(
    generations=(1, 2, 3, 4, 5),
    cpus=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192),
)
COLOC_VARIANTS = ("tensor", "crossclass", "inequiv", "prefer")


def _count(count: int, scale: float) -> int:
    """One of a problem's counts at ``scale``, as ``bench._n`` scales it."""
    return max(1, int(count * scale))


def _three_sizes() -> List[Resources]:
    return [
        Resources(cpu=0.5, memory="1Gi"),
        Resources(cpu=1, memory="2Gi"),
        Resources(cpu=2, memory="4Gi"),
    ]


def affinity_topology_problem(
    scale: float = 1.0,
) -> Tuple[List[NodePool], Dict[str, List[InstanceType]], List[Pod]]:
    """Config 3 of ``bench.py`` (`build_affinity_topology`): 20 services
    spread over the zones (maxSkew 2), 10 zone-affinity groups, 100
    hostname-anti-affinity singletons and plain filler."""
    from karpenter_tpu_torch.api.objects import PodAffinityTerm, TopologySpreadConstraint

    pool = default_node_pool()
    types = instance_types(pool, generate_catalog(**FLAGSHIP_CATALOG))
    sizes = _three_sizes()
    pods: List[Pod] = []
    for s in range(20):
        constraint = TopologySpreadConstraint(
            max_skew=2, topology_key=L.LABEL_ZONE,
            label_selector=(("svc", f"spread-{s}"),),
        )
        for i in range(_count(400, scale)):
            pods.append(Pod(labels={"svc": f"spread-{s}"}, requests=sizes[i % len(sizes)],
                            topology_spread=[constraint]))
    for g in range(10):
        term = PodAffinityTerm(topology_key=L.LABEL_ZONE,
                               label_selector=(("app", f"coloc-{g}"),))
        for i in range(_count(90, scale)):
            pods.append(Pod(labels={"app": f"coloc-{g}"}, requests=sizes[i % len(sizes)],
                            pod_affinity=[term]))
    for _ in range(_count(100, scale)):
        pods.append(Pod(
            labels={"app": "singleton"},
            requests=Resources(cpu=1, memory="2Gi"),
            pod_affinity=[PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                                          label_selector=(("app", "singleton"),),
                                          anti=True)],
        ))
    for i in range(_count(1000, scale)):
        pods.append(Pod(requests=sizes[i % len(sizes)]))
    return [pool], {pool.name: types}, pods


def multipool_spot_problem(
    scale: float = 1.0,
) -> Tuple[List[NodePool], Dict[str, List[InstanceType]], List[Pod]]:
    """Config 5 of ``bench.py`` (`build_multipool_spot`): a reserved
    on-demand pool (weight 100, 2,000 vCPU limit), a spot pool (weight 50)
    and an unrestricted fallback (weight 0)."""
    from karpenter_tpu_torch.api import Requirement, Requirements
    from karpenter_tpu_torch.api.requirements import Op

    shapes = generate_catalog(**FLAGSHIP_CATALOG)
    reserved = default_node_pool(
        name="reserved", weight=100, limits=Resources(cpu=2000),
        requirements=Requirements(
            [Requirement(L.LABEL_CAPACITY_TYPE, Op.IN, [L.CAPACITY_TYPE_ON_DEMAND])]),
    )
    spot = default_node_pool(
        name="spot", weight=50,
        requirements=Requirements(
            [Requirement(L.LABEL_CAPACITY_TYPE, Op.IN, [L.CAPACITY_TYPE_SPOT])]),
    )
    fallback = default_node_pool(name="fallback", weight=0)
    pools = [reserved, spot, fallback]
    inventory = {p.name: instance_types(p, shapes) for p in pools}
    sizes = [*_three_sizes(), Resources(cpu=4, memory="16Gi")]
    pods = [Pod(requests=sizes[i % len(sizes)]) for i in range(_count(10_000, scale))]
    return pools, inventory, pods


def coloc_pods(variant: str, scale: float = 1.0) -> List[Pod]:
    """``bench._coloc_pods``: 100 hostname co-location groups of 5 pods.
    ``variant`` (`COLOC_VARIANTS`): self-selecting groups (``tensor``), two
    label variants under one selector (``crossclass``), the odd members
    also tolerating a taint (``inequiv``) or preferring a zone
    (``prefer``)."""
    from karpenter_tpu_torch.api import Requirement
    from karpenter_tpu_torch.api.objects import PodAffinityTerm
    from karpenter_tpu_torch.api.requirements import Op

    if variant not in COLOC_VARIANTS:
        raise ValueError(f"co-location variant {variant!r}, not one of {COLOC_VARIANTS}")
    cross = variant != "tensor"
    pods = []
    for g in range(_count(100, scale)):
        term = PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                               label_selector=(("pair", f"host-{g}"),))
        for i in range(5):
            labels = {"pair": f"host-{g}"}
            kw = {}
            if cross:
                labels["variant"] = str(i % 2)
                if variant == "inequiv" and i % 2:
                    kw["tolerations"] = [Toleration(key="burst", value="yes",
                                                    effect="NoSchedule")]
                if variant == "prefer" and i % 2:
                    kw["preferred_affinity"] = [
                        Requirement(L.LABEL_ZONE, Op.IN, [ZONES[g % len(ZONES)]])]
            pods.append(Pod(labels=labels, requests=Resources(cpu=1, memory="2Gi"),
                            pod_affinity=[term], **kw))
    return pods


def coloc_problem(
    variant: str, scale: float = 1.0,
) -> Tuple[List[NodePool], Dict[str, List[InstanceType]], List[Pod]]:
    """``bench._coloc_problem`` (`build_coloc_tensor`,
    `build_crossclass_coloc`, `build_inequiv_coloc`, `build_prefer_coloc`):
    9,500 plain pods and the 500 co-location pods of ``variant`` over the
    flagship's catalog.  The flagship's pods are built first and dropped,
    as bench builds them, so the pods' generated names agree."""
    pool, types, _ = flagship_problem(scale)
    sizes = _three_sizes()
    pods = [Pod(requests=sizes[i % len(sizes)]) for i in range(_count(9_500, scale))]
    return [pool], {pool.name: types}, pods + coloc_pods(variant, scale)


def relax_problem(
    scale: float = 1.0,
) -> Tuple[List[NodePool], Dict[str, List[InstanceType]], List[Pod]]:
    """``bench.build_relax``: 7,000 plain pods, 2,000 preferring a zone
    that does not exist (every other one after a satisfiable preference)
    and 1,000 whose first node-affinity term admits nothing; all relaxed
    at compile time."""
    from karpenter_tpu_torch.api import Requirement
    from karpenter_tpu_torch.api.requirements import Op

    pool, types, _ = flagship_problem(scale)
    sizes = _three_sizes()
    pods = [Pod(requests=sizes[i % len(sizes)]) for i in range(_count(7_000, scale))]
    for i in range(_count(2_000, scale)):
        prefs = [Requirement(L.LABEL_ZONE, Op.IN, ["zone-nowhere"])]
        if i % 2:
            prefs = [Requirement(L.LABEL_ZONE, Op.IN, [ZONES[i % len(ZONES)]])] + prefs
        pods.append(Pod(requests=sizes[i % len(sizes)], preferred_affinity=prefs))
    for i in range(_count(1_000, scale)):
        pods.append(Pod(
            requests=sizes[i % len(sizes)],
            affinity_terms=[
                (Requirement(L.LABEL_ZONE, Op.IN, ["zone-nowhere"]),),
                (Requirement(L.LABEL_ZONE, Op.IN, [ZONES[i % len(ZONES)]]),),
            ],
        ))
    return [pool], {pool.name: types}, pods


def hybrid_problem(scale: float = 1.0):
    """``bench.build_hybrid``: 9,500 plain pods and 100 groups of 5 pods
    that must join the live node running a pod their selector matches.
    Returns ``(pools, inventory, pods, existing)``, ``existing`` the 100
    live nodes."""
    from karpenter_tpu_torch.api.objects import PodAffinityTerm

    pool, types, _ = flagship_problem(scale)
    sizes = _three_sizes()
    pods = [Pod(requests=sizes[i % len(sizes)]) for i in range(_count(9_500, scale))]
    existing = []
    for g in range(_count(100, scale)):
        bound = Pod(labels={"pair": f"host-{g}"}, requests=Resources(cpu=1, memory="2Gi"))
        existing.append(StateNode(
            name=f"live-{g}",
            provider_id=f"fake://live-{g}",
            labels={L.LABEL_ZONE: ZONES[g % len(ZONES)], L.LABEL_NODEPOOL: pool.name},
            taints=[],
            allocatable=Resources(cpu=16, memory="64Gi", pods=110),
            pods=[bound],
            used=Resources(cpu=1, memory="2Gi"),
        ))
        term = PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                               label_selector=(("pair", f"host-{g}"),))
        for _ in range(5):
            pods.append(Pod(labels={"pair": f"host-{g}"},
                            requests=Resources(cpu=1, memory="2Gi"), pod_affinity=[term]))
    return [pool], {pool.name: types}, pods, existing


def resident_100k_problem(scale: float = 1.0):
    """``bench.build_resident_100k``: 100,000 small pods of 8 shapes and
    1,000 empty live nodes of 64 vCPU / 256 GiB, bench's warm tick.
    Returns ``(pools, inventory, pods, existing)``."""
    pool, types, _ = flagship_problem(scale)
    sizes = [
        Resources(cpu=0.1, memory="256Mi"),
        Resources(cpu=0.2, memory="256Mi"),
        Resources(cpu=0.25, memory="512Mi"),
        Resources(cpu=0.3, memory="512Mi"),
        Resources(cpu=0.4, memory="1Gi"),
        Resources(cpu=0.5, memory="1Gi"),
        Resources(cpu=0.5, memory="2Gi"),
        Resources(cpu=0.75, memory="2Gi"),
    ]
    pods = [Pod(requests=sizes[i % len(sizes)]) for i in range(_count(100_000, scale))]
    existing = [
        StateNode(
            name=f"live-{i}",
            provider_id=f"fake://live-{i}",
            labels={L.LABEL_ZONE: ZONES[i % len(ZONES)], L.LABEL_NODEPOOL: pool.name},
            taints=[],
            allocatable=Resources(cpu=64, memory="256Gi", pods=110),
            pods=[],
            used=Resources(),
        )
        for i in range(_count(1_000, scale))
    ]
    return [pool], {pool.name: types}, pods, existing


def consolidation_repack(device=None, scale: float = 1.0):
    """Config 4 of ``bench.py`` (`run_consolidation_repack`): an
    `Environment` on ``device`` over the flagship's catalog, one pool that
    consolidates when underutilized, 5,000 pods of four sizes settled onto
    nodes; then the disruption controller's pass budgets and candidates,
    ready for ``_simulate(candidates)``: every node removed, every pod
    repacked.  The name counters are rewound first and launches go one at
    a time, so two drives name and number their nodes alike.  Returns
    ``(controller, candidates)``."""
    from karpenter_tpu_torch.api import Disruption
    from karpenter_tpu_torch.api.objects import reset_name_sequences

    reset_name_sequences()
    env = Environment(shapes=generate_catalog(**FLAGSHIP_CATALOG), device=device)
    env.default_node_class()
    env.default_node_pool(disruption=Disruption(consolidation_policy="WhenUnderutilized"))
    env.operator.provisioner.launch_concurrency = 1
    sizes = [*_three_sizes(), Resources(cpu=4, memory="8Gi")]
    n_pods = _count(5_000, scale)
    for i in range(n_pods):
        env.kube.put_pod(Pod(requests=sizes[i % len(sizes)]))
    env.settle(max_rounds=60)
    if env.kube.pending_pods():
        raise RuntimeError(f"{len(env.kube.pending_pods())} of {n_pods} pods unbound")
    dc = env.operator.disruption
    dc._budgets = dc._remaining_budgets()
    candidates = dc._candidates()
    moved = sum(len(c.reschedulable) for c in candidates)
    if moved != n_pods:
        raise RuntimeError(f"the candidates reschedule {moved} of {n_pods} pods")
    return dc, candidates


def canonical_node(vn) -> tuple:
    """A new node of either package as plain data: its pool, feasible
    types, zone options, capacity type and pod names."""
    ct = next((r.single_value() for r in vn.requirements
               if r.key == L.LABEL_CAPACITY_TYPE), None)
    return (vn.pool.name, tuple(t.name for t in vn.feasible_types),
            tuple(sorted(vn.zone_options())), ct, tuple(sorted(p.name for p in vn.pods)))


def canonical_result(result) -> tuple:
    """A `SchedulingResult` of either package as plain data (the fields of
    the tests' ``torch_specs.canonical``): every new node's
    `canonical_node`, the existing placements, the unschedulable pods."""
    return (sorted(canonical_node(vn) for vn in result.new_nodes),
            sorted(result.existing_placements.items()), sorted(result.unschedulable))


# ---------------------------------------------------------------------------
# bench.py's device lines: the admission fast path, the pipelined tick and
# the load harness, each with bench's constants
# ---------------------------------------------------------------------------

ADMISSION_ITERS = 200  # bench: iters = _n(200), two passes
ADMISSION_WARMUP = 3  # bench.WARMUP
ADMISSION_BUDGET_MS = 1.0  # README: pod -> nomination p99 under 1 ms
PIPELINE_SCENARIO = "diurnal+interruption-storm"
PIPELINE_TICKS = 150
PIPELINE_SEED = 11
PIPELINE_TICK_GAP_S = 0.01  # real sleep between ticks, outside the measured tick
PIPELINE_POPULATION = 256
PIPELINE_MAX_RATIO = 1.05  # bench: pipelined p50 <= 1.05 x sequential
TICK_CONTROLLERS = (
    "nodeclass", "provisioner", "lifecycle", "interruption", "disruption",
    "termination", "link", "garbagecollection", "tagging", "metrics_state",
    "consistency",
)
LOAD_HARNESS_SCENARIO = "million-events"
LOAD_HARNESS_TICKS = 850
LOAD_HARNESS_SEED = 23
LOAD_HARNESS_MIN_EVENTS = 1_000_000
LOAD_HARNESS_MAX_FRACTION = 0.20  # generate + invariants under 20 % of the phases


def link_floor_ms(device) -> float:
    """bench's ``_link_floor_ms`` on ``device``: the least wall time of 5
    round trips of a one-element tensor op and its ``.cpu()``, each on a
    fresh value, after one round outside the timing."""
    import math

    import torch

    x = torch.zeros(1, dtype=torch.float32, device=device)
    (x + 0.0).cpu()
    best = math.inf
    for i in range(5):
        t0 = time.perf_counter()
        (x + float(i + 1)).cpu()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _scope_totals(scope) -> Tuple[int, int]:
    return sum(scope.compiles.values()), sum(scope.transfer_bytes.values())


def admission_drive(device=None, scale: float = 1.0, iters: int = ADMISSION_ITERS) -> dict:
    """``bench.run_admission_fastpath`` on ``device`` (None: the card):
    `resident_100k_problem`'s live nodes, the resident plane seeded by a
    one-pod solve and a first admission (the cold ms), the tick trust
    window opened (`ResidentCache.note_sync`), `ADMISSION_WARMUP`
    admissions, then two passes of ``iters`` single-pod
    `fastpath.try_admit` calls with the collector parked, each sample the
    min of its two passes.  Every attempt is recorded, not asserted:
    ``outcomes`` counts them, ``nodes`` holds the node each attempt
    nominated (None where it did not), in order.  The observatory's new
    launch signatures and transfer bytes are split at the warm window, as
    bench's ``_DeviceWindow`` splits them (``transfer_bytes_warm`` a timed
    attempt)."""
    import gc
    import math
    import statistics

    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.scheduling import fastpath
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler
    from karpenter_tpu_torch.utils.trace import phase_collect

    pools, inventory, _, existing = resident_100k_problem(scale)
    ts = TorchScheduler(pools, inventory, existing=list(existing), device=device)
    size = Resources(cpu=0.25, memory="512Mi")
    outcomes: Dict[str, int] = {}
    nodes: List[Optional[str]] = []

    def record(res) -> None:
        outcomes[res.outcome] = outcomes.get(res.outcome, 0) + 1
        nodes.append(next(iter(res.placements.values()))
                     if res.outcome == "nominated" else None)

    scope = OBSERVATORY.begin_scope()
    try:
        t0 = time.perf_counter()
        ts.solve([Pod(requests=size)])
        seeded = bool(ts._resident.states)
        record(fastpath.try_admit(ts, [Pod(requests=size)]))
        cold_ms = (time.perf_counter() - t0) * 1e3
        ts._resident.note_sync(ts)
        for _ in range(ADMISSION_WARMUP):
            record(fastpath.try_admit(ts, [Pod(requests=size)]))
        cold = _scope_totals(scope)
        gc_was = gc.isenabled()
        gc.disable()
        try:
            passes = []
            for _ in range(2):
                one = []
                for _ in range(iters):
                    pod = Pod(requests=size)
                    sink: Dict[str, float] = {}
                    t0 = time.perf_counter()
                    with phase_collect(sink):
                        res = fastpath.try_admit(ts, [pod])
                    one.append((time.perf_counter() - t0, sink))
                    record(res)
                passes.append(one)
        finally:
            if gc_was:
                gc.enable()
        warm = _scope_totals(scope)
    finally:
        OBSERVATORY.end_scope(scope)
    samples = [min(a, b, key=lambda s: s[0]) for a, b in zip(*passes)]
    times = sorted(s[0] for s in samples)
    i99 = min(iters - 1, math.ceil(0.99 * iters) - 1)
    p99_s, phases = sorted(samples, key=lambda s: s[0])[i99]
    q = statistics.quantiles(times, n=4) if iters > 1 else [times[0]] * 3
    return {
        "seeded": seeded,
        "live_nodes": len(existing),
        "iters": iters,
        "attempts": len(nodes),
        "p99_ms": p99_s * 1e3,
        "p50_ms": statistics.median(times) * 1e3,
        "noise_ms": (q[2] - q[0]) * 1e3,
        "p99_phases_ms": {k: v * 1e3 for k, v in sorted(phases.items())},
        "cold_ms": cold_ms,
        "outcomes": dict(sorted(outcomes.items())),
        "nodes": nodes,
        "new_signatures_cold": cold[0],
        "transfer_bytes_cold": cold[1],
        "new_signatures_warm": warm[0] - cold[0],
        "transfer_bytes_warm": (warm[1] - cold[1]) / (2 * iters),
        "link_floor_ms": link_floor_ms(ts.device),
    }


def pipeline_state(env) -> tuple:
    """One tick's state as ``tests/test_pipeline.py``'s twin test takes it:
    the NodeClaims marked for deletion, the disruption controller's pending
    set, and each pod's node."""
    kube = env.kube
    return (
        tuple(sorted(n for n, cl in kube.node_claims.items() if cl.deleted_at is not None)),
        tuple(sorted(env.operator.disruption._pending)),
        tuple(sorted((p.key(), p.node_name or "") for p in kube.pods.values())),
    )


def _outcomes(reg) -> Dict[str, int]:
    got = reg.counters.get("karpenter_pipeline_speculation_total", {})
    return {dict(k)["outcome"]: int(v) for k, v in sorted(got.items())}


def pipelined_tick_drive(device=None, pipelined: bool = True, ticks: int = PIPELINE_TICKS,
                         seed: int = PIPELINE_SEED, trace=None, tick_span=None) -> dict:
    """One schedule of ``bench.run_pipelined_tick`` on ``device`` (None: the
    card): `PIPELINE_SCENARIO` through `ScenarioRunner` with
    ``op.pipeline.enabled`` set to ``pipelined`` and the search population
    at `PIPELINE_POPULATION`, `PIPELINE_TICK_GAP_S` of real sleep after
    each tick.  ``trace`` (a `TraceWriter`) records the ticks' events, API
    calls and ledger lines; ``tick_span(t)``, where given, is a context
    manager each tick runs in (a profiler's ``record_function``, say).
    Returns the tick p50 ms, each controller's p50 ms and the largest,
    ``overlap_seconds``, the speculation outcomes in all and tick by tick,
    each tick's `pipeline_state`, and the wall seconds."""
    import contextlib

    from karpenter_tpu_torch.sim.runner import SCENARIOS, ScenarioRunner
    from karpenter_tpu_torch.utils.clock import Clock

    wall = Clock()  # the gap is real time, as bench sleeps it
    scn = SCENARIOS[PIPELINE_SCENARIO](ticks)
    runner = ScenarioRunner(scn, seed=seed, ticks=ticks, trace=trace, device=device)
    op = runner.env.operator
    op.pipeline.enabled = pipelined
    op.disruption.search_population = PIPELINE_POPULATION
    reg = runner.env.registry
    states, by_tick = [], []
    t0 = time.perf_counter()
    for t in range(ticks):
        events = [ev for w in scn.workloads for ev in w.events(t, runner.rng, runner.view)]
        before = _outcomes(reg)
        with tick_span(t) if tick_span else contextlib.nullcontext():
            runner._tick(t, scn.tick_s, "run", events)
        after = _outcomes(reg)
        by_tick.append({k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)})
        states.append(pipeline_state(runner.env))
        wall.sleep(PIPELINE_TICK_GAP_S)
    wall_s = time.perf_counter() - t0
    p50 = reg.quantile("karpenter_reconcile_tick_duration_seconds", 0.5) * 1e3
    phases = {}
    for name in TICK_CONTROLLERS:
        q = reg.quantile("karpenter_controller_reconcile_time_seconds", 0.5,
                         {"controller": name})
        if q > 0.0:
            phases[name] = q * 1e3
    overlap_s = sum(h.total for h in
                    reg.histograms.get("karpenter_reconcile_overlap_seconds", {}).values())
    max_phase = max(phases.values()) if phases else 0.0
    return {
        "pipelined": pipelined,
        "ticks": ticks,
        "p50_ms": p50,
        "phases_ms": phases,
        "max_phase_ms": max_phase,
        "max_phase": max(phases, key=phases.get) if phases else None,
        "p50_vs_max_phase": p50 / max_phase if max_phase else None,
        "sum_phases_ms": sum(phases.values()),
        "overlap_seconds": overlap_s,
        "outcomes": _outcomes(reg),
        "outcomes_by_tick": by_tick,
        "states": states,
        "verdict_mismatch": reg.counter("karpenter_consolidation_verdict_mismatch_total"),
        "wall_s": wall_s,
    }


def load_harness_drive(device=None, ticks: int = LOAD_HARNESS_TICKS,
                       seed: int = LOAD_HARNESS_SEED, trace=None) -> dict:
    """``bench.run_load_harness`` on ``device`` (None: the card):
    `LOAD_HARNESS_SCENARIO` through the simulator's ``run_scenario``
    (``trace``, a `TraceWriter`, where given).  Returns the events applied,
    the ticks checked on the vectorized invariant plane, the invariant
    violations, the simulator's phase totals in seconds (generate / apply /
    reconcile / invariants), the harness fraction (generate + invariants
    over their sum), the events a second and the wall seconds, and the
    report."""
    from karpenter_tpu_torch.sim.runner import run_scenario

    t0 = time.perf_counter()
    runner, report = run_scenario(LOAD_HARNESS_SCENARIO, seed, ticks, trace=trace,
                                  device=device)
    wall_s = time.perf_counter() - t0
    reg = runner.env.registry
    totals = {}
    for labels, h in reg.histograms.get("karpenter_sim_phase_seconds", {}).items():
        totals[labels[0][1] if labels else ""] = h.total
    phase_s = sum(totals.values())
    harness_s = totals.get("generate", 0.0) + totals.get("invariants", 0.0)
    events = sum(runner.event_counts.values())
    return {
        "ticks": ticks,
        "events": events,
        "event_counts": dict(sorted(runner.event_counts.items())),
        "vector_checked_ticks": int(reg.counter("karpenter_load_vector_checked_ticks_total")),
        "violations": report["invariants"]["violations"],
        "phases_s": dict(sorted(totals.items())),
        "phase_total_s": phase_s,
        "harness_s": harness_s,
        "harness_fraction": harness_s / phase_s if phase_s > 0 else 0.0,
        "events_per_s": events / wall_s if wall_s else None,
        "wall_s": wall_s,
        "report": report,
    }


# ---------------------------------------------------------------------------
# The device mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------


def cpu_mesh(shape: Tuple[int, int] = (4, 2)):
    """A (data, model) mesh of ``shape`` CPU shards: the shard kernels'
    plain versions and the exchange between shards run in one process, the
    counterpart of the JAX tests' 8 virtual CPU devices."""
    import torch

    from karpenter_tpu_torch.parallel.mesh import Mesh

    D, M = shape
    return Mesh(tuple(tuple(torch.device("cpu") for _ in range(M)) for _ in range(D)))


MESH_STEP_ARGS = (
    "type_ok", "zone_ok", "ct_ok", "sig_of", "t_of", "z_of", "ct_of",
    "req", "cnt", "maxper", "slot", "alloc", "price", "openable",
    "used0", "cfg0", "npods0", "next0", "sig0",
)


def mesh_step_problem(seed: int = 42, classes: int = 16, k_slots: int = 32,
                      types: int = 8) -> dict:
    """The factorized admission problem of the JAX package's mesh tests
    (tests/test_parallel.py's fixture, at its defaults): 4 signatures,
    ``types`` types x 2 zones x 2 capacity types x 2 (64 configs at 8
    types), ``classes`` classes of 5 pods, ``k_slots`` empty slots;
    `MESH_STEP_ARGS` orders its arrays as ``sharded_solve_step`` takes
    them."""
    S, T, Z, CT, R = 4, types, 2, 2, 6
    C = T * Z * CT * 2
    G, K = classes, k_slots
    rng = np.random.RandomState(seed)
    return dict(
        type_ok=rng.rand(S, T) < 0.8,
        zone_ok=np.ones((S, Z), bool),
        ct_ok=np.ones((S, CT), bool),
        sig_of=(np.arange(G) % S).astype(np.int32),
        t_of=(np.arange(C) % T).astype(np.int32),
        z_of=((np.arange(C) // T) % Z).astype(np.int32),
        ct_of=((np.arange(C) // (T * Z)) % CT).astype(np.int32),
        req=(np.abs(rng.rand(G, R)) + 0.1).astype(np.float32),
        cnt=np.full(G, 5, np.int32),
        maxper=np.full(G, 2**20, np.int32),
        slot=np.zeros(G, np.int32),
        alloc=(np.abs(rng.rand(C, R)) * 16 + 8).astype(np.float32),
        price=(rng.rand(C) + 0.5).astype(np.float32),
        openable=np.ones(C, bool),
        used0=np.zeros((K, R), np.float32),
        cfg0=np.full(K, -1, np.int32),
        npods0=np.zeros(K, np.int32),
        next0=np.int32(0),
        sig0=np.zeros((5, K), np.int32),
    )


def assemble_arrays(G: int = 37, C: int = 100, S: int = 5, T: int = 23, Z: int = 3,
                    CT: int = 2, seed: int = 7) -> tuple:
    """The seven admission arrays of the factorized feasibility expansion
    (``type_ok [S, T]``, ``zone_ok [S, Z]``, ``ct_ok [S, CT]`` bool, about
    70 % true; ``sig_of [G]``, ``t_of``, ``z_of``, ``ct_of [C]`` int32),
    every index drawn in range from ``seed``: at the defaults no size is a
    multiple of 16; with ``S == G`` every class has a signature of its
    own."""
    rng = np.random.RandomState(seed)
    sig_of = rng.permutation(G) if S == G else rng.randint(0, S, G)
    return (rng.rand(S, T) < 0.7, rng.rand(S, Z) < 0.7, rng.rand(S, CT) < 0.7,
            sig_of.astype(np.int32), rng.randint(0, T, C).astype(np.int32),
            rng.randint(0, Z, C).astype(np.int32), rng.randint(0, CT, C).astype(np.int32))


def deep_class_pods(n: int = 600) -> List[Pod]:
    """``n`` pods over about 200 (cpu, memory) request classes: the deep
    sequential class axis of the JAX package's
    ``test_sharded_deep_class_axis_parity``."""
    return [
        Pod(requests=Resources(cpu=0.25 * (1 + i % 40), memory=f"{1 + (i // 40) % 5}Gi"))
        for i in range(n)
    ]


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


# ---------------------------------------------------------------------------
# The operator's environment: fake cloud, fake kubelet, fake clock
# ---------------------------------------------------------------------------

# tests shrink the batching windows so coalescing still happens but specs
# don't wait out the production 35-100ms idle windows
FAST_BATCH_WINDOWS = {
    "create_fleet": (0.002, 0.05, 1000),
    "describe": (0.002, 0.05, 500),
    "terminate": (0.002, 0.05, 500),
}


class FakeKubelet:
    """Registers Nodes for launched instances and binds nominated pods —
    the cluster-side machinery the controller does not own."""

    def __init__(self, env: "Environment", startup_delay: float = 0.0):
        self.env = env
        self.startup_delay = startup_delay

    def step(self) -> None:
        self._register_nodes()
        self._bind_nominated_pods()

    def _register_nodes(self) -> None:
        kube = self.env.kube
        now = self.env.clock.now()
        for claim in list(kube.node_claims.values()):
            if not claim.provider_id or claim.deleted_at is not None:
                continue
            inst = self.env.cloud.instances.get(claim.provider_id)
            if inst is None or inst.state != "running":
                continue
            if kube.node_by_provider_id(claim.provider_id) is not None:
                continue
            if now - claim.created_at < self.startup_delay:
                continue
            labels = dict(claim.labels)
            labels[L.LABEL_HOSTNAME] = claim.name
            kube.put_node(
                Node(
                    name=claim.name,
                    provider_id=claim.provider_id,
                    labels=labels,
                    taints=list(claim.taints),  # startup taints already gone
                    capacity=claim.capacity,
                    allocatable=claim.allocatable,
                    ready=True,
                    created_at=now,
                )
            )

    def _bind_nominated_pods(self) -> None:
        kube = self.env.kube
        cluster = self.env.cluster
        for pod in list(kube.pods.values()):
            if pod.node_name or pod.phase != "Pending":
                continue
            target = cluster.nominated_node(pod.key())
            if target is None:
                continue
            node = kube.nodes.get(target)
            if node is None or not node.ready or node.cordoned:
                continue
            # the real kubelet rejects pods that don't tolerate the node's
            # taints — a taint added after nomination must block the bind
            if not tolerates_all(pod.tolerations, node.taints):
                continue
            kube.bind_pod(pod.key(), node.name)
            cluster.clear_nomination(pod.key())


class Environment:
    """The port's operator over the fake cloud, a fake clock and a fake
    kubelet.  ``device`` is where the Provisioner's solver runs (the card
    unless the caller asks for the CPU); the default Settings are the
    reference's, so the admission fast path is on."""

    def __init__(
        self,
        shapes: Optional[Sequence[MachineShape]] = None,
        zones: Sequence[str] = ("zone-a", "zone-b", "zone-c"),
        settings: Optional[Settings] = None,
        node_startup_delay: float = 0.0,
        device=None,
    ):
        self._shapes = list(shapes) if shapes is not None else generate_catalog()
        self._zones = tuple(zones)
        self._node_startup_delay = node_startup_delay
        self._device = device
        self.clock = FakeClock()
        self.settings = settings or Settings(cluster_name="test")
        self._build()

    def _build(self) -> None:
        self.cloud = FakeCloud(
            self.clock, shapes=self._shapes, zones=self._zones
        ).with_default_topology()
        self.kube = KubeStore()
        self.registry = Registry()  # per-spec metrics; reset() starts fresh
        self.operator = Operator(
            self.cloud,
            self.kube,
            settings=self.settings,
            clock=self.clock,
            registry=self.registry,
            batch_windows=FAST_BATCH_WINDOWS,
            device=self._device,
        )
        self.kubelet = FakeKubelet(self, startup_delay=self._node_startup_delay)
        # provider aliases (suites address them directly, like the
        # reference's test env exposes every provider)
        op = self.operator
        self.cluster = op.cluster
        self.unavailable = op.unavailable
        self.pricing = op.pricing
        self.subnets = op.subnets
        self.security_groups = op.security_groups
        self.images = op.images
        self.version = op.version
        self.instance_profiles = op.instance_profiles
        self.launch_templates = op.launch_templates
        self.instance_types = op.instance_types
        self.instances = op.instances
        self.cloud_provider = op.cloud_provider

    # ------------------------------------------------------------- stepping
    def step(self, seconds: float = 1.0, reconciles: int = 1) -> None:
        """Advance the fake clock and run kubelet + every controller."""
        self.clock.step(seconds)
        for _ in range(reconciles):
            self.kubelet.step()
            self.operator.reconcile_once()
            self.kubelet.step()

    def settle(self, max_rounds: int = 30, seconds: float = 2.0) -> None:
        """Step until no pending pods remain (or rounds run out), plus one
        trailing tick so status controllers observe the settled state."""
        for _ in range(max_rounds):
            if not self.kube.pending_pods():
                break
            self.step(seconds)
        self.step(seconds)

    # ------------------------------------------------------------- defaults
    def default_node_class(self) -> NodeClass:
        nc = NodeClass(
            name="default",
            subnet_selector_terms=[SelectorTerm.of(Name="*")],
            security_group_selector_terms=[SelectorTerm.of(Name="*")],
        )
        self.kube.put_node_class(nc)
        return nc

    def default_node_pool(self, **kw) -> NodePool:
        pool = NodePool(name=kw.pop("name", "default"), node_class_ref="default", **kw)
        self.kube.put_node_pool(pool)
        return pool

    def reset(self) -> None:
        """Fresh kube state, fresh cloud (instances/capacity/IP spend gone),
        fresh caches — mirrors reference environment.go:150-176 which resets
        the fake EC2 API between specs."""
        self._build()


def operator_state(env) -> dict:
    """An operator environment's cluster as comparable plain data: the
    NodeClaims, the Nodes, each pod's binding and nomination, every fake
    cloud API call in order, the event ledger's stream and its count by
    type, the compile-cache and resident counters the Provisioner and the
    disruption controller export, the admission fast path's outcomes,
    fallback reasons and mismatches, and the disruption side: every
    instance ever launched with its claim and state (the NodeClaims created
    and deleted), the claims marked for deletion, the replacement claims,
    the disruption counters (actions by mechanism and pool, evaluations by
    path, verdict mismatches, search winners) and the ledger's
    ``NodeDisrupted`` and ``VerdictFallback`` events in order.  It reads
    attributes only, so it serves the JAX package's `Environment` too.

    The diagnosis layer's wall-clock events are left out, of the event
    stream and of the counts by type: ``AnomalyDetected`` (the detector
    judges wall-time series), ``DeviceRecompile`` (a warm new launch
    signature or jit compile depends on what the process ran before) and
    the ``SLOBreach`` / ``SLORecovered`` events of the rules that read the
    tick's wall time (signal `WALL_CLOCK_SIGNAL`; their count comes from
    the SLO engine's own tally).  Two drives of one scenario, on two
    devices or two packages, interleave a different number of them, so
    the events keep their order without their sequence numbers, and the
    SLO events of the other rules stay in.  The ledger's ring keeps its
    last 4096 events, so once more than `LEDGER_COMPARED` deterministic
    events were emitted only the last `LEDGER_COMPARED` are kept: the
    wall-clock events in a ring push a different number of the others
    out.  Raises if a ring holds fewer than that."""
    kube, reg = env.kube, env.registry
    claims = sorted(
        (
            c.name, c.pool_name, c.instance_type_name, c.zone,
            c.capacity_type, c.provider_id, sorted(c.conditions.items()),
            c.deleted_at,
        )
        for c in kube.node_claims.values()
    )
    nodes = sorted(
        (
            n.name, n.provider_id, sorted(n.labels.items()), n.ready,
            n.cordoned, n.deleted_at,
        )
        for n in kube.nodes.values()
    )
    pods = sorted(
        (key, p.node_name, p.phase, env.cluster.nominated_node(key))
        for key, p in kube.pods.items()
    )
    calls = {
        api: [repr(args) for args in seq]
        for api, seq in sorted(env.cloud.recorder.calls.items())
    }
    # the ledger's ring keeps its last 4096 events; the registry counts
    # every event by type
    event_counts = {
        dict(labels)["type"]: v
        for labels, v in reg.counters.get("karpenter_events_total", {}).items()
        if dict(labels)["type"] not in WALL_CLOCK_EVENTS
    }
    slo = env.operator.slo
    for rule in slo.rules:
        state = slo._states.get(rule.name)
        if rule.signal == WALL_CLOCK_SIGNAL and state is not None:
            for kind, n in (("SLOBreach", state.breaches),
                            ("SLORecovered", state.recoveries)):
                if n:
                    event_counts[kind] -= n
    event_counts = {k: v for k, v in event_counts.items() if v}
    events = [
        (ev.ts, ev.type, ev.trace_id, sorted(ev.attrs.items()))
        for ev in env.operator.ledger.recent(limit=1 << 30)
        if not wall_clock_event(ev.type, ev.attrs)
    ]
    keep = min(LEDGER_COMPARED, int(sum(event_counts.values())))
    if len(events) < keep:
        raise RuntimeError(
            f"the ledger ring holds {len(events)} deterministic events of "
            f"the last {keep}: too many wall-clock events to compare"
        )
    events = events[len(events) - keep:]
    counters = {
        name: sorted(reg.counters.get(name, {}).items())
        for name in (
            "karpenter_solver_compile_cache_hits_total",
            "karpenter_solver_compile_cache_misses_total",
            "karpenter_solver_resident_hits_total",
            "karpenter_solver_resident_rebuilds_total",
            "karpenter_admission_fastpath_total",
            "karpenter_admission_fastpath_fallback_total",
            "karpenter_admission_fastpath_mismatch_total",
            "karpenter_deprovisioning_actions",
            "karpenter_consolidation_evals_total",
            "karpenter_consolidation_verdict_mismatch_total",
            "karpenter_consolidation_search_winners_total",
        )
    }
    # every launch the fake cloud holds, terminated ones included: the
    # NodeClaims created and, by their state, deleted
    instances = sorted(
        (i.id, i.tags.get("karpenter.sh/nodeclaim", ""), i.instance_type,
         i.zone, i.capacity_type, i.state)
        for i in env.cloud.instances.values()
    )
    disrupted = [
        (ev.ts, ev.type, sorted(ev.attrs.items()))
        for ev in env.operator.ledger.recent(limit=1 << 30)
        if ev.type in DISRUPTION_EVENTS
    ]
    disruption = {
        "instances": instances,
        "marked": sorted(
            c.name for c in kube.node_claims.values() if c.deleted_at is not None
        ),
        "replacements": [
            (dict(attrs)["node"], dict(attrs)["replacement"])
            for _ts, _type, attrs in disrupted
            if "replacement" in dict(attrs)
        ],
        "events": disrupted,
    }
    return {
        "claims": claims, "nodes": nodes, "pods": pods, "calls": calls,
        "events": events, "event_counts": event_counts, "counters": counters,
        "disruption": disruption,
    }


# the ledger events of the disruption controller's decisions
DISRUPTION_EVENTS = ("NodeDisrupted", "VerdictFallback")

# the diagnosis layer's events that depend on wall-clock time or process
# history, and the SLO signal that reads the tick's wall time
WALL_CLOCK_EVENTS = ("AnomalyDetected", "DeviceRecompile")
WALL_CLOCK_SIGNAL = "tick_duration_p99"
# deterministic ledger events `operator_state` compares at most: the ring's
# 4096 less room for 512 wall-clock events
LEDGER_COMPARED = 3584


def wall_clock_event(type_: str, attrs: dict) -> bool:
    """A ledger event that a second drive of the same scenario need not
    repeat: the detector's, a warm recompile, and the SLO transitions of a
    rule on the tick's wall time."""
    return type_ in WALL_CLOCK_EVENTS or (
        type_ in ("SLOBreach", "SLORecovered")
        and attrs.get("signal") == WALL_CLOCK_SIGNAL
    )


# phase 9 of chip_smoke: config 2's 10,000 pods bound, then a seeded half
# deleted, and the pools' consolidate_after lowered to a few ticks
CONSOLIDATION_SEED = 13
CONSOLIDATION_SHARE = 0.5
CONSOLIDATE_AFTER_S = 6.0


def consolidating_cluster(device=None, n_pods: int = N_PODS) -> "Environment":
    """A cluster for consolidation through the operator, the same for
    either device: an `Environment` on ``device`` over config 2's catalog
    with its ``general`` and tainted ``dedicated`` pools and a default
    NodeClass; the first ``n_pods`` of `heterogeneous_pods` go into the
    store and the run ticks (2 s of fake clock) until every pod is bound,
    the pools' ``consolidate_after`` outlasting the bind; then a
    `CONSOLIDATION_SHARE` of the bound pods, drawn uniformly with numpy's
    ``default_rng(CONSOLIDATION_SEED)``, is deleted, which leaves most
    nodes part-empty, and each pool's ``consolidate_after`` is lowered to
    `CONSOLIDATE_AFTER_S`.  Launches go one at a time in claim order, so
    two drives hand out the same instance ids.  The Settings are the
    reference's defaults (the pipelined schedule, drift and the admission
    fast path on).  Raises if a pod is still pending after 12 ticks."""
    from karpenter_tpu_torch.api import Disruption
    from karpenter_tpu_torch.api.objects import reset_name_sequences

    reset_name_sequences()
    env = Environment(
        shapes=generate_catalog(**CONFIG2_CATALOG),
        settings=Settings(cluster_name="consolidation"),
        device=device,
    )
    env.default_node_class()
    hold = Disruption(consolidate_after=1e9)
    env.default_node_pool(name="general", disruption=hold)
    env.default_node_pool(name="dedicated", taints=[DEDICATED_TAINT],
                          disruption=dataclasses.replace(hold))
    env.operator.provisioner.launch_concurrency = 1
    for p in heterogeneous_pods(n_pods):
        env.kube.put_pod(p)
    for _ in range(12):
        env.step(2.0)
        if not env.kube.pending_pods():
            break
    if env.kube.pending_pods():
        raise RuntimeError(
            f"{len(env.kube.pending_pods())} of {n_pods} pods unbound after 12 ticks"
        )
    bound = sorted(k for k, p in env.kube.pods.items() if p.node_name)
    rng = np.random.default_rng(CONSOLIDATION_SEED)
    size = int(len(bound) * CONSOLIDATION_SHARE)
    for i in sorted(rng.choice(len(bound), size=size, replace=False)):
        env.kube.delete_pod(bound[i])
    for pool in env.kube.node_pools.values():
        pool.disruption = dataclasses.replace(
            pool.disruption, consolidate_after=CONSOLIDATE_AFTER_S
        )
    return env


# ---------------------------------------------------------------------------
# Two replicas over one shared cluster store (leader election, failover)
# ---------------------------------------------------------------------------

HA_REPLICAS = ("replica-a", "replica-b")
# the failover drive's terms: A leads first, B takes over after A's crash,
# A again after B's graceful release
HA_TERMS = ("A1", "B1", "A2")
HA_CHURN_ROUNDS = (3, 3, 2)  # churn rounds in each term
HA_TICK_S = 2.0  # fake-clock seconds a round
HA_BIND_ROUNDS = 12  # rounds the first batch may take to bind
HA_SYNC_TIMEOUT_S = 60.0  # wall seconds a mirror may take to catch up


class HAHarness:
    """Two operator replicas failing over on one shared cluster store.

    One `StoreServer` (``service/store_server.py``) on a free port, two
    `RemoteKubeStore` clients of it (``state/remote.py``, negotiating the
    codec: ``bin1`` against this server) and two `Operator`s, each with a
    `LeaderElector` over its client's Lease and a `Registry` of its own,
    over one `FakeCloud` and `FakeClock`; the operators' solvers run on
    ``device``, and they launch one claim at a time.  The shape of the JAX
    package's election-storm harness (``tests/test_election_storm.py``),
    driven from the caller's thread:

    - `round` steps the clock and runs the kubelet and one
      ``reconcile_once`` of every replica not in ``crashed`` (A first), with
      `sync` after every clock step, kubelet step and tick: both mirrors wait
      until they hold the server's latest write (reads would otherwise
      race the watch stream);
    - `kubelet_step` registers Nodes for running instances and binds the
      pods the current leader nominated (a deposed replica's nominations
      are inert);
    - ``launches`` lists every ``CloudProvider.create`` as (round, replica,
      claim), ``ticks`` every tick as a dict (`tick`), ``flush_ms`` each
      replica's ``_flush_dirty`` calls (the method wrapped on the client)
      and ``sync_ms`` each `sync`'s wall ms.

    `parts` names the classes the harness builds from and `operator` builds
    one replica's operator: a twin of the same drive on another package
    overrides both."""

    def __init__(self, device=None, shapes=None, settings=None, launches=None,
                 on_tick=None):
        p = self.parts()
        self.p = p
        p.reset_name_sequences()
        self.device = device
        self.server = p.StoreServer().start_background()
        host, port = self.server.address
        self.clock = p.FakeClock()
        self.cloud = p.FakeCloud(
            self.clock, shapes=shapes if shapes is not None else p.generate_catalog()
        ).with_default_topology()
        self.settings = settings or p.Settings(cluster_name="ha")
        self.counters = launches  # kernel launch counters to diff a tick (or None)
        self.on_tick = on_tick  # on_tick(harness, record) after each tick
        self.kubes, self.ops = {}, {}
        self.launches: List[tuple] = []
        self.ticks: List[dict] = []
        self.flush_ms: Dict[str, List[float]] = {}
        self.sync_ms: List[float] = []
        self.round_no = 0
        self.term = HA_TERMS[0]
        self.crashed: set = set()
        self._flushed = 0.0
        for name in HA_REPLICAS:
            kube = p.RemoteKubeStore(host, port, identity=name)
            elector = p.LeaderElector(kube, self.clock, name)
            op = self.operator(kube, elector, p.Registry())
            op.provisioner.launch_concurrency = 1
            self._instrument(op, kube, name)
            self.kubes[name] = kube
            self.ops[name] = op
        self._await_watches()

    def _await_watches(self) -> None:
        """Wait until each client's watch stream has made its first state
        transfer.  A write made before it can be lost from the writer's
        own mirror: the first snapshot, taken before the write, sweeps a
        key the server has acknowledged, and the stream never echoes a
        client's own writes back to it.  It polls on each client's pacing
        clock, as the client's own `wait_synced` does."""
        for name, kube in self.kubes.items():
            deadline = kube.clock.now() + HA_SYNC_TIMEOUT_S
            while not all(ch.ever_synced for ch in kube._channels):
                if kube.clock.now() > deadline:
                    raise AssertionError(f"mirror {name}: no first watch transfer")
                kube.clock.sleep(0.005)

    @staticmethod
    def parts():
        """The port's classes the harness builds from."""
        from types import SimpleNamespace

        from karpenter_tpu_torch.api import reset_name_sequences
        from karpenter_tpu_torch.controllers.consistency import CHECK_PERIOD
        from karpenter_tpu_torch.service.store_server import StoreServer
        from karpenter_tpu_torch.state.remote import RemoteKubeStore
        from karpenter_tpu_torch.state.wire import STORE_KINDS, canonical
        from karpenter_tpu_torch.utils.leader import LEASE_DURATION_S, LeaderElector

        return SimpleNamespace(
            StoreServer=StoreServer, RemoteKubeStore=RemoteKubeStore,
            LeaderElector=LeaderElector, LEASE_DURATION_S=LEASE_DURATION_S,
            FakeCloud=FakeCloud, FakeClock=FakeClock, generate_catalog=generate_catalog,
            Registry=Registry, Settings=Settings, Pod=Pod, Node=Node,
            NodeClass=NodeClass, NodePool=NodePool, SelectorTerm=SelectorTerm,
            labels=L, tolerates_all=tolerates_all,
            reset_name_sequences=reset_name_sequences,
            STORE_KINDS=STORE_KINDS, canonical=canonical, CHECK_PERIOD=CHECK_PERIOD,
        )

    def operator(self, kube, elector, registry):
        return Operator(
            self.cloud, kube, settings=self.settings, clock=self.clock,
            registry=registry, batch_windows=FAST_BATCH_WINDOWS, elector=elector,
            device=self.device,
        )

    def _instrument(self, op, kube, name: str) -> None:
        create = op.cloud_provider.create

        def launch(claim, _create=create):
            self.launches.append((self.round_no, name, claim.name))
            return _create(claim)

        op.cloud_provider.create = launch
        flush = kube._flush_dirty
        self.flush_ms[name] = []

        def timed_flush(_flush=flush):
            t0 = time.perf_counter()
            try:
                _flush()
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                self.flush_ms[name].append(ms)
                self._flushed += ms

        kube._flush_dirty = timed_flush

    # ------------------------------------------------------------- plumbing
    def close(self) -> None:
        for kube in self.kubes.values():
            kube.close()
        self.server.stop()

    def sync(self, note: str = "") -> None:
        """Both mirrors hold every write the server has applied, or
        AssertionError."""
        t0 = time.perf_counter()
        for name, kube in self.kubes.items():
            if not kube.wait_synced(timeout=HA_SYNC_TIMEOUT_S):
                raise AssertionError(
                    f"mirror {name} failed to sync ({note}): synced_rv="
                    f"{kube.synced_rv} server_rv={self.server.store.rv}"
                )
        self.sync_ms.append((time.perf_counter() - t0) * 1e3)

    @property
    def writer(self):
        """The client the cluster's users write through (replica A's)."""
        return self.kubes[HA_REPLICAS[0]]

    def leader(self) -> Optional[str]:
        """The replica whose elector holds the lease, by the server's Lease."""
        for lease in self.server.store.kube.leases.values():
            if lease.holder:
                return lease.holder
        return None

    def default_node_class(self):
        p = self.p
        nc = p.NodeClass(
            name="default",
            subnet_selector_terms=[p.SelectorTerm.of(Name="*")],
            security_group_selector_terms=[p.SelectorTerm.of(Name="*")],
        )
        self.writer.put_node_class(nc)
        return nc

    def node_pool(self, name: str = "default", **kw):
        pool = self.p.NodePool(name=name, node_class_ref="default", **kw)
        self.writer.put_node_pool(pool)
        return pool

    # -------------------------------------------------------------- stepping
    def kubelet_step(self) -> None:
        """Registers Nodes for running instances and binds the pods the
        current leader nominated, through replica A's client (writes
        replicate)."""
        p, kube = self.p, self.writer
        now = self.clock.now()
        for claim in list(kube.node_claims.values()):
            if not claim.provider_id or claim.deleted_at is not None:
                continue
            inst = self.cloud.instances.get(claim.provider_id)
            if inst is None or inst.state != "running":
                continue
            if kube.node_by_provider_id(claim.provider_id) is not None:
                continue
            labels = dict(claim.labels)
            labels[p.labels.LABEL_HOSTNAME] = claim.name
            kube.put_node(p.Node(
                name=claim.name, provider_id=claim.provider_id, labels=labels,
                taints=list(claim.taints), capacity=claim.capacity,
                allocatable=claim.allocatable, ready=True, created_at=now,
            ))
        # leader-first nomination lookup
        ordered = sorted(self.ops.items(), key=lambda kv: not kv[1].elector.leading)
        for pod in list(kube.pods.values()):
            if pod.node_name or pod.phase != "Pending":
                continue
            for _name, op in ordered:
                target = op.cluster.nominated_node(pod.key())
                if target is None:
                    continue
                node = kube.nodes.get(target)
                if node is None or not node.ready or node.cordoned:
                    continue
                if not p.tolerates_all(pod.tolerations, node.taints):
                    continue
                kube.bind_pod(pod.key(), node.name)
                op.cluster.clear_nomination(pod.key())
                break

    def tick(self, name: str) -> dict:
        """One ``reconcile_once`` of replica ``name``, read back as a dict:
        round, replica, term, whether it led, the kind of its solve ("" for
        none), its wall ms, its ``_flush_dirty`` ms, the nominations it
        added and the kernel launches it counted (with ``launches``)."""
        op = self.ops[name]
        sched = op.provisioner.scheduler
        before = solver_counters(sched)
        counted = dict(self.counters) if self.counters is not None else {}
        noms = len(op.cluster._nominations)
        self._flushed = 0.0
        t0 = time.perf_counter()
        op.reconcile_once()
        ms = (time.perf_counter() - t0) * 1e3
        after = solver_counters(sched)
        rec = {
            "round": self.round_no, "replica": name, "term": self.term,
            "led": op.elector.leading, "kind": solve_kind(before, after),
            "tick_ms": ms, "flush_ms": self._flushed,
            "nominated": max(0, len(op.cluster._nominations) - noms),
            "launches": {k: v - counted.get(k, 0) for k, v in self.counters.items()
                         if v - counted.get(k, 0)} if self.counters is not None else {},
            "clock": self.clock.now(),
        }
        self.ticks.append(rec)
        if self.on_tick is not None:
            self.on_tick(self, rec)
        return rec

    def round(self) -> List[dict]:
        """One round: the clock steps `HA_TICK_S`, the kubelet steps, every
        replica not crashed ticks (A, then B), the kubelet steps again."""
        self.round_no += 1
        self.clock.step(HA_TICK_S)
        self.sync(f"round {self.round_no} clock")
        self.kubelet_step()
        self.sync(f"round {self.round_no} kubelet")
        recs = []
        for name in HA_REPLICAS:
            if name not in self.crashed:
                recs.append(self.tick(name))
                self.sync(f"round {self.round_no} {name}")
        self.kubelet_step()
        self.sync(f"round {self.round_no} kubelet after")
        return recs

    # ---------------------------------------------------------------- state
    def store_state(self) -> dict:
        """The server's objects, kind by kind, in canonical wire form."""
        p, kube = self.p, self.server.store.kube
        return {
            kind: {key: p.canonical(obj) for key, obj in sorted(getattr(kube, attr).items())}
            for kind, (_cls, attr, _key) in sorted(p.STORE_KINDS.items())
        }

    def view(self, name: str):
        """Replica ``name`` as `operator_state` reads an environment."""
        from types import SimpleNamespace

        op = self.ops[name]
        return SimpleNamespace(kube=self.kubes[name], registry=op.registry,
                               cluster=op.cluster, cloud=self.cloud, operator=op)


def ha_churn(h: HAHarness, rng, n: int) -> None:
    """Replace ``n`` bound pods (drawn from the bound pods in key order) by
    new pending pods of their shapes, through replica A's client."""
    kube = h.writer
    bound = sorted(k for k, p in kube.pods.items() if p.node_name)
    for key in rng.sample(bound, n):
        old = kube.pods[key]
        kube.delete_pod(key)
        kube.put_pod(h.p.Pod(requests=old.requests, node_selector=dict(old.node_selector),
                             tolerations=list(old.tolerations)))


def ha_drive(h: HAHarness, pods, churn_pods: int = 100, churn_rounds=HA_CHURN_ROUNDS,
             seed: int = 3) -> dict:
    """The failover drive: ``pods`` into the store through A's client;
    rounds until every pod is bound with A leading (B a standby), then
    ``churn_rounds[0]`` churn rounds of ``churn_pods`` (each an arrival
    round, a solving round and up to two more while pods wait).  A
    crashes (stops ticking and renewing) and the clock steps past the
    lease; B takes over in a round with no churn (it must launch nothing:
    the pods are placed), then ``churn_rounds[1]`` rounds.  B releases the
    lease; A, with the solver state of its first term, acquires at once
    and runs ``churn_rounds[2]``.  Raises AssertionError where a pod stays
    pending.  Returns the markers: the crash's round and clock, the
    claims at the crash, the launches after B's takeover round."""
    import random

    for pod in pods:
        h.writer.put_pod(pod)
    h.sync("pods")
    rng = random.Random(seed)
    a, b = HA_REPLICAS

    def settle(what: str, rounds: int) -> None:
        for _ in range(rounds):
            if not h.writer.pending_pods():
                return
            h.round()
        if h.writer.pending_pods():
            raise AssertionError(f"{what}: {len(h.writer.pending_pods())} pods pending")

    def churn_round(r: int) -> None:
        ha_churn(h, rng, churn_pods)
        h.sync("churn")
        h.round()
        h.round()
        settle(f"term {h.term} churn round {r + 1}", 2)

    h.term = "A1"
    settle("binding", HA_BIND_ROUNDS)
    for r in range(churn_rounds[0]):
        churn_round(r)
    marks = {"crash_round": h.round_no, "crash_clock": h.clock.now(),
             "claims_at_crash": sorted(h.writer.node_claims)}
    h.crashed = {a}
    h.clock.step(h.p.LEASE_DURATION_S + 1)
    h.term = "B1"
    launched = len(h.launches)
    h.round()  # B's takeover: nothing pending, nothing to launch
    marks["takeover_launches"] = h.launches[launched:]
    marks["claims_after_takeover"] = sorted(h.kubes[b].node_claims)
    for r in range(churn_rounds[1]):
        churn_round(r)
    h.ops[b].elector.release()
    h.crashed = set()
    h.term = "A2"
    for r in range(churn_rounds[2]):
        churn_round(r)
    return marks


def ha_attribution(ticks, launches) -> None:
    """Each round had one leader at most, every launch (round, replica,
    claim) came from the replica that led its round, and no claim launched
    twice; AssertionError otherwise."""
    leaders: Dict[int, set] = {}
    for t in ticks:
        if t["led"]:
            leaders.setdefault(t["round"], set()).add(t["replica"])
    for rnd, names in leaders.items():
        assert len(names) == 1, f"round {rnd} had two leaders: {sorted(names)}"
    for rnd, name, claim in launches:
        assert name in leaders.get(rnd, ()), f"{claim} launched by {name} in round {rnd}"
    claims = [c for _, _, c in launches]
    assert len(claims) == len(set(claims)), "a claim launched twice"


def ha_checks(h: HAHarness, marks: dict) -> None:
    """The drive's invariants, AssertionError on the first that fails:
    `ha_attribution`, each term's replica led its rounds, B launched
    nothing in its takeover round and saw A's claims, no pod pending."""
    ha_attribution(h.ticks, h.launches)
    expect = {"A1": HA_REPLICAS[0], "B1": HA_REPLICAS[1], "A2": HA_REPLICAS[0]}
    for t in h.ticks:
        assert t["led"] == (t["replica"] == expect[t["term"]]), t
    assert not marks["takeover_launches"], marks["takeover_launches"]
    assert marks["claims_after_takeover"] == marks["claims_at_crash"]
    assert not h.writer.pending_pods()


def ha_consistency(h: HAHarness) -> list:
    """Steps the clock past the consistency checker's period, runs the
    leader's checker once and returns the ``ConsistencyViolation`` events
    in the store."""
    leader = next((op for op in h.ops.values() if op.elector.leading), None)
    assert leader is not None, "the drive ended with no leader"
    h.clock.step(h.p.CHECK_PERIOD + 1)
    leader.consistency.reconcile()
    h.sync("consistency")
    return [e for e in h.writer.events if e[1] == "ConsistencyViolation"]
