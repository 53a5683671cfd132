"""Plain reference of the decisions the benchmark's cells time.

Written from the semantics, in NumPy, over the plain data of
`benchmarks/inputs.py`; it imports nothing of the program.  It derives
again everything the program derives from those inputs: each instance
type's allocatable, the launchable configurations and their prices, the
pod classes and their first-fit-decreasing order, feasibility, and then

- `solve`: a provisioning solve's placements: first fit over the open
  nodes (live nodes first, in cluster order), each class's new nodes on
  its best configuration (most pods a node, price as the tie-break), the
  decode's launch-flexible type lists and its compaction of nearly empty
  new nodes, as one canonical tuple;
- `whatif`: a consolidation removal what-if: the removed nodes' pods
  solved onto the rest of the cluster; it fits when nothing is left over
  and at most one new node remains, at that node's cheapest type;
- `admit`: the single-pod fast path's decision: the first live node with
  room, else whether a new node could hold the pod.

The capacity and usage arithmetic is the one the program states for its
tensors: float32, ``floor(rem / req + 1e-4)`` a requested axis, usage
updated by a fused multiply-add, memory in MiB.

The controls that the comparison has to fail break one guarantee the
configurations state: `without_memory` drops every memory request (no node
holds more than its allocatable memory), and ``whatif(...,
without_rest=True)`` solves a removal's pods onto new nodes alone (a
removal's pods land on the rest of the cluster first).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmarks import inputs as I

F32 = np.float32
MIB = 2.0**20
NUDGE = F32(1e-4)
BIGF = F32(2.0**30)
VM_OVERHEAD = 0.075
EVICTION_MEMORY = 100 * MIB
SCALE = np.array([1.0, MIB, 1.0])  # cpu, memory, pods: the axes config 2's pods request
SLACK32 = F32(1e-6)  # `used <= alloc + 1e-6` of the decode's type widening
SLACK64 = 1e-9  # `used <= allocatable + 1e-9` of a placement onto a node
COMPACT_MAX_PODS = 8  # a new node holding at most this many is a donor
LABEL_OS = "kubernetes.io/os"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_FAMILY = "karpenter.tpu/instance-family"
# labels an instance type describes: a selector on one it does not define
# admits no type; a selector on any other key is the pool's to satisfy
CATALOG_KEYS = frozenset({
    I.LABEL_ARCH, LABEL_OS, "topology.kubernetes.io/zone", "topology.kubernetes.io/region",
    LABEL_INSTANCE_TYPE, "node.kubernetes.io/windows-build", "karpenter.sh/capacity-type",
    I.LABEL_CATEGORY, LABEL_FAMILY, "karpenter.tpu/instance-generation",
    "karpenter.tpu/instance-size",
})


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` in float32 with one rounding: the product is exact in
    float64, the float64 sum is rounded to odd (TwoSum's error fixes the
    last bit), and rounding that to float32 is the correctly rounded
    result."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    bits = s.view(np.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    step = np.where((err > 0) == (s > 0), 1, -1)
    return np.where(inexact_even, bits + step, bits).view(np.float64).astype(F32)


def per_node_cap(rem: np.ndarray, req: np.ndarray) -> np.ndarray:
    """How many copies of ``req`` fit in each residual vector (float32):
    ``floor(rem / req + 1e-4)`` on the requested axes, the least of them."""
    pos = req > 0
    safe = np.where(pos, req, F32(1.0))
    per_axis = np.where(pos, np.floor(rem / safe + NUDGE), BIGF)
    cap = per_axis.min(axis=-1)
    return np.clip(cap, F32(0.0), BIGF).astype(np.int64)


# ---------------------------------------------------------------------------
# the catalog: instance types, allocatable, configurations
# ---------------------------------------------------------------------------


def kube_reserved_cpu(cores: float) -> float:
    """6 % of the first core, 1 % of the second, 0.5 % of cores 3-4, 0.25 %
    of the rest."""
    reserved, remaining = 0.0, cores
    for band, frac in ((1, 0.06), (1, 0.01), (2, 0.005), (float("inf"), 0.0025)):
        take = min(remaining, band)
        if take <= 0:
            break
        reserved += take * frac
        remaining -= take
    return reserved


def allocatable(shape: dict) -> Tuple[float, float, float]:
    """Capacity less kube-reserved (cpu curve, 11 MiB a pod + 255 MiB) and
    the 100 MiB eviction threshold; memory after the 7.5 % VM overhead."""
    mp = shape["max_pods"]
    cap_mem = shape["memory"] * (1 - VM_OVERHEAD)
    reserved_mem = (11 * mp + 255) * MIB + EVICTION_MEMORY
    return (max(shape["cpu"] - kube_reserved_cpu(shape["cpu"]), 0.0),
            max(cap_mem - reserved_mem, 0.0), float(mp))


def scaled32(raw: Sequence[float]) -> np.ndarray:
    """A raw resource vector on the tensors' axes: memory in MiB, float32."""
    return np.array([v / s for v, s in zip(raw, SCALE)], dtype=F32)


def type_labels(shape: dict) -> Dict[str, str]:
    return {I.LABEL_ARCH: shape["arch"], LABEL_OS: "linux", LABEL_INSTANCE_TYPE: shape["name"],
            I.LABEL_CATEGORY: shape["category"], LABEL_FAMILY: shape["family"],
            "karpenter.tpu/instance-generation": str(shape["generation"]),
            "karpenter.tpu/instance-size": shape["size"]}


def node_labels(node: dict, shape: dict) -> Dict[str, str]:
    """The labels a live node carries: its type's, its zone, pool,
    capacity type and hostname."""
    return {**type_labels(shape), "topology.kubernetes.io/zone": node["zone"],
            I.LABEL_NODEPOOL: node["pool"], "karpenter.sh/capacity-type": node["capacity_type"],
            "kubernetes.io/hostname": node["name"]}


def tolerates(tolerations: Sequence[tuple], taints: Sequence[tuple]) -> bool:
    """Every NoSchedule / NoExecute taint tolerated by an equal key, value
    and effect."""
    return all(eff == "PreferNoSchedule" or any(
        t[0] == key and t[1] == val and (not t[2] or t[2] == eff) for t in tolerations)
        for key, val, eff in taints)


class Catalog:
    """The launchable configurations: for each pool (all of weight 0, in
    the given order), each type by name, each zone, on demand then spot."""

    def __init__(self, shapes: Sequence[dict], pools: Sequence[dict], zones=I.ZONES):
        self.shapes = sorted(shapes, key=lambda s: s["name"])
        self.type_of = {s["name"]: i for i, s in enumerate(self.shapes)}
        self.pools = list(pools)
        self.zones = list(zones)
        self.alloc64 = np.array([allocatable(s) for s in self.shapes])  # [T, 3]
        self.alloc32_t = np.stack([scaled32(a) for a in self.alloc64])
        self.labels = [type_labels(s) for s in self.shapes]
        spot = I.spot_prices(self.shapes)
        pool, typ, zone, ct, price = [], [], [], [], []
        for p in range(len(self.pools)):
            for t, s in enumerate(self.shapes):
                for z, zn in enumerate(self.zones):
                    for c, pr in ((0, s["od_price"]), (1, spot[(s["name"], zn)])):
                        pool.append(p), typ.append(t), zone.append(z), ct.append(c)
                        price.append(pr)
        self.cfg_pool, self.cfg_type = np.array(pool), np.array(typ)
        self.cfg_zone, self.cfg_ct = np.array(zone), np.array(ct)
        self.price = price  # python floats: the offering prices
        self.price32 = np.array(price, dtype=F32)
        self.alloc32 = self.alloc32_t[self.cfg_type]  # [C, 3]
        self._rows: Dict[tuple, np.ndarray] = {}

    def type_ok(self, selector: Dict[str, str]) -> np.ndarray:
        """[T]: the types whose labels admit the selector."""
        ok = np.ones(len(self.shapes), bool)
        for key, val in selector.items():
            if key == I.LABEL_NODEPOOL or key not in CATALOG_KEYS:
                continue
            ok &= np.array([lab.get(key) == val for lab in self.labels])
        return ok

    def pool_ok(self, selector: Dict[str, str], tolerations) -> np.ndarray:
        """[pools]: the pools whose taints the pod tolerates and whose own
        label it admits."""
        want = selector.get(I.LABEL_NODEPOOL)
        return np.array([tolerates(tolerations, [tuple(t) for t in p.get("taints", ())])
                         and (want is None or want == p["name"]) for p in self.pools])

    def row(self, selector: Dict[str, str], tolerations) -> np.ndarray:
        """[C]: the configurations a pod of this shape may open."""
        key = (tuple(sorted(selector.items())), tuple(tolerations))
        r = self._rows.get(key)
        if r is None:
            r = self._rows[key] = (self.pool_ok(selector, tolerations)[self.cfg_pool]
                                   & self.type_ok(selector)[self.cfg_type])
        return r


# ---------------------------------------------------------------------------
# classes and the pack
# ---------------------------------------------------------------------------


def pod_class_key(p: dict) -> tuple:
    return (tuple(sorted(p["selector"].items())), tuple(p["tolerations"]), p["cpu"], p["memory"])


def ffd_classes(pods: Sequence[dict]) -> List[List[dict]]:
    """Pods grouped by shape in first-occurrence order, then sorted by
    descending size (cpu + memory / 4 GiB); ties keep that order."""
    groups: Dict[tuple, List[dict]] = {}
    for p in pods:
        groups.setdefault(pod_class_key(p), []).append(p)
    return sorted(groups.values(), key=lambda ms: -(ms[0]["cpu"] + ms[0]["memory"] / (4 * 2**30)))


class Live:
    """A cluster's live nodes as the reference reads them: their names,
    float32 allocatable and usage, and label columns made on first use."""

    def __init__(self, cat: Catalog, nodes: Sequence[dict]):
        self.cat, self.nodes = cat, list(nodes)
        E = len(self.nodes)
        self.types = np.array([cat.type_of[n["type"]] for n in self.nodes], np.int64)
        self.alloc = cat.alloc32_t[self.types].reshape(E, 3)
        self.used0 = (np.stack([scaled32(node_used(n)) for n in self.nodes]) if E
                      else np.zeros((0, 3), F32))
        self._labels = None
        self._columns: Dict[str, np.ndarray] = {}

    def column(self, key: str) -> np.ndarray:
        col = self._columns.get(key)
        if col is None:
            if self._labels is None:
                self._labels = [node_labels(n, self.cat.shapes[t])
                                for n, t in zip(self.nodes, self.types)]
            col = self._columns[key] = np.array([lab.get(key) for lab in self._labels], dtype=object)
        return col

    def without(self, removed: Sequence[int]) -> "Live":
        keep = np.ones(len(self.nodes), bool)
        keep[list(removed)] = False
        out = Live.__new__(Live)
        out.cat, out.nodes = self.cat, [n for n, k in zip(self.nodes, keep) if k]
        out.types, out.alloc, out.used0 = self.types[keep], self.alloc[keep], self.used0[keep]
        out._labels = None
        out._columns = {k: v[keep] for k, v in self._columns.items()}
        if self._labels is not None:
            out._labels = [lab for lab, k in zip(self._labels, keep) if k]
        return out


def node_used(node: dict) -> Tuple[float, float, float]:
    """A live node's usage: its bound pods' requests summed in order."""
    cpu = mem = npods = 0.0
    for p in node["pods"]:
        cpu, mem, npods = cpu + p["cpu"], mem + p["memory"], npods + 1.0
    return cpu, mem, npods


class Problem:
    """One solve's inputs as the reference derives them: classes over
    configurations (catalog first, then one column a live node)."""

    def __init__(self, cat: Catalog, pods: Sequence[dict], live):
        if not isinstance(live, Live):
            live = Live(cat, live)
        self.cat, self.nodes = cat, live.nodes
        self.classes = ffd_classes(pods)
        C, E = len(cat.price), len(live.nodes)
        self.C, self.E = C, E
        self.req64 = np.array([[m[0]["cpu"], m[0]["memory"], 1.0] for m in self.classes]).reshape(-1, 3)
        self.req = np.stack([scaled32(r) for r in self.req64]) if len(self.classes) else np.zeros((0, 3), F32)
        self.cnt = np.array([len(m) for m in self.classes], np.int64)
        self.alloc = np.concatenate([cat.alloc32, live.alloc])
        self.openable = np.concatenate([np.ones(C, bool), np.zeros(E, bool)])
        self.price32 = np.concatenate([cat.price32, np.zeros(E, F32)])
        self.used0 = live.used0
        self.feas = np.zeros((len(self.classes), C + E), bool)
        for g, members in enumerate(self.classes):
            rep = members[0]
            self.feas[g, :C] = cat.row(rep["selector"], rep["tolerations"])
            ok = np.full(E, tolerates(rep["tolerations"], ()))
            for k, v in rep["selector"].items():
                ok &= live.column(k) == v
            self.feas[g, C:] = ok


class Pack:
    """The pack's outputs: each class's takes as (slots, counts), each
    slot's configuration and final usage."""

    def __init__(self, takes, cfg, used):
        self.takes, self.cfg, self.used = takes, cfg, used


def choose_configs(prob: Problem) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each class's new-node configuration among the openable ones: the
    most pods a node, the price (over the largest openable price + 1) as
    the tie-break, the first index of the best score."""
    C = prob.C
    price = prob.price32[:C]
    ceil = F32(price.max() + F32(1.0))
    norm = price / ceil
    G = len(prob.classes)
    c_star = np.zeros(G, np.int64)
    new_ok = np.zeros(G, bool)
    per = np.ones(G, np.int64)
    alloc = prob.alloc[:C]
    for g in range(G):
        cap = per_node_cap(alloc, prob.req[g][None, :])
        ok = prob.feas[g, :C] & (cap > 0)
        score = np.where(ok, -cap.astype(F32) + norm, F32(np.inf))
        c = int(np.argmin(score))
        c_star[g], new_ok[g], per[g] = c, bool(ok[c]), max(int(cap[c]), 1)
    return c_star, new_ok, per


def pack(prob: Problem) -> Pack:
    """First fit over the open slots (live nodes first), then the class's
    remaining pods on new slots of its chosen configuration, ``per`` a
    slot; usage updated by a fused multiply-add."""
    c_star, new_ok, per = choose_configs(prob)
    E, C = prob.E, prob.C
    need = sum(-(-int(n) // int(p)) for n, p, ok in zip(prob.cnt, per, new_ok) if ok)
    K = E + need
    used = np.zeros((K, 3), F32)
    used[:E] = prob.used0
    cfg = np.full(K, -1, np.int64)
    cfg[:E] = C + np.arange(E)
    alloc = prob.alloc
    nxt = E
    takes = []
    for g in range(len(prob.classes)):
        req, n = prob.req[g], int(prob.cnt[g])
        c = cfg[:nxt]
        cap = per_node_cap(alloc[c] - used[:nxt], req[None, :])
        cap = np.where(prob.feas[g, c], cap, 0)
        prefix = np.cumsum(cap) - cap
        take = np.minimum(np.maximum(n - prefix, 0), cap)
        n2 = n - int(take.sum())
        slots = [np.flatnonzero(take)]
        counts = [take[slots[0]]]
        if new_ok[g] and n2 > 0:
            opened = -(-n2 // int(per[g]))
            idx = np.arange(opened)
            t2 = np.minimum(np.maximum(n2 - idx * per[g], 0), per[g])
            cfg[nxt:nxt + opened] = c_star[g]
            slots.append(nxt + idx)
            counts.append(t2)
            n2 -= int(t2.sum())
            nxt += opened
        s, t = np.concatenate(slots), np.concatenate(counts)
        if len(s):
            used[s] = fma32(t[:, None].astype(F32), req[None, :], used[s])
        takes.append((s, t))
    return Pack(takes, cfg[:nxt], used[:nxt])


# ---------------------------------------------------------------------------
# decode: new nodes, their launch-flexible types, compaction
# ---------------------------------------------------------------------------


class NewNode:
    __slots__ = ("slot", "cfg", "pool", "zone", "ct", "pods", "classes", "used", "reqs",
                 "types", "hint", "hi", "key_current", "pending")

    def __init__(self, slot: int, cfg: int, cat: Catalog):
        self.slot, self.cfg = slot, cfg
        self.pool = int(cat.cfg_pool[cfg])
        self.zone, self.ct = int(cat.cfg_zone[cfg]), int(cat.cfg_ct[cfg])
        self.pods: List[dict] = []
        self.classes: List[int] = []
        self.used = [0.0, 0.0, 0.0]  # raw, float64, as the decode sums it
        self.reqs: Dict[str, str] = {}  # selector keys merged by compaction
        self.types: Optional[List[int]] = None  # widened lazily, as the decode does
        self.hint = None  # the decode's headroom bound, made at the first probe
        self.hi = None
        self.key_current = False
        self.pending = True  # the widening not yet made


class Decoded:
    def __init__(self):
        self.new_nodes: List[NewNode] = []
        self.existing: Dict[str, str] = {}
        self.unschedulable: List[str] = []


def widen(prob: Problem, pk: Pack, vn: NewNode) -> List[int]:
    """The committed type first, then every other type of the same pool,
    zone and capacity type that each class on the node admits and whose
    allocatable holds the node's usage, by price."""
    cat = prob.cat
    C = prob.C
    feas = prob.feas[vn.classes, :C].all(axis=0) if vn.classes else np.ones(C, bool)
    fits = (pk.used[vn.slot][None, :] <= cat.alloc32 + SLACK32).all(axis=1)
    same = (cat.cfg_pool == vn.pool) & (cat.cfg_zone == vn.zone) & (cat.cfg_ct == vn.ct)
    committed = int(cat.cfg_type[vn.cfg])
    seen, alts = {committed}, []
    for c in np.flatnonzero(feas & fits & same):
        t = int(cat.cfg_type[c])
        if t not in seen:
            seen.add(t)
            alts.append((cat.price[c], t))
    alts.sort(key=lambda pair: pair[0])
    return [committed] + [t for _, t in alts]


def headroom_hint(prob: Problem, vn: NewNode) -> np.ndarray:
    """The decode's upper bound on any type's allocatable for this node:
    the largest float32 allocatable over the openable configurations every
    class on it admits, back in raw units."""
    feas = prob.feas[vn.classes, :prob.C].all(axis=0)
    return prob.cat.alloc32[feas].max(axis=0).astype(np.float64) * SCALE


def try_add(prob: Problem, pk: Pack, vn: NewNode, pod: dict, pod_type_ok: np.ndarray) -> bool:
    """A plain pod onto a decoded new node: the pool's taints tolerated,
    the node's headroom bound, the merged selector satisfiable, and some
    of the node's types admitting it and holding its usage plus the pod.
    On success the node's types narrow to those that do."""
    cat = prob.cat
    if not tolerates(pod["tolerations"], [tuple(t) for t in cat.pools[vn.pool].get("taints", ())]):
        return False
    req = (pod["cpu"], pod["memory"], 1.0)
    if vn.pending:
        if vn.hint is None:
            vn.hint = headroom_hint(prob, vn)
        hi = vn.hint
    else:
        if not vn.key_current:
            vn.hi = cat.alloc64[vn.types].max(axis=0)
            vn.key_current = True
        hi = vn.hi
    if any(r + u > h + SLACK64 for r, u, h in zip(req, vn.used, hi)):
        return False
    want = pod["selector"].get(I.LABEL_NODEPOOL)
    if want is not None and want != cat.pools[vn.pool]["name"]:
        return False
    merged = dict(vn.reqs)
    for k, v in pod["selector"].items():
        if k == I.LABEL_NODEPOOL:
            continue
        if merged.get(k, v) != v:
            return False
        merged[k] = v
    if vn.pending:
        vn.types = widen(prob, pk, vn)
        vn.pending = False
        vn.hi = vn.hint
        vn.key_current = False
    new_used = [u + r for u, r in zip(vn.used, req)]
    types = np.array(vn.types)
    ok = cat.type_ok(merged)[types] & (np.array(new_used)[None, :]
                                       <= cat.alloc64[types] + SLACK64).all(axis=1)
    if not ok.any():
        return False
    vn.reqs = merged
    vn.types = [t for t, k in zip(vn.types, ok) if k]
    vn.key_current = True
    vn.used = new_used
    vn.pods.append(pod)
    return True


def compact(prob: Problem, pk: Pack, dec: Decoded) -> None:
    """Re-home the pods of new nodes holding at most eight, fewest first,
    onto the other new nodes, fullest first; nodes left empty go."""
    nodes = dec.new_nodes
    donors = sorted((vn for vn in nodes if len(vn.pods) <= COMPACT_MAX_PODS),
                    key=lambda vn: len(vn.pods))
    if not donors:
        return
    donor_ids = {id(d) for d in donors}
    for vn in donors:
        targets = ([o for o in nodes if o is not vn and id(o) not in donor_ids]
                   + [o for o in donors if o is not vn and o.pods])
        remaining = []
        for p in vn.pods:
            ok_t = prob.cat.type_ok({k: v for k, v in p["selector"].items()})
            if not any(try_add(prob, pk, o, p, ok_t)
                       for o in sorted(targets, key=lambda o: -len(o.pods))):
                remaining.append(p)
        if remaining and len(remaining) != len(vn.pods):
            used = [0.0, 0.0, 0.0]
            for p in remaining:
                used = [u + r for u, r in zip(used, (p["cpu"], p["memory"], 1.0))]
            vn.used = used
        vn.pods = remaining
    dec.new_nodes = [vn for vn in nodes if vn.pods]


def decode(prob: Problem, pk: Pack, compaction: bool = True) -> Decoded:
    """Class members in order fill the slots in ascending order; live slots
    are existing placements, the others new nodes in order of first use."""
    dec = Decoded()
    by_slot: Dict[int, NewNode] = {}
    for g, members in enumerate(prob.classes):
        cursor = 0
        r = prob.req64[g]
        for k, n in zip(*pk.takes[g]):
            k, n = int(k), int(n)
            batch = members[cursor:cursor + n]
            cursor += n
            if k < prob.E:
                for p in batch:
                    dec.existing[p["name"]] = prob.nodes[k]["name"]
                continue
            vn = by_slot.get(k)
            if vn is None:
                vn = by_slot[k] = NewNode(k, int(pk.cfg[k]), prob.cat)
                dec.new_nodes.append(vn)
            vn.pods.extend(batch)
            vn.used = [u + v * len(batch) for u, v in zip(vn.used, r)]
            vn.classes.append(g)
        dec.unschedulable.extend(p["name"] for p in members[cursor:])
    if compaction:
        compact(prob, pk, dec)
    return dec


def canonical(prob: Problem, pk: Pack, dec: Decoded) -> tuple:
    """The decoded result as plain data: each new node's pool, types, zone,
    capacity type and pod names; the existing placements; the
    unschedulable pods."""
    cat = prob.cat
    nodes = []
    for vn in dec.new_nodes:
        if vn.pending:
            vn.types = widen(prob, pk, vn)
        nodes.append((cat.pools[vn.pool]["name"], tuple(cat.shapes[t]["name"] for t in vn.types),
                      (cat.zones[vn.zone],), ("on-demand", "spot")[vn.ct],
                      tuple(sorted(p["name"] for p in vn.pods))))
    return (sorted(nodes), sorted(dec.existing.items()), sorted(dec.unschedulable))


def solve(cat: Catalog, pods: Sequence[dict], live) -> Tuple[tuple, Problem, Pack]:
    """One provisioning solve: ``(canonical result, problem, pack)``."""
    prob = Problem(cat, pods, live)
    pk = pack(prob)
    return canonical(prob, pk, decode(prob, pk)), prob, pk


# ---------------------------------------------------------------------------
# the removal what-if and the fast path's pick
# ---------------------------------------------------------------------------


def whatif(cat: Catalog, live, removed: Sequence[int],
           without_rest: bool = False) -> Tuple[bool, float, int]:
    """Remove ``removed`` (node indices, in the universe's order) and solve
    their pods onto the rest.  Returns ``(fits, price, new)``: fits when no
    pod is left over and at most one new node remains after compaction, at
    that node's cheapest type in its zone and capacity type (0 with none);
    ``new`` counts the new nodes the pack opened, before compaction.
    ``without_rest`` solves the pods onto new nodes alone (the control: the
    rest of the cluster's room left unused)."""
    if not isinstance(live, Live):
        live = Live(cat, live)
    pods = [p for i in removed for p in live.nodes[i]["pods"]]
    if not pods:
        return True, 0.0, 0
    prob = Problem(cat, pods, Live(cat, []) if without_rest else live.without(removed))
    pk = pack(prob)
    opened = len(pk.cfg) - prob.E
    dec = decode(prob, pk)
    if dec.unschedulable or len(dec.new_nodes) > 1:
        return False, 0.0, opened
    if not dec.new_nodes:
        return True, 0.0, opened
    vn = dec.new_nodes[0]
    if vn.pending:
        vn.types = widen(prob, pk, vn)
    sel = ((cat.cfg_pool == vn.pool) & (cat.cfg_zone == vn.zone) & (cat.cfg_ct == vn.ct)
           & np.isin(cat.cfg_type, vn.types))
    return True, min(cat.price[c] for c in np.flatnonzero(sel)), opened


def admit(cat: Catalog, pod: dict, live) -> Tuple[str, str]:
    """The fast path's decision for one pod: ``("nominated", node)`` for
    the first live node that admits it and holds it, else ``("fallback",
    "needs_new_node")`` where some configuration could, else ``("fallback",
    "unschedulable")``."""
    prob = Problem(cat, [pod], live)
    req = prob.req[0]
    if prob.E:
        cap = per_node_cap(prob.alloc[prob.C:] - prob.used0, req[None, :])
        ok = np.flatnonzero((cap > 0) & prob.feas[0, prob.C:])
        if len(ok):
            return "nominated", prob.nodes[int(ok[0])]["name"]
    cap_open = per_node_cap(prob.alloc[:prob.C], req[None, :])
    if (prob.feas[0, :prob.C] & (cap_open > 0)).any():
        return "fallback", "needs_new_node"
    return "fallback", "unschedulable"


def without_memory(pods: Sequence[dict]) -> List[dict]:
    """The control's inputs: the same pods with no memory request."""
    return [dict(p, memory=0.0) for p in pods]


def nodes_without_memory(nodes: Sequence[dict]) -> List[dict]:
    return [dict(n, pods=without_memory(n["pods"])) for n in nodes]
