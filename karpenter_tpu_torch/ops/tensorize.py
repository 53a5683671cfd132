"""Constraint compilation: pods x pools x instance-types -> dense tensors.

This is the front-end of the tensor scheduling solver (port copy of
``karpenter_tpu/ops/tensorize.py``, numpy only).  The reference computes
feasibility pod-by-pod inside the FFD loop (karpenter-core bin-packing,
reference designs/bin-packing.md:18-42, with the instance-type pre-filter at
pkg/cloudprovider/cloudprovider.go:296-307).  We instead *compile* the
problem once per solve:

- **Pod classes** (axis G): pods grouped by (constraint signature, resource
  vector).  Pods in a class are interchangeable, so the packer places whole
  classes at once — the key to sub-200ms solves at 10k pods.
- **Node configs** (axis C): every launchable (pool, instance-type, zone,
  capacity-type) combination with an available offering, plus one row per
  existing node.  Each row carries an allocatable-resource vector (minus the
  pool's daemonset overhead) and a price.
- **Feasibility** `feas[G, C]`: computed EXACTLY with the Requirements
  algebra (api/requirements.py) — pool taints vs tolerations, the merged
  (pool ∧ pod) requirement conjunction vs the type's catalog labels, zone
  and capacity-type admission, offering availability (ICE cache already
  masked upstream by the instance-type provider).

The launchable half of the config axis is identical across solves for a
given (pools, instance-types) snapshot, so it is prebuilt once as a
`Catalog` and reused — the analogue of the reference's seqnum-keyed
instance-type cache (instancetype.go:97-104).

The resulting `CompiledProblem` is pure numpy; `ops/packer.py` moves it to
device and runs the packing scan under jit.

Constraint coverage: the tensor path handles resource requests, node
selectors/affinity (first OR-term; preferences compiled as required),
volume-derived zone requirements, taints/tolerations, zonal offerings,
capacity types, hostname anti-affinity — self-selecting AND mutual
cross-class (shared `_track_key` counter slots), hostname co-location —
self-selecting AND cross-class closures (macro units; node-INEQUIVALENT
members compile via ANDed feasibility rows — the group's feasible set is
the intersection of its members'), hostname topology spread (max
`maxSkew` per node while any empty node exists — exact in the scale-out
regime), zone topology spread — incl. mutual cross-class, split across
allowed zones against the shared per-group accumulator — and zone-keyed
pod affinity (compile-time domain anchoring).  Anything else — one-sided
cross-class couplings, zone-affinity+spread combos, exotic topology
keys, live-member co-location, closures whose members differ in
OR-terms or namespace — is reported via ``unsupported_reason`` and
routed to the pure-Python oracle (scheduling/scheduler.py), whole or as
the hybrid continuation of a split batch.  (Closures whose members
differ only in PREFERENCES compile: each member's preferences merge as
required into its own ANDed feasibility row, and the compile-time
relaxation ladder peels them when the strict intersection is empty —
see _coloc_component_mergeable.)

Routing-spec guard: tests/test_router_spec.py greps this docstring's
oracle-shape list against the router's actual behavior
(class_unsupported_reason / _coloc_component_mergeable / the cure
functions) — edit both together.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import (
    InstanceType,
    NodePool,
    Pod,
    Requirement,
    Requirements,
    Resources,
)
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.objects import selector_matches, tolerates_all
from karpenter_tpu_torch.api.requirements import Op
from karpenter_tpu_torch.state.cluster import StateNode

# Resource canonical axes.  Byte-denominated axes are scaled to MiB so every
# quantity fits comfortably in float32 (f32 has a 24-bit mantissa; bytes
# counts overflow its integer range, MiB counts do not).
_MIB = 2.0**20
_SCALE = {L.RESOURCE_MEMORY: _MIB, L.RESOURCE_EPHEMERAL_STORAGE: _MIB}

BIG = 2**30  # "unbounded" per-node pod cap


def _axes_for(pods: Sequence[Pod]) -> Tuple[str, ...]:
    return _axes_for_requests([p.requests for p in pods])


def _axes_for_requests(requests_list: Sequence[Resources]) -> Tuple[str, ...]:
    """Resource axes for a solve, derived from per-GROUP request vectors.

    Pass each group's key requests (the SUMMED vector for merged
    co-location closures) rather than a representative pod's — a non-rep
    member may carry an extended resource the rep doesn't, and an axis
    missing here would silently go uncapacitated."""
    extra = sorted(
        {k for r in requests_list for k in r.keys()}
        - set(L.WELL_KNOWN_RESOURCES)
    )
    return tuple(L.WELL_KNOWN_RESOURCES) + tuple(extra)


def _vec(r: Resources, axes: Sequence[str]) -> np.ndarray:
    return np.array(
        [r.get(a) / _SCALE.get(a, 1.0) for a in axes], dtype=np.float32
    )


# ---------------------------------------------------------------------------
# Catalog: the launchable config axis, reusable across solves
# ---------------------------------------------------------------------------


@dataclass
class ConfigMeta:
    """Host-side description of one node-config row (C axis)."""

    pool: Optional[NodePool]
    instance_type: Optional[InstanceType]
    zone: str
    capacity_type: str
    price: float
    existing: Optional[StateNode] = None  # set for existing-node rows


@dataclass
class _PoolRows:
    """Per-pool config structure for vectorized feasibility assembly."""

    rows: np.ndarray  # [n] int32 — config row indices
    uniq_types: List[InstanceType]
    t_of: np.ndarray  # [n] int32 — row -> uniq_types index
    z_of: np.ndarray  # [n] int32
    ct_of: np.ndarray  # [n] int32
    zones: List[str]
    capacity_types: List[str]


@dataclass
class Catalog:
    """Prebuilt launchable config rows + tensors for one inventory snapshot."""

    axes: Tuple[str, ...]
    pools: List[NodePool]  # live, weight-sorted
    configs: List[ConfigMeta]
    alloc: np.ndarray  # [Cn, R] float32 (minus pool daemonset overhead)
    price: np.ndarray  # [Cn] float32
    pool_rank_of: np.ndarray  # [Cn] int32 — weight-order rank of each row
    pool_rows: Dict[str, _PoolRows]
    pool_overhead: Dict[str, Resources]
    zones: List[str]
    # (constraint-signature, pool) -> (type_ok, zone_ok, ct_ok) bool vectors
    # (None when the pod can't merge with the pool at all).  The exact
    # Requirements-algebra checks are the host-side compile's dominant cost
    # at many-class batches; they depend only on the signature and this
    # catalog snapshot, so they memoize for the catalog's lifetime.
    feas_memo: Dict = field(default_factory=dict)


_MEMO_MISS = object()


def _pool_feas(
    catalog: "Catalog",
    rep: Pod,
    sig: Tuple,
    pname: str,
    pools_by_name: Dict[str, NodePool],
    term: int = 0,
    keep_prefs: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Memoized per-(signature, pool) compatibility vectors over the pool's
    unique types / zones / capacity types.  Zone PINS are intentionally not
    part of the key: config rows exist only for a type's actual offerings,
    so pinning composes exactly as a per-row zone filter on top of these.
    ``(term, keep_prefs)`` select a relaxation step of the ladder
    (compile-time peel, see compile_problem) — the default strict shape
    keeps the compact two-part key."""
    memo = catalog.feas_memo
    key = (
        (sig, pname)
        if term == 0 and keep_prefs is None
        else (sig, pname, term, keep_prefs)
    )
    ent = memo.get(key, _MEMO_MISS)
    if ent is _MEMO_MISS:
        pr = catalog.pool_rows[pname]
        merged = _merge_pool(
            rep,
            rep.scheduling_requirements(
                preferred=True, term=term, keep_prefs=keep_prefs
            ),
            pools_by_name[pname],
        )
        if merged is None:
            ent = None
        else:
            type_ok = np.fromiter(
                (
                    it.requirements.compatible(merged, allow_undefined=True)
                    for it in pr.uniq_types
                ),
                bool,
                len(pr.uniq_types),
            )
            zr = merged.get(L.LABEL_ZONE)
            zone_ok = np.fromiter(
                (zr is None or zr.has(z) for z in pr.zones), bool, len(pr.zones)
            )
            cr = merged.get(L.LABEL_CAPACITY_TYPE)
            ct_ok = np.fromiter(
                (cr is None or cr.has(ct) for ct in pr.capacity_types),
                bool,
                len(pr.capacity_types),
            )
            ent = (type_ok, zone_ok, ct_ok)
        if len(memo) > 50_000:
            memo.clear()  # unbounded-workload backstop
        memo[key] = ent
    return ent


def build_catalog(
    pools: Sequence[NodePool],
    instance_types: Dict[str, List[InstanceType]],
    daemonsets: Sequence[Pod] = (),
    axes: Tuple[str, ...] = tuple(L.WELL_KNOWN_RESOURCES),
) -> Catalog:
    pools = sorted((p for p in pools if not p.deleted), key=lambda p: -p.weight)
    configs: List[ConfigMeta] = []
    pool_overhead: Dict[str, Resources] = {}
    pool_rank: List[int] = []
    for rank, pool in enumerate(pools):
        treqs = pool.template_requirements()
        pool_overhead[pool.name] = _daemon_overhead(pool, treqs, daemonsets)
        for it in instance_types.get(pool.name, []):
            for off in it.offerings.available():
                configs.append(
                    ConfigMeta(
                        pool=pool,
                        instance_type=it,
                        zone=off.zone,
                        capacity_type=off.capacity_type,
                        price=off.price,
                    )
                )
                pool_rank.append(rank)

    alloc_rows = []
    for cfg in configs:
        alloc = (
            cfg.instance_type.allocatable() - pool_overhead[cfg.pool.name]
        ).clamp_nonnegative()
        alloc_rows.append(_vec(alloc, axes))
    alloc_mat = (
        np.stack(alloc_rows) if alloc_rows else np.zeros((0, len(axes)), np.float32)
    )

    pool_rows: Dict[str, _PoolRows] = {}
    rows_by_pool: Dict[str, List[int]] = {}
    for c, cfg in enumerate(configs):
        rows_by_pool.setdefault(cfg.pool.name, []).append(c)
    for pname, rows in rows_by_pool.items():
        uniq_types: List[InstanceType] = []
        tindex: Dict[str, int] = {}
        zones_u: List[str] = []
        zindex: Dict[str, int] = {}
        cts_u: List[str] = []
        ctindex: Dict[str, int] = {}
        t_of = np.empty(len(rows), np.int32)
        z_of = np.empty(len(rows), np.int32)
        ct_of = np.empty(len(rows), np.int32)
        for i, c in enumerate(rows):
            cfg = configs[c]
            if cfg.instance_type.name not in tindex:
                tindex[cfg.instance_type.name] = len(uniq_types)
                uniq_types.append(cfg.instance_type)
            if cfg.zone not in zindex:
                zindex[cfg.zone] = len(zones_u)
                zones_u.append(cfg.zone)
            if cfg.capacity_type not in ctindex:
                ctindex[cfg.capacity_type] = len(cts_u)
                cts_u.append(cfg.capacity_type)
            t_of[i] = tindex[cfg.instance_type.name]
            z_of[i] = zindex[cfg.zone]
            ct_of[i] = ctindex[cfg.capacity_type]
        pool_rows[pname] = _PoolRows(
            rows=np.array(rows, np.int32),
            uniq_types=uniq_types,
            t_of=t_of,
            z_of=z_of,
            ct_of=ct_of,
            zones=zones_u,
            capacity_types=cts_u,
        )

    return Catalog(
        axes=axes,
        pools=list(pools),
        configs=configs,
        alloc=alloc_mat,
        price=np.array([c.price for c in configs], dtype=np.float32),
        pool_rank_of=np.array(pool_rank, dtype=np.int32),
        pool_rows=pool_rows,
        pool_overhead=pool_overhead,
        zones=sorted({c.zone for c in configs}),
    )


# ---------------------------------------------------------------------------
# Compiled problem
# ---------------------------------------------------------------------------


@dataclass
class ClassMeta:
    """Host-side description of one pod class (G axis)."""

    pods: List[Pod]
    requests: Resources
    signature: Tuple
    zone_pin: str = ""  # non-empty when zone-split / affinity-anchored
    max_per_node: int = BIG
    track_slot: int = 0  # sig-count slot for anti-affinity/hostname-spread
    infeasible: bool = False  # compile-time-proven unschedulable
    unsched_reason: str = ""  # decode reason when infeasible
    # hostname co-location macro: when > 0 the class is ONE placement unit
    # covering all `pods` (requests is their SUM); a take of 1 assigns the
    # whole group to that node, a leftover of 1 leaves the whole group
    # unschedulable (real-scheduler bind semantics: once the first member
    # binds, required hostname affinity forces every member to that node)
    group_size: int = 0
    # custom-topology-key split: a representative CLONE whose node
    # selector pins the class to its domain — feasibility rows compile
    # from this pod instead of pods[0] (the members keep their real spec)
    rep_override: Optional[Pod] = None
    # ...and the domain's pools: only pools DEFINING the key are valid
    # domains (the oracle's rule), which the requirement merge alone
    # cannot express because undefined keys pass at the pool level
    pool_allow: Optional[frozenset] = None


@dataclass
class CompiledProblem:
    axes: Tuple[str, ...]
    classes: List[ClassMeta]
    configs: List[ConfigMeta]
    # class tensors [G]
    req: np.ndarray  # [G, R] float32
    cnt: np.ndarray  # [G] int32
    maxper: np.ndarray  # [G] int32
    slot: np.ndarray  # [G] int32  (anti-affinity tracking slot)
    # config tensors [C]
    alloc: np.ndarray  # [C, R] float32 (minus pool daemonset overhead)
    price: np.ndarray  # [C] float32
    openable: np.ndarray  # [C] bool (False for existing-node rows)
    feas: np.ndarray  # [G, C] bool
    # per-pool daemonset overhead (already subtracted from alloc rows;
    # decode adds it back onto each new node's `used`)
    pool_daemon_overhead: Dict[str, Resources]
    # existing-node prefill
    used0: np.ndarray  # [E, R] float32
    cfg0: np.ndarray  # [E] int32 (config row index)
    npods0: np.ndarray  # [E] int32 — pods already bound per existing node
    sig_used0: np.ndarray  # [S, E] int32 — tracked-signature counts per node
    n_track_slots: int = 1
    unsupported_reason: str = ""
    # pods whose class was relaxed at COMPILE time (preference peel /
    # OR-term walk over globally-empty strict rows) — observability for
    # the solver's last_compile_relaxed and the bench's relax line
    compile_relaxed: int = 0

    @property
    def supported(self) -> bool:
        return not self.unsupported_reason

    def total_pods(self) -> int:
        return int(self.cnt.sum())


# ---------------------------------------------------------------------------
# Support detection + batch partitioning
# ---------------------------------------------------------------------------


def class_unsupported_reason(rep: Pod) -> str:
    """Constraint shapes of a single class the tensor kernel cannot express.

    Supported coupled shapes (compiled to masks/pins/splits):
    - zone-keyed REQUIRED pod affinity -> compile-time domain anchoring
      (the whole affinity component pins to one zone)
    - self-selecting zone-keyed anti-affinity -> per-zone singleton split
    - self-selecting hostname anti-affinity -> max-1-per-node cap
    - self-selecting hostname AFFINITY (same-node co-location) -> one
      macro placement unit carrying the whole group's summed requests
    - hostname/zone topology spread -> per-node caps / zone shares

    Cross-class shapes are cured at partition level when they are MUTUAL:
    node-equivalent co-location closures merge into one macro unit
    (_coloc_component_mergeable), identical-fingerprint hostname
    anti-affinity shares a counter slot (_track_key), and identical
    mutual zone spreads split against the shared group accumulator.
    Everything else (one-sided couplings; exotic topology keys) goes to
    the oracle half of a hybrid solve (scheduling/solver.py).
    """
    has_zone_aff = False
    has_zone_anti = False
    has_host_aff = False
    for t in rep.pod_affinity:
        if not t.anti:
            if t.topology_key == L.LABEL_HOSTNAME:
                if not t.selects(rep):
                    return "hostname affinity selector not matching own pods"
                has_host_aff = True
                continue
            if t.topology_key != L.LABEL_ZONE:
                return f"pod affinity on topology key {t.topology_key}"
            has_zone_aff = True
        elif t.topology_key == L.LABEL_HOSTNAME:
            if not t.selects(rep):
                return "hostname anti-affinity selector reaching other pods"
        elif t.topology_key == L.LABEL_ZONE:
            if not t.selects(rep):
                return "zone anti-affinity selector reaching other pods"
            has_zone_anti = True
        else:
            return f"anti-affinity on topology key {t.topology_key}"
    zone_spread = any(
        c.topology_key == L.LABEL_ZONE
        and c.selects(rep)
                for c in rep.topology_spread
    )
    if has_zone_aff and (zone_spread or has_zone_anti):
        return "zone affinity combined with another zone constraint"
    if has_zone_anti and zone_spread:
        return "zone anti-affinity combined with zone spread"
    if has_host_aff and (
        has_zone_aff
        or has_zone_anti
        or zone_spread
        or rep.topology_spread
        or any(t.anti for t in rep.pod_affinity)
    ):
        # the macro unit is a single opaque placement; combining it with
        # per-pod zone/spread/anti accounting needs the oracle
        return "hostname co-location combined with another constraint"
    for c in rep.topology_spread:
        if c.topology_key not in (L.LABEL_HOSTNAME, L.LABEL_ZONE):
            # provisional: partition_groups cures the single-constraint
            # self-selecting shape when the caller's pools give the key a
            # well-defined domain partition (_custom_spread_curable)
            return f"topology spread on key {c.topology_key}"
    return ""


def _custom_spread_curable(rep: Pod, pools: Sequence[NodePool]) -> str:
    """Domain partition for a CUSTOM-topology-key spread, or "" when the
    shape must keep the oracle.

    Compilable when the rep's only pod-level constraint is ONE
    self-selecting spread on the key, and every pool defining the key is
    SINGLE-VALUED for it (domains partition the pools, so each split
    class's pinned feasibility row maps to whole pools and two domains
    can never share a config row).  Returns the key when curable."""
    if not pools:
        return ""
    if rep.pod_affinity or len(rep.topology_spread) != 1:
        return ""
    c = rep.topology_spread[0]
    key = c.topology_key
    if key in (L.LABEL_HOSTNAME, L.LABEL_ZONE) or not c.selects(rep):
        return ""
    domains = set()
    for pool in pools:
        vr = pool.template_requirements().get(key)
        if vr is None:
            continue
        if vr.complement or len(vr.values) != 1:
            return ""  # multi-valued / negated template: oracle
        domains.update(vr.values)
    return key if domains else ""


def _pin_clone(rep: Pod, key: str, value: str) -> Pod:
    """Representative clone pinned to one domain via node selector; the
    reassignment invalidates the copied signature memo (Pod.__setattr__),
    so the clone groups and memoizes as its own shape."""
    import copy

    ov = copy.copy(rep)
    ov.node_selector = {**rep.node_selector, key: value}
    return ov


def _class_groups(pods: Sequence[Pod]) -> List[Tuple[Tuple, List[Pod]]]:
    groups: Dict[object, List[Pod]] = {}
    for p in pods:
        groups.setdefault(p.class_key(), []).append(p)
    return [(ck.key, members) for ck, members in groups.items()]


def _couples(a: Pod, b: Pod) -> bool:
    """Any selector of `a` (affinity term or spread constraint) selects `b`."""
    return any(t.selects(b) for t in a.pod_affinity) or any(
        c.selects(b) for c in a.topology_spread
    )


# cross-class hostname-co-location reasons that a node-equivalent closure
# merge cures (every other reason is structural and keeps the class oracle)
_HOST_CURABLE = frozenset(
    [
        "hostname affinity selector not matching own pods",
        "hostname co-location across multiple resource classes",
        "hostname co-location coupling distinct pod classes",
    ]
)


def _coloc_component_mergeable(
    comp: Sequence[int],
    sig_rep: Sequence[Pod],
    reasons: Sequence[str],
    live_labels: Sequence[dict],
    live_match=None,
) -> bool:
    """Whether a hostname-affinity coupled component compiles as ONE macro
    placement unit: every sig carries only hostname-affinity terms, every
    selector anchors inside the component, and no selector reaches pods
    already bound on live nodes (those groups must JOIN their node, which
    a macro can't express).

    Node-INEQUIVALENT closures (members differing in node selector,
    required node affinity, tolerations, volume requirements, or
    PREFERENCES) merge too: the whole group must land on ONE node, so
    the group's feasible config set is exactly the INTERSECTION of its
    members' sets — compile_problem ANDs the per-signature feasibility
    rows, with each member's preferences merged as required into its own
    row (and peeled per member by the compile-time relaxation ladder
    when the strict intersection is empty).  OR-terms and namespace must
    stay equal across members: the term walk is a single index into
    every member's term list, and selectors are namespace-scoped.  A
    closure that still proves unschedulable relaxes as a UNIT — the
    solver's relax pass pulls the whole closure to the oracle, whose
    gang machinery peels per member (solver.solve)."""
    cohesion_part = None
    for s in comp:
        if reasons[s] and reasons[s] not in _HOST_CURABLE:
            return False
        rep = sig_rep[s]
        if rep.topology_spread or not rep.pod_affinity:
            return False
        if any(
            t.anti or t.topology_key != L.LABEL_HOSTNAME
            for t in rep.pod_affinity
        ):
            return False
        sig = rep.constraint_signature()
        part = (sig[9], rep.namespace)
        if cohesion_part is None:
            cohesion_part = part
        elif part != cohesion_part:
            return False
    if live_match is None:
        live_match = lambda t: any(  # noqa: E731
            selector_matches(lbl, t.label_selector, t.match_expressions)
            for lbl in live_labels
        )
    for s in comp:
        for t in sig_rep[s].pod_affinity:
            if not any(t.selects(sig_rep[j]) for j in comp):
                return False
            if live_labels and live_match(t):
                return False
    return True


def partition_pods(
    pods: Sequence[Pod],
    pools: Sequence[NodePool] = (),
) -> Tuple[List[Pod], List[Pod], str]:
    """Split a batch into (tensor-solvable, oracle-only, reason); see
    `partition_groups` (which the solver uses directly so the class
    grouping is computed once per solve, not once here and again in
    `compile_problem`)."""
    sup_groups, unsupported, why = partition_groups(pods, pools=pools)
    supported = [p for _, members in sup_groups for p in members]
    return supported, unsupported, why


def partition_groups(
    pods: Sequence[Pod],
    existing: Sequence["StateNode"] = (),
    pools: Sequence[NodePool] = (),
) -> Tuple[List[Tuple[Tuple, List[Pod]]], List[Pod], str]:
    """Split a batch into (tensor-solvable class groups, oracle-only pods,
    reason).

    A class is oracle-only when its own constraint shape is unsupported,
    when an anti-affinity term couples it to a DIFFERENT class, or —
    transitively — when any selector couples it (either direction) to an
    oracle-only class.  The transitive closure guarantees the two halves
    share no constraint groups, so solving them sequentially (tensor first,
    oracle continuing on the tensor result) is sound: the only interaction
    left is capacity, which the oracle sees exactly.
    """
    group_list = _class_groups(pods)
    # every relation below (selector coupling, anti-affinity reach, the
    # unsupported-shape check) depends only on the constraint SIGNATURE
    # (labels + selectors + namespace), never on the request vector — so
    # the pairwise passes run over unique signatures, not classes.  Groups
    # sharing a signature are not "distinct classes" to the kernel: it
    # tracks them through one shared per-signature counter slot, so only
    # cross-SIG coupling needs the oracle.  Exception: zone anti-affinity's
    # per-zone singleton split is per (sig, requests) group, so a sig
    # spanning several request groups cannot share its <=1-per-zone cap.
    sig_index: Dict[Tuple, int] = {}
    sig_rep: List[Pod] = []
    sig_count: List[int] = []
    sig_of: List[int] = []
    for (sig, _), members in group_list:
        s = sig_index.get(sig)
        if s is None:
            s = sig_index[sig] = len(sig_rep)
            sig_rep.append(members[0])
            sig_count.append(0)
        sig_count[s] += 1
        sig_of.append(s)
    m = len(sig_rep)
    reasons = [class_unsupported_reason(r) for r in sig_rep]
    # cure custom-topology-key spreads the caller's pools can partition
    # (single-valued templates; see _custom_spread_curable).  Deleted
    # pools are filtered FIRST so this decision matches compile_problem,
    # whose catalog drops them (build_catalog).
    alive_pools = [p for p in pools if not p.deleted]
    if alive_pools:
        for i, r in enumerate(sig_rep):
            if reasons[i].startswith("topology spread on key") and \
                    _custom_spread_curable(r, alive_pools):
                reasons[i] = ""
    # built ONCE for the live-member checks below, with an inverted label
    # index so each selector scan is a set intersection over candidate
    # bound pods instead of an O(live pods) python loop — at 10k-pod /
    # hundreds-of-live-nodes batches the naive scan was a top-3 host cost
    live_labels = [dict(bp.labels) for sn in existing for bp in sn.pods]
    live_pair_index: Dict[Tuple[str, str], set] = {}
    for li, lbl in enumerate(live_labels):
        for kv in lbl.items():
            live_pair_index.setdefault(kv, set()).add(li)
    _live_match_memo: Dict[int, bool] = {}

    def live_matches(sel) -> bool:
        """Whether any live bound pod's labels satisfy `sel`."""
        got = _live_match_memo.get(id(sel))
        if got is not None:
            return got
        cand = None
        for kv in sel.label_selector:
            hit = live_pair_index.get(kv)
            if not hit:
                cand = ()
                break
            cand = set(hit) if cand is None else (cand & hit)
            if not cand:
                break
        if cand is None:  # no equality pairs to narrow on: scan everything
            cand = range(len(live_labels))
        got = any(
            selector_matches(
                live_labels[li], sel.label_selector, sel.match_expressions
            )
            for li in cand
        )
        _live_match_memo[id(sel)] = got
        return got
    # symmetric anti-affinity from LIVE carriers: a bound pod's anti term
    # repels incoming matching pods from its node — only the oracle's
    # per-node ban sets express that, so any selected class goes oracle
    live_anti = [
        t
        for sn in existing
        for bp in sn.pods
        for t in bp.pod_affinity
        if t.anti
    ]
    if live_anti:
        for i, r in enumerate(sig_rep):
            if any(t.selects(r) for t in live_anti):
                reasons[i] = reasons[i] or (
                    "repelled by a live pod's anti-affinity"
                )
    sel_idx = [
        i for i, r in enumerate(sig_rep) if r.pod_affinity or r.topology_spread
    ]

    # inverted label index: selector matching over unique signatures runs
    # as set intersections (a selector is a label conjunction) instead of
    # an O(sigs^2) python scan — the closure passes below all use it
    pair_index: Dict[Tuple[str, str], set] = {}
    for j, rep in enumerate(sig_rep):
        for kv in rep.labels.items():
            pair_index.setdefault(kv, set()).add(j)
    _no_sigs: set = set()
    _match_memo: Dict[int, frozenset] = {}

    def matches(sel) -> frozenset:
        """Sig indices whose pods `sel` selects (empty selector = all)."""
        got = _match_memo.get(id(sel))
        if got is not None:
            return got
        out = None
        for kv in sel.label_selector:
            hit = pair_index.get(kv)
            if not hit:
                out = _no_sigs
                break
            out = set(hit) if out is None else (out & hit)
            if not out:
                break
        # In-expressions narrow too (union of their value pairs); other
        # operators can't narrow and rely on the verify pass below
        if out is not _no_sigs:
            for expr in getattr(sel, "match_expressions", ()):
                if expr[1] != "In":
                    continue
                hit = set()
                for v in expr[2]:
                    hit |= pair_index.get((expr[0], v), _no_sigs)
                out = hit if out is None else (out & hit)
                if not out:
                    break
        if out is None:
            out = set(range(m))
        # full-selector verify: expressions and namespaces are exact here
        out = {j for j in out if sel.selects(sig_rep[j])}
        _match_memo[id(sel)] = got = frozenset(out)
        return got

    # union-find over hostname-affinity coupling: a connected component is
    # one CO-LOCATION CLOSURE; node-equivalent closures compile as a single
    # macro placement unit instead of falling to the oracle
    coloc_parent = list(range(m))

    def _find(x: int) -> int:
        while coloc_parent[x] != x:
            coloc_parent[x] = coloc_parent[coloc_parent[x]]
            x = coloc_parent[x]
        return x

    def _union(a: int, b: int) -> None:
        ra, rb = _find(a), _find(b)
        if ra != rb:
            coloc_parent[rb] = ra

    for i in sel_idx:
        rep = sig_rep[i]
        if sig_count[i] > 1 and any(
            t.anti and t.topology_key == L.LABEL_ZONE for t in rep.pod_affinity
        ):
            reasons[i] = reasons[i] or (
                "zone anti-affinity across multiple resource classes"
            )
        host_aff_terms = [
            t
            for t in rep.pod_affinity
            if not t.anti and t.topology_key == L.LABEL_HOSTNAME
        ]
        if host_aff_terms:
            # one (sig, requests) class per macro unless the closure merge
            # below proves the whole coupled component node-equivalent; a
            # selector reaching live members (the group must JOIN their
            # node, which the macro can't express) always needs the oracle
            if sig_count[i] > 1:
                reasons[i] = reasons[i] or (
                    "hostname co-location across multiple resource classes"
                )
            for t in host_aff_terms:
                for j in matches(t):
                    _union(i, j)
                    if j != i:
                        why = "hostname co-location coupling distinct pod classes"
                        reasons[i] = reasons[i] or why
                        reasons[j] = reasons[j] or why
            if live_labels and any(
                live_matches(t) for t in host_aff_terms
            ):
                reasons[i] = reasons[i] or (
                    "hostname co-location with members on live nodes"
                )
        for t in rep.pod_affinity:
            if not t.anti:
                continue
            # mutual cross-class HOSTNAME anti-affinity (variant labels
            # under one selector) compiles exactly: classes with identical
            # hostname fingerprints share one per-node counter slot
            # (compile_problem keys track_slots by _track_key), enforcing
            # <=1 of the union per node.  Anything asymmetric — the other
            # class missing the term, or carrying extra hostname
            # constraints — still needs the oracle.
            host_mutual = (
                t.topology_key == L.LABEL_HOSTNAME and t.selects(rep)
            )
            for j in matches(t):
                if j == i:
                    continue
                if (
                    host_mutual
                    and t in sig_rep[j].pod_affinity
                    and _track_key(sig_rep[j]) == _track_key(rep)
                ):
                    continue
                why = "anti-affinity coupling distinct pod classes"
                reasons[i] = reasons[i] or why
                reasons[j] = reasons[j] or why
        for c in rep.topology_spread:
            # zone-keyed DoNotSchedule spread across classes is exact on
            # the tensor path when the coupling is MUTUAL: every selected
            # class carries the identical constraint and self-selects, so
            # each splits itself against the shared per-group accumulator
            # (compile_problem's spread_assigned) and the summed shares
            # stay within maxSkew.  Anything one-sided (a class counted by
            # the group but not constrained by it, or vice versa) still
            # needs the oracle's runtime counts.
            zone_mutual = (
                c.topology_key == L.LABEL_ZONE
                                and c.selects(rep)
            )
            for j in matches(c):
                if j == i:
                    continue
                if (
                    zone_mutual
                    and c in sig_rep[j].topology_spread
                    # both classes must split over the SAME candidate
                    # zones, or the shared accumulator can't reconcile
                    # their shares
                    and sig_rep[j].scheduling_requirements(preferred=True).get(L.LABEL_ZONE)
                    == rep.scheduling_requirements(preferred=True).get(L.LABEL_ZONE)
                ):
                    continue
                # the spread group counts another class's pods; the
                # kernel's per-signature counters can't see them
                why = "topology spread coupling distinct pod classes"
                reasons[i] = reasons[i] or why
                reasons[j] = reasons[j] or why
        for t in rep.pod_affinity:
            if t.anti or t.topology_key != L.LABEL_ZONE:
                continue
            for j in matches(t):
                if j == i:
                    continue
                b = sig_rep[j]
                # anchoring pins the whole component to one zone, which is
                # only sound when the selected class has no zone-keyed
                # constraint of its own to honor (its own zone AFFINITY
                # merges into the same component and is fine)
                if any(
                    c.topology_key == L.LABEL_ZONE
                                        and c.selects(b)
                    for c in b.topology_spread
                ) or any(
                    tt.topology_key == L.LABEL_ZONE
                    and tt.anti
                    or tt.topology_key == L.LABEL_HOSTNAME
                    and not tt.anti
                    for tt in b.pod_affinity
                ):
                    why = "zone affinity coupling a zone-constrained class"
                    reasons[i] = reasons[i] or why
                    reasons[j] = reasons[j] or why

    # cure node-equivalent co-location closures: every sig in the component
    # differs only in pod labels / hostname-affinity selectors, so the whole
    # closure is ONE placement unit (summed requests) the kernel expresses
    # exactly — the cross-class reasons above were provisional
    comp_members: Dict[int, List[int]] = {}
    for j in range(m):
        comp_members.setdefault(_find(j), []).append(j)
    merge_root: Dict[int, int] = {}
    for root, comp in comp_members.items():
        if len(comp) == 1 and sig_count[comp[0]] == 1:
            continue  # the single-class macro path already handles it
        if not any(
            not t.anti and t.topology_key == L.LABEL_HOSTNAME
            for s in comp
            for t in sig_rep[s].pod_affinity
        ):
            continue
        if _coloc_component_mergeable(
            comp, sig_rep, reasons, live_labels, live_match=live_matches
        ):
            for s in comp:
                if reasons[s] in _HOST_CURABLE:
                    reasons[s] = ""
                merge_root[s] = root

    # transitive closure over selector coupling (either direction); a cured
    # component re-poisons WHOLE (its sigs stay mutually connected), so a
    # merge never splits across the tensor/oracle boundary
    edges: Dict[int, set] = {}
    for i in sel_idx:
        reach: set = set()
        for t in sig_rep[i].pod_affinity:
            reach |= matches(t)
        for c in sig_rep[i].topology_spread:
            reach |= matches(c)
        reach.discard(i)
        for j in reach:
            edges.setdefault(i, set()).add(j)
            edges.setdefault(j, set()).add(i)
    frontier = [i for i in range(m) if reasons[i]]
    while frontier:
        i = frontier.pop()
        for j in edges.get(i, ()):
            if not reasons[j]:
                reasons[j] = "coupled to an oracle-only pod class"
                frontier.append(j)
    sup_groups: List[Tuple[Tuple, List[Pod]]] = []
    unsupported: List[Pod] = []
    why = ""
    merged_members: Dict[int, List[Pod]] = {}
    for i, group in enumerate(group_list):
        s = sig_of[i]
        reason = reasons[s]
        if reason:
            unsupported.extend(group[1])
            why = why or reason
        elif s in merge_root:
            merged_members.setdefault(merge_root[s], []).extend(group[1])
        else:
            sup_groups.append(group)
    for members in merged_members.values():
        rep = members[0]
        total = Resources()
        for p in members:
            total = total + p.requests
        sup_groups.append(((rep.constraint_signature(), total), members))
    return sup_groups, unsupported, why


def _unsupported_reason(
    pods: Sequence[Pod],
    existing: Sequence["StateNode"] = (),
    pools: Sequence[NodePool] = (),
) -> str:
    """Whole-batch gate used by `compile_problem`: non-empty when ANY pod
    needs the oracle (callers that cannot hybrid-split fall back whole).
    `existing` matters: co-location groups with members already on live
    nodes must JOIN those nodes, which only the oracle expresses."""
    _, unsupported, why = partition_groups(pods, existing=existing, pools=pools)
    return why if unsupported else ""


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def _max_per_node(pod: Pod) -> int:
    """Per-node cap induced by hostname-keyed constraints.

    Self-selecting hostname anti-affinity = 1 pod per node (the 500-node
    scale config, reference test/suites/scale/provisioning_test.go:92-135).
    Hostname spread with maxSkew m allows at most m per node while any
    empty candidate node exists — exact during scale-out.
    """
    cap = BIG
    for t in pod.pod_affinity:
        if t.anti and t.topology_key == L.LABEL_HOSTNAME and t.selects(pod):
            cap = 1
    for c in pod.topology_spread:
        if (
            c.topology_key == L.LABEL_HOSTNAME
            and c.selects(pod)
                    ):
            cap = min(cap, c.max_skew)
    return cap


def _track_key(pod: Pod) -> Tuple:
    """Fingerprint of a class's hostname-keyed tracked constraints.

    Classes with EQUAL fingerprints share one per-node counter slot; the
    counter counts every placed pod of those classes, which matches the
    selector semantics because partition_groups only admits cross-class
    sharing when the classes mutually carry identical selectors.  A class
    with several terms gets one OR-counter — exact for anti-affinity
    (any match bans), conservative for hostname spread."""
    sels = {
        ("a", t.label_selector, t.match_expressions, t.namespaces)
        for t in pod.pod_affinity
        if t.anti and t.topology_key == L.LABEL_HOSTNAME
    } | {
        ("s", c.label_selector, c.match_expressions)
        for c in pod.topology_spread
        if c.topology_key == L.LABEL_HOSTNAME and c.selects(pod)
    }
    return tuple(sorted(sels))


def _track_matches(key: Tuple, pod: Pod) -> bool:
    """Whether a bound pod counts against a tracking slot: any selector in
    the slot's fingerprint matches its labels (kube counts label matches,
    whether or not the bound pod carries the constraint itself)."""
    for entry in key:
        sel, exprs = entry[1], entry[2]
        if entry[0] == "a" and entry[3] and pod.namespace not in entry[3]:
            continue
        if selector_matches(pod.labels, sel, exprs):
            return True
    return False


def _zone_spread_zones(pod: Pod) -> bool:
    return any(
        c.topology_key == L.LABEL_ZONE
        and c.selects(pod)
                for c in pod.topology_spread
    )


def _daemon_overhead(
    pool: NodePool, reqs: Requirements, daemonsets: Sequence[Pod]
) -> Resources:
    out = Resources()
    for d in daemonsets:
        if not tolerates_all(d.tolerations, pool.taints):
            continue
        if not reqs.compatible(d.scheduling_requirements()):
            continue
        out = out + d.requests
    return out


def live_filter(existing) -> list:
    """The schedulable subset of `existing`: nodes neither marked for
    deletion nor cordoned.  The ONE definition — `compile_problem`'s
    existing-node rows and the resident delta planner (ops/resident.py)
    must agree on it exactly, or the resident path keeps columns a
    from-scratch compile would drop."""
    return [
        sn
        for sn in existing
        if not sn.marked_for_deletion()
        and not (sn.node is not None and sn.node.cordoned)
    ]


def compile_problem(
    pods: Sequence[Pod],
    pools: Sequence[NodePool],
    instance_types: Dict[str, List[InstanceType]],
    existing: Sequence[StateNode] = (),
    daemonsets: Sequence[Pod] = (),
    catalog: Optional[Catalog] = None,
    presplit: bool = False,
    groups: Optional[List[Tuple[Tuple, List[Pod]]]] = None,
) -> CompiledProblem:
    """Compile one scheduling problem to tensors.

    Pass a prebuilt ``catalog`` (from `build_catalog`) to skip re-deriving
    the launchable config rows — valid as long as the (pools,
    instance-types, daemonsets) snapshot is unchanged and the pods
    introduce no new extended-resource axes.  ``presplit=True`` promises
    the caller already ran `partition_pods` and kept only the supported
    half, skipping the (pure-overhead) re-check on the hot path.
    ``groups`` passes the caller's `partition_groups` output so the class
    grouping isn't recomputed (every member of a group shares the
    representative's requests and constraint signature by construction).
    """
    if groups is None:
        pods = list(pods)
        # merge-aware grouping: node-equivalent co-location closures arrive
        # as ONE macro group here exactly as they do on the solver's
        # presplit path
        sup_groups, unsupported, why = partition_groups(
            pods, existing=existing, pools=pools
        )
        if unsupported:
            groups = _class_groups(pods)
            reason = "" if presplit else why
        else:
            groups = sup_groups
            reason = ""
    else:
        reason = "" if presplit else _unsupported_reason(pods, existing, pools)
    axes = _axes_for_requests([key[1] for key, _ in groups])
    if catalog is None or catalog.axes != axes:
        catalog = build_catalog(pools, instance_types, daemonsets, axes)
    pools = catalog.pools
    R = len(axes)

    # ----------------------------------------------- existing-node rows
    live = live_filter(existing)
    first_existing = len(catalog.configs)
    configs = list(catalog.configs) + [
        ConfigMeta(
            pool=None,
            instance_type=None,
            zone=sn.zone,
            capacity_type=sn.capacity_type,
            price=0.0,
            existing=sn,
        )
        for sn in live
    ]
    C = len(configs)
    if live:
        alloc = np.concatenate(
            [catalog.alloc, np.stack([_vec(sn.allocatable, axes) for sn in live])]
        )
        price = np.concatenate([catalog.price, np.zeros(len(live), np.float32)])
    else:
        alloc = catalog.alloc
        price = catalog.price
    openable = np.zeros(C, bool)
    openable[:first_existing] = True

    # ------------------------------------------------------------- classes
    all_zones = sorted(set(catalog.zones) | {sn.zone for sn in live if sn.zone})
    group_list = groups

    # zone-keyed pod affinity: compile-time domain anchoring — each coupled
    # component of classes pins to ONE zone (the oracle anchors the domain
    # with the first matching placement; here the anchor is chosen up front
    # from existing placements, zone requirements, and per-zone feasibility)
    anchor_of = _anchor_zone_affinity(group_list, all_zones, catalog, pools, live)

    classes: List[ClassMeta] = []
    pools_by_name = {p.name: p for p in pools}
    track_slots: Dict[Tuple, int] = {}
    # per-SPREAD-GROUP shares already handed out in this compile: a
    # service whose pods span several request classes splits each class
    # against the group's accumulated counts, not a fresh zero — per-class
    # splits are individually balanced but their sum can skew past
    # maxSkew (e.g. three classes each putting their remainder in zone-a)
    spread_assigned: Dict[Tuple, Dict[str, int]] = {}
    for gi, ((sig, requests), members) in enumerate(group_list):
        rep = members[0]
        maxper = _max_per_node(rep)
        slot = 0
        if maxper < BIG:
            # slot key = the hostname-constraint FINGERPRINT, not the pod
            # signature: mutually-coupled classes carrying the identical
            # anti-affinity selector (variant labels under one selector)
            # share one per-node counter, which is exactly the <=1-of-the-
            # union semantics (partition_groups admits them only when the
            # fingerprints match)
            slot = track_slots.setdefault(
                _track_key(rep), len(track_slots) + 1
            )
        if any(
            not t.anti and t.topology_key == L.LABEL_HOSTNAME
            for t in rep.pod_affinity
        ):
            # self-selecting hostname co-location: the group is ONE
            # placement unit with summed requests (partition_groups
            # guarantees single-class, no live members).  If no single
            # node can hold the sum, the whole group is unschedulable —
            # real-scheduler bind semantics, where the first bound member
            # pins every other member to its node
            total = Resources()
            for m in members:
                total = total + m.requests
            classes.append(
                ClassMeta(
                    pods=members,
                    requests=total,
                    signature=sig,
                    group_size=len(members),
                )
            )
        elif gi in anchor_of:
            zone = anchor_of[gi]
            if zone is None:
                classes.append(
                    ClassMeta(
                        pods=members,
                        requests=requests,
                        signature=sig,
                        infeasible=True,
                        unsched_reason=(
                            "pod affinity has no admissible zone domain"
                        ),
                    )
                )
            else:
                classes.append(
                    ClassMeta(
                        pods=members,
                        requests=requests,
                        signature=sig,
                        zone_pin=zone,
                        max_per_node=maxper,
                        track_slot=slot,
                    )
                )
        elif any(
            t.anti and t.topology_key == L.LABEL_ZONE and t.selects(rep)
            for t in rep.pod_affinity
        ):
            # self-selecting zone anti-affinity: at most one matching pod per
            # zone -> one singleton class per remaining zone domain, pinned;
            # zones already holding a matching pod are off-limits
            terms = [
                t
                for t in rep.pod_affinity
                if t.anti and t.topology_key == L.LABEL_ZONE
            ]
            excluded = {
                sn.zone
                for sn in live
                if sn.zone
                and any(t.selects(bp) for t in terms for bp in sn.pods)
            }
            zr = rep.scheduling_requirements(preferred=True).get(L.LABEL_ZONE)
            allowed = [
                z
                for z in all_zones
                if z not in excluded and (zr is None or zr.has(z))
            ]
            feasz = _feasible_zones(rep, catalog, pools, live, requests)
            allowed.sort(key=lambda z: (z not in feasz, z))
            for i, m in enumerate(members[: len(allowed)]):
                classes.append(
                    ClassMeta(
                        pods=[m],
                        requests=requests,
                        signature=sig,
                        zone_pin=allowed[i],
                        max_per_node=maxper,
                        track_slot=slot,
                    )
                )
            extra = members[len(allowed):]
            if extra:
                classes.append(
                    ClassMeta(
                        pods=extra,
                        requests=requests,
                        signature=sig,
                        infeasible=True,
                        unsched_reason=(
                            "zone anti-affinity: no remaining zone domain"
                        ),
                    )
                )
        elif _zone_spread_zones(rep) and len(all_zones) > 1:
            # Split the class across zones, balancing against existing skew.
            # Candidate domains are filtered by the pod's own zone
            # requirements (Kubernetes counts skew only over nodes that
            # satisfy the pod's nodeAffinity/nodeSelector).
            c0 = next(
                c
                for c in rep.topology_spread
                if c.topology_key == L.LABEL_ZONE
                and c.selects(rep)
                            )
            zr = rep.scheduling_requirements(preferred=True).get(L.LABEL_ZONE)
            cand_zones = [z for z in all_zones if zr is None or zr.has(z)]
            # ...and by the POOLS' zone admission: spread domains are the
            # zones some pool could actually create nodes in
            # (karpenter-core builds domains from provisioner
            # requirements) — an all-zones universe would anchor the skew
            # floor at zones nothing can serve
            pool_zones = _pool_zone_domains(pools, catalog)
            narrowed = [z for z in cand_zones if z in pool_zones]
            if narrowed:
                cand_zones = narrowed
            if not cand_zones:
                cand_zones = all_zones
            # only split into zones where the class can actually land: at
            # least one label-feasible, resource-fitting openable config, or
            # an admitting existing node — a share pinned to a zone with no
            # feasible placement would come back unschedulable even when a
            # feasible near-balanced split exists
            feas_zones = _feasible_zones(rep, catalog, pools, live, requests)
            split_zones = [z for z in cand_zones if z in feas_zones]
            if not split_zones:
                split_zones = cand_zones
            # seed with bound pods the constraint's SELECTOR matches plus
            # the shares sibling classes of this group already took
            assigned = spread_assigned.setdefault(_spread_selkey(c0), {})
            share, guard = _split_shares(
                len(members), split_zones, cand_zones, assigned,
                _live_spread_counts(live, c0, lambda sn: sn.zone or None),
                c0.max_skew,
            )
            if guard and not reason:
                reason = "zone spread constrained by infeasible domains"
            cursor = 0
            for z in split_zones:
                take = share[z]
                if take == 0:
                    continue
                classes.append(
                    ClassMeta(
                        pods=members[cursor : cursor + take],
                        requests=requests,
                        signature=sig,
                        zone_pin=z,
                        max_per_node=maxper,
                        track_slot=slot,
                    )
                )
                cursor += take
        elif _custom_spread_curable(rep, pools):
            # CUSTOM-topology-key spread (scheduling.md:319-331): pool
            # templates are single-valued for the key, so the domains
            # partition the pools — split the class across them like
            # zones, each split pinned via a cloned representative whose
            # node selector carries the domain (decoded nodes inherit the
            # label from their pool template, so the oracle's accounting
            # matches).
            c0 = rep.topology_spread[0]
            key = c0.topology_key
            domain_pools: Dict[str, List[NodePool]] = {}
            for pool in pools:
                vr = pool.template_requirements().get(key)
                if vr is not None and not vr.complement and len(vr.values) == 1:
                    domain_pools.setdefault(
                        next(iter(vr.values)), []
                    ).append(pool)
            # live label values are domains too (the oracle's universe
            # includes them) — an orphaned domain with no serving pool
            # still anchors the skew floor
            live_doms = {
                v for sn in live if (v := sn.labels.get(key)) is not None
            }
            cand_domains = sorted(set(domain_pools) | live_doms)
            kr = rep.scheduling_requirements(preferred=True).get(key)
            if kr is not None:
                cand_domains = [d for d in cand_domains if kr.has(d)]
            # only split into domains the class can actually land in: a
            # label-feasible, resource-fitting openable config of the
            # domain's pools, or an admitting live node carrying the
            # label (a LIVE-ONLY domain is valid — its split class gets
            # an empty pool_allow, so its feasibility row holds only the
            # existing-node columns) — the zone split's _feasible_zones
            # filter
            ovs = {d: _pin_clone(rep, key, d) for d in cand_domains}
            feas_doms = [
                d
                for d in cand_domains
                if _pin_feasible(
                    ovs[d], domain_pools.get(d, ()), catalog,
                    pools_by_name, live, requests,
                )
            ]
            split_domains = feas_doms or [
                d for d in cand_domains if d in domain_pools
            ]
            if not split_domains:
                classes.append(
                    ClassMeta(
                        pods=members,
                        requests=requests,
                        signature=sig,
                        infeasible=True,
                        unsched_reason=(
                            "topology spread: no admissible domain"
                        ),
                    )
                )
                continue
            assigned = spread_assigned.setdefault(_spread_selkey(c0), {})
            share, guard = _split_shares(
                len(members), split_domains, cand_domains, assigned,
                _live_spread_counts(live, c0, lambda sn: sn.labels.get(key)),
                c0.max_skew,
            )
            if guard and not reason:
                reason = "topology spread constrained by infeasible domains"
            cursor = 0
            for d in split_domains:
                take = share[d]
                if take == 0:
                    continue
                classes.append(
                    ClassMeta(
                        pods=members[cursor : cursor + take],
                        requests=requests,
                        signature=ovs[d].constraint_signature(),
                        rep_override=ovs[d],
                        pool_allow=frozenset(
                            p.name for p in domain_pools.get(d, ())
                        ),
                        max_per_node=maxper,
                        track_slot=slot,
                    )
                )
                cursor += take
        elif any(
            c.topology_key not in (L.LABEL_HOSTNAME, L.LABEL_ZONE)
            for c in rep.topology_spread
        ):
            # partition cured the custom-key spread against a pool list
            # that differs from the catalog's (e.g. the defining pool was
            # deleted between the two): compiling the class PLAIN would
            # silently drop a hard constraint — match the oracle, where a
            # key no pool defines has no valid domain
            classes.append(
                ClassMeta(
                    pods=members,
                    requests=requests,
                    signature=sig,
                    infeasible=True,
                    unsched_reason=(
                        "topology spread: no pool defines the domain key"
                    ),
                )
            )
        else:
            classes.append(
                ClassMeta(
                    pods=members,
                    requests=requests,
                    signature=sig,
                    max_per_node=maxper,
                    track_slot=slot,
                )
            )

    # FFD order: constrained classes first, then descending size
    classes.sort(key=ffd_class_key)
    G = len(classes)

    # --------------------------------------------------------- feasibility
    # Vectorized assembly: exact Requirements-algebra checks run once per
    # (signature, pool) over the TYPE axis (and once per zone / capacity
    # type), then broadcast onto the full config axis with numpy — a
    # per-config Python loop would dominate the 200ms solve budget.
    # A node-INEQUIVALENT co-location macro (members spanning several
    # constraint signatures) gets the AND of its member rows: the whole
    # group lands on one node, so its feasible set is exactly the
    # intersection of the members' sets.
    feas = np.zeros((G, C), dtype=bool)
    classes_by_sig: Dict[Tuple, List[int]] = {}
    sig_reps_of: Dict[Tuple, Tuple] = {}
    for g, cm in enumerate(classes):
        if cm.infeasible:
            continue  # proven unschedulable at compile time: row stays 0
        if cm.group_size:
            seen: Dict[Tuple, Pod] = {}
            for p in cm.pods:
                s = p.constraint_signature()
                if s not in seen:
                    seen[s] = p
            pairs = tuple(seen.items())
        else:
            # a custom-spread split's override pod carries the domain
            # pin; its signature IS cm.signature by construction
            pairs = ((cm.signature, cm.rep_override or cm.pods[0]),)
        key = (tuple(s for s, _ in pairs), cm.zone_pin, cm.pool_allow)
        classes_by_sig.setdefault(key, []).append(g)
        sig_reps_of[key] = (pairs, cm.pool_allow)

    row_memo: Dict[Tuple, np.ndarray] = {}

    def _sig_row(
        sig: Tuple,
        rep: Pod,
        zone_pin: str,
        term: int = 0,
        keep: Optional[int] = None,
        pool_allow: Optional[frozenset] = None,
    ) -> np.ndarray:
        mkey = (sig, zone_pin, term, keep, pool_allow)
        row = row_memo.get(mkey)
        if row is not None:
            return row
        open_row = open_config_row(
            catalog, rep, sig, pools_by_name, zone_pin, term, keep, pool_allow
        )
        row = np.zeros(C, dtype=bool)
        row[:first_existing] = open_row
        if live:
            sched = rep.scheduling_requirements(
                preferred=True, term=term, keep_prefs=keep
            )
            if zone_pin:
                sched = Requirements(iter(sched))
                sched.add(Requirement(L.LABEL_ZONE, Op.IN, [zone_pin]))
            for e, sn in enumerate(live):
                row[first_existing + e] = _fits_existing(rep, sched, sn)
        row_memo[mkey] = row
        return row

    def _combined_row(
        pairs: Tuple,
        zone_pin: str,
        term: int,
        keep: Optional[int],
        pool_allow: Optional[frozenset] = None,
    ) -> np.ndarray:
        row = _sig_row(pairs[0][0], pairs[0][1], zone_pin, term, keep, pool_allow)
        for s, r in pairs[1:]:
            row = row & _sig_row(s, r, zone_pin, term, keep, pool_allow)
        return row

    compile_relaxed = 0
    for (sigs, zone_pin, _pa), g_idx in classes_by_sig.items():
        pairs, pool_allow = sig_reps_of[(sigs, zone_pin, _pa)]
        row = _combined_row(pairs, zone_pin, 0, None, pool_allow)
        if not row.any():
            # compile-time relaxation: when the STRICT shape admits no
            # config anywhere, walk the same (OR-term x preference-peel)
            # ladder the oracle walks per pod (scheduler._attempt_ladder)
            # — but once per class, on the compiled rows, so a
            # preference-heavy batch stays on the tensor path instead of
            # draining through the Python continuation.  Global row
            # emptiness is exactly the oracle's "proves unschedulable"
            # for these shapes: no node (new or live) admits the pod, so
            # the oracle would relax too.
            # a multi-signature class is a co-location macro: the merge
            # gate requires identical sig[9] (OR-terms) across members,
            # so rep0's term count holds for all.  Preference peeling is
            # walked here only when every member carries the SAME
            # preference list — a uniform keep index over DIFFERING lists
            # would peel one member's satisfiable preference because of
            # another's impossible one; those closures skip the ladder
            # and relax as a unit through the oracle (solver.solve pulls
            # the whole closure, whose gang machinery peels per member)
            rep0 = pairs[0][1]
            n_terms = len(rep0.node_affinity_terms())
            uniform_prefs = len({s[7] for s, _ in pairs}) == 1
            n_prefs = (
                len(rep0.preferred_affinity) if uniform_prefs else 0
            )
            for ti in range(n_terms):
                keeps = [None] if ti else []
                keeps += list(range(n_prefs - 1, -1, -1))
                found = False
                for keep in keeps:
                    cand = _combined_row(pairs, zone_pin, ti, keep, pool_allow)
                    if cand.any():
                        row = cand
                        compile_relaxed += sum(
                            len(classes[g].pods) for g in g_idx
                        )
                        found = True
                        break
                if found:
                    break
        feas[g_idx] = row

    req_mat = (
        np.stack([_vec(cm.requests, axes) for cm in classes])
        if classes
        else np.zeros((0, R), np.float32)
    )

    # pool weight priority (reference designs/provisioner-priority.md): the
    # oracle tries pools highest-weight-first and commits to the first that
    # admits the pod.  Enforce the same by restricting each class's
    # new-node feasibility to its highest-weight admitting TIER — pools
    # with EQUAL weight have no defined priority between them (the oracle
    # freely fills any open node regardless of pool), so restricting to a
    # single pool within a tier would fragment the pack.
    if len(pools) > 1:
        cat_tiers, n_tiers = catalog_tiers(catalog)
        tier_of = np.full(C, -1, np.int32)  # live columns carry no tier
        tier_of[:first_existing] = cat_tiers
        for g in range(G):
            fits = (req_mat[g][None, :] <= alloc + 1e-6).all(axis=1)
            for t in range(n_tiers):
                sel = (tier_of == t) & feas[g] & fits
                if sel.any():
                    feas[g] &= (tier_of == t) | (tier_of == -1)
                    break

    # seed per-signature counters with pods already bound to existing nodes
    # (so anti-affinity/hostname-spread caps see prior placements)
    S = len(track_slots) + 1
    sig_used0 = np.zeros((S, len(live)), np.int32)
    if track_slots:
        for e, sn in enumerate(live):
            for bound in sn.pods:
                # count by SELECTOR match, not signature equality: a bound
                # pod with matching labels blocks an anti-affinity class
                # even when it carries no constraint itself
                for key, s in track_slots.items():
                    if _track_matches(key, bound):
                        sig_used0[s, e] += 1

    return CompiledProblem(
        axes=axes,
        classes=classes,
        configs=configs,
        req=req_mat,
        cnt=np.array(
            # a co-location macro is ONE placement unit regardless of size
            [1 if cm.group_size else len(cm.pods) for cm in classes],
            dtype=np.int32,
        ),
        maxper=np.array(
            [min(cm.max_per_node, BIG) for cm in classes], dtype=np.int32
        ),
        slot=np.array([cm.track_slot for cm in classes], dtype=np.int32),
        alloc=alloc,
        price=price,
        openable=openable,
        feas=feas,
        pool_daemon_overhead=catalog.pool_overhead,
        used0=np.stack([_vec(sn.used, axes) for sn in live])
        if live
        else np.zeros((0, R), np.float32),
        cfg0=np.arange(first_existing, first_existing + len(live), dtype=np.int32),
        npods0=np.array([len(sn.pods) for sn in live], dtype=np.int32),
        sig_used0=sig_used0,
        n_track_slots=S,
        unsupported_reason=reason,
        compile_relaxed=compile_relaxed,
    )


def _memo_put(catalog: Catalog, key, value):
    """feas_memo insert with the shared unbounded-workload backstop."""
    if len(catalog.feas_memo) > 50_000:
        catalog.feas_memo.clear()
    catalog.feas_memo[key] = value
    return value


def ffd_class_key(cm: ClassMeta) -> Tuple:
    """The compile's FFD class sort key: constrained classes first, then
    descending size; ties keep list order (stable sort), which is the
    classes' first-occurrence order over the batch.  Shared with the
    resident delta planner (ops/resident.py), which must insert arriving
    classes at exactly the position a from-scratch compile would sort
    them to."""
    constrained = (
        cm.max_per_node < BIG
        or bool(cm.zone_pin)
        or cm.rep_override is not None
    )
    r = cm.requests
    return (
        not constrained,
        -(r.cpu + r.memory / (4 * 2**30)),
    )


def open_config_row(
    catalog: Catalog,
    rep: Pod,
    sig: Tuple,
    pools_by_name: Dict[str, NodePool],
    zone_pin: str = "",
    term: int = 0,
    keep: Optional[int] = None,
    pool_allow: Optional[frozenset] = None,
) -> np.ndarray:
    """The OPENABLE prefix of one class's feasibility row.

    Depends only on the signature shape and this catalog snapshot — never
    on the live nodes — so it memoizes for the CATALOG's lifetime
    ("catalog epoch": a new inventory snapshot builds a new Catalog with
    a fresh memo).  A warm re-compile of a recurring pending set
    assembles its rows from these cached prefixes and only re-checks the
    live columns.  THE single assembly path for openable rows: both
    `compile_problem` and the resident delta planner (ops/resident.py)
    call it, so an incrementally-scattered row is bit-identical to a
    from-scratch compile's by construction."""
    ckey = ("row", sig, zone_pin, term, keep, pool_allow)
    open_row = catalog.feas_memo.get(ckey)
    if open_row is None:
        open_row = np.zeros(len(catalog.configs), dtype=bool)
        for pname, pr in catalog.pool_rows.items():
            if pool_allow is not None and pname not in pool_allow:
                continue  # only the domain's pools DEFINE the spread key
            ent = _pool_feas(
                catalog, rep, sig, pname, pools_by_name, term, keep
            )
            if ent is None:
                continue
            type_ok, zone_ok, ct_ok = ent
            if zone_pin:
                zone_ok = zone_ok & np.fromiter(
                    (z == zone_pin for z in pr.zones), bool, len(pr.zones)
                )
            open_row[pr.rows] = (
                type_ok[pr.t_of] & zone_ok[pr.z_of] & ct_ok[pr.ct_of]
            )
        _memo_put(catalog, ckey, open_row)
    return open_row


def catalog_tiers(catalog: Catalog) -> Tuple[np.ndarray, int]:
    """(tier index per catalog config row, tier count) for the pool-weight
    priority restriction — pools are weight-desc ordered, equal weights
    share a tier.  Memoized per catalog; both `compile_problem`'s
    per-class loop and the resident path's `restrict_open_tier` read it,
    so the tier rule has exactly one definition (live columns carry tier
    -1 in the compile and never participate in tier CHOICE, which is why
    the per-class restriction below can run on the openable prefix
    alone)."""
    ent = catalog.feas_memo.get("tiers")
    if ent is None:
        pools = catalog.pools
        tier_of_rank = np.zeros(max(len(pools), 1), np.int32)
        tier = 0
        for r in range(1, len(pools)):
            if pools[r].weight != pools[r - 1].weight:
                tier += 1
            tier_of_rank[r] = tier
        tier_of = (
            tier_of_rank[catalog.pool_rank_of]
            if len(catalog.pool_rank_of)
            else np.zeros(0, np.int32)
        )
        ent = _memo_put(catalog, "tiers", (tier_of, tier + 1))
    return ent


def restrict_open_tier(
    catalog: Catalog, open_row: np.ndarray, req_vec: np.ndarray
) -> np.ndarray:
    """Per-class pool-weight tier restriction on the OPENABLE prefix —
    the single-class equivalent of `compile_problem`'s pool-priority
    loop.  Sound to run without the live columns: in the compile, live
    columns carry tier -1, so they never influence which tier is chosen
    and are never masked by the restriction.  The delta-correctness fuzz
    suite (tests/test_resident_fuzz.py) pins the equivalence."""
    if len(catalog.pools) <= 1:
        return open_row
    tier_of, n_tiers = catalog_tiers(catalog)
    fits = (req_vec[None, :] <= catalog.alloc + 1e-6).all(axis=1)
    for t in range(n_tiers):
        if ((tier_of == t) & open_row & fits).any():
            return open_row & (tier_of == t)
    return open_row


def _pool_zone_domains(pools: Sequence[NodePool], catalog: Catalog) -> set:
    """Zone domain universe: offering zones admitted by some pool's
    TEMPLATE zone requirement.  Pool-side only — no taint or type
    filtering, matching karpenter-core's domain construction and the
    Kubernetes default of nodeTaintsPolicy: Ignore (the oracle's
    Scheduler.__init__ builds the identical universe).  Pod-independent,
    so it memoizes once per catalog."""
    out = catalog.feas_memo.get("domains")
    if out is None:
        out = set()
        for pool in pools:
            zr = pool.template_requirements().get(L.LABEL_ZONE)
            pr = catalog.pool_rows.get(pool.name)
            if pr is None:
                continue
            out.update(z for z in pr.zones if zr is None or zr.has(z))
        _memo_put(catalog, "domains", out)
    return out


def _feasible_zones(
    rep: Pod,
    catalog: Catalog,
    pools: Sequence[NodePool],
    live: Sequence[StateNode],
    requests: Resources,
) -> set:
    """Zones where `rep`'s class has >=1 feasible placement: a
    label-compatible, resource-fitting openable config, or an admitting
    existing node with room for the request.

    The OPENABLE half depends only on (signature, requests) and the
    catalog snapshot, so it memoizes for the catalog's lifetime (the
    same reasoning as `_pool_feas`); only the live-node half is
    recomputed per solve."""
    sig = rep.constraint_signature()
    memo_key = ("zones", sig, tuple(sorted(requests.items())))
    zones = catalog.feas_memo.get(memo_key)
    if zones is None:
        req_vec = _vec(requests, catalog.axes)
        pools_by_name = {p.name: p for p in pools}
        zones = set()
        for pname, pr in catalog.pool_rows.items():
            ent = _pool_feas(catalog, rep, sig, pname, pools_by_name)
            if ent is None:
                continue
            type_ok, zone_ok, ct_ok = ent
            fits = (req_vec[None, :] <= catalog.alloc[pr.rows] + 1e-6).all(axis=1)
            # the FULL admission mask, same as the feas[G, C] assembly: a
            # pool zone-restricted to zone-a must not report b/c feasible
            ok_rows = (
                type_ok[pr.t_of] & zone_ok[pr.z_of] & ct_ok[pr.ct_of] & fits
            )
            zones.update(pr.zones[z] for z in set(pr.z_of[ok_rows].tolist()))
        _memo_put(catalog, memo_key, zones)
    out = set(zones)
    if live:
        sched = rep.scheduling_requirements(preferred=True)
        for sn in live:
            if sn.zone and sn.zone not in out and _fits_existing(rep, sched, sn):
                if (sn.used + requests).fits(sn.allocatable):
                    out.add(sn.zone)
    return out


def _pin_feasible(
    ov: Pod,
    pool_list: Sequence[NodePool],
    catalog: Catalog,
    pools_by_name: Dict[str, NodePool],
    live: Sequence[StateNode],
    requests: Resources,
) -> bool:
    """Whether a domain-pinned representative has at least one
    label-compatible, resource-fitting openable config among its domain's
    pools, or an admitting live node with room — the custom-topology-key
    analogue of `_feasible_zones`."""
    req_vec = _vec(requests, catalog.axes)
    sig = ov.constraint_signature()
    for pool in pool_list:
        ent = _pool_feas(catalog, ov, sig, pool.name, pools_by_name)
        if ent is None:
            continue
        type_ok, zone_ok, ct_ok = ent
        pr = catalog.pool_rows[pool.name]
        fits = (req_vec[None, :] <= catalog.alloc[pr.rows] + 1e-6).all(axis=1)
        if (type_ok[pr.t_of] & zone_ok[pr.z_of] & ct_ok[pr.ct_of] & fits).any():
            return True
    if live:
        sched = ov.scheduling_requirements(preferred=True)
        for sn in live:
            if _fits_existing(ov, sched, sn) and (
                sn.used + requests
            ).fits(sn.allocatable):
                return True
    return False


def _spread_selkey(c0) -> Tuple:
    """Identity of a spread group's share accumulator — must mirror the
    oracle tracker's group key (topology.py:_spread_group): topology key,
    selector, expressions, max_skew; when_unsatisfiable deliberately
    omitted (the tracker shares counts across DNS/SA variants too)."""
    return (
        c0.topology_key,
        tuple(sorted(c0.label_selector)),
        c0.match_expressions,
        c0.max_skew,
    )


def _live_spread_counts(
    live: Sequence[StateNode], c0, domain_of
) -> Dict[str, int]:
    """Per-domain counts of live bound pods the constraint's selector
    matches (the oracle replays placements the same way)."""
    out: Dict[str, int] = {}
    for sn in live:
        d = domain_of(sn)
        if d is None:
            continue
        n_sel = sum(1 for bp in sn.pods if c0.selects(bp))
        if n_sel:
            out[d] = out.get(d, 0) + n_sel
    return out


def _split_shares(
    n_members: int,
    split_doms: Sequence[str],
    cand_doms: Sequence[str],
    assigned: Dict[str, int],
    live_counts: Dict[str, int],
    max_skew: int,
) -> Tuple[Dict[str, int], bool]:
    """Balanced shares over ``split_doms``, seeded with the shares sibling
    classes of the group already took (``assigned``, updated in place) and
    with live placements the constraint's selector matches.

    The second return is the infeasible-domain GUARD: skew is measured
    against ALL candidate domains, so when an unservable domain anchors
    the global minimum and the hard-pinned shares would push a served
    domain past min+maxSkew, the caller must route the class to the
    oracle (which caps per-domain instead of pre-splitting)."""
    counts = {
        d: assigned.get(d, 0) + live_counts.get(d, 0) for d in split_doms
    }
    share = _balanced_split(n_members, counts)
    guard = False
    if len(split_doms) < len(cand_doms):
        finals = {
            d: assigned.get(d, 0) + live_counts.get(d, 0) for d in cand_doms
        }
        for d, take in share.items():
            finals[d] = finals.get(d, 0) + take
        floor = min(finals.values(), default=0)
        guard = any(finals[d] > floor + max_skew for d in split_doms)
    for d, take in share.items():
        if take:
            assigned[d] = assigned.get(d, 0) + take
    return share, guard


def _anchor_zone_affinity(
    group_list: List[Tuple[Tuple, List[Pod]]],
    all_zones: Sequence[str],
    catalog: Catalog,
    pools: Sequence[NodePool],
    live: Sequence[StateNode],
) -> Dict[int, Optional[str]]:
    """Choose one anchor zone per zone-affinity component.

    Returns {group index -> zone} for every group in a component that
    carries zone-keyed required pod affinity (None = no admissible zone,
    i.e. compile-time unschedulable).  Components are the transitive
    closure of "some affinity term selects the other class" — every class
    in a component pins to the same zone, the compile-time-sound rendering
    of the oracle's first-placement domain anchoring (scheduling.md:124-430
    interPodAffinity semantics; scheduling/topology.py _AffinityGroup)."""
    aff_terms: Dict[int, List] = {}
    for gi, (_, members) in enumerate(group_list):
        rep = members[0]
        terms = [
            t
            for t in rep.pod_affinity
            if not t.anti and t.topology_key == L.LABEL_ZONE
        ]
        if terms:
            aff_terms[gi] = terms
    if not aff_terms:
        return {}

    n = len(group_list)
    reps = [members[0] for _, members in group_list]
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    for gi, terms in aff_terms.items():
        for t in terms:
            for gj in range(n):
                if gj != gi and t.selects(reps[gj]):
                    union(gi, gj)

    comps: Dict[int, List[int]] = {}
    for gi in range(n):
        comps.setdefault(find(gi), []).append(gi)

    out: Dict[int, Optional[str]] = {}
    for idxs in comps.values():
        if not any(gi in aff_terms for gi in idxs):
            continue
        # candidates: intersection of every member's own zone requirements
        cand = set(all_zones)
        for gi in idxs:
            zr = reps[gi].scheduling_requirements(preferred=True).get(L.LABEL_ZONE)
            if zr is not None:
                cand &= {z for z in all_zones if zr.has(z)}
        # existing matching placements anchor the domain (followers must
        # join the zone that already holds matching pods)
        for gi in idxs:
            for t in aff_terms.get(gi, ()):
                dom = {
                    sn.zone
                    for sn in live
                    if sn.zone and any(t.selects(bp) for bp in sn.pods)
                }
                if dom:
                    cand &= dom
        # prefer a zone feasible for every class in the component
        feas = set(cand)
        for gi in idxs:
            feas &= _feasible_zones(
                reps[gi], catalog, pools, live, group_list[gi][0][1]
            )
        if feas:
            pick: Optional[str] = sorted(feas)[0]
        elif cand:
            pick = sorted(cand)[0]
        else:
            pick = None
        for gi in idxs:
            out[gi] = pick
    return out


def _balanced_split(n: int, existing_counts: Dict[str, int]) -> Dict[str, int]:
    """Distribute n pods over zones so final (existing + new) counts are as
    level as possible — the maxSkew>=1 optimum a spread constraint wants."""
    zones = sorted(existing_counts)
    counts = dict(existing_counts)
    out = {z: 0 for z in zones}
    for _ in range(n):
        z = min(zones, key=lambda z: (counts[z], z))
        counts[z] += 1
        out[z] += 1
    return out


def _merge_pool(
    rep: Pod, sched: Requirements, pool: NodePool
) -> Optional[Requirements]:
    """Pool template ∧ pod requirements, or None if structurally infeasible."""
    if not tolerates_all(rep.tolerations, pool.taints):
        return None
    merged = pool.template_requirements().union(sched)
    if merged.is_unsatisfiable():
        return None
    return merged


def _fits_existing(rep: Pod, sched: Requirements, sn: StateNode) -> bool:
    if not tolerates_all(rep.tolerations, sn.taints):
        return False
    node_reqs = Requirements.from_labels(sn.labels)
    return node_reqs.compatible(sched)
