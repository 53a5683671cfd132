"""CRD-equivalent objects: Pod, InstanceType, NodePool, NodeClaim, NodeClass.

Re-creations of the reference's API surface:
- Pod scheduling fields: the subset karpenter-core schedules on (resources,
  nodeSelector, nodeAffinity, tolerations, topologySpreadConstraints, pod
  (anti-)affinity — reference website v0.31 concepts/scheduling.md:124-430).
- InstanceType/Offering: karpenter-core cloudprovider types observed at
  reference pkg/providers/instancetype/types.go:52-67,130-158 and
  pkg/cloudprovider/cloudprovider.go:296-307.
- NodePool: karpenter-core v1beta1 NodePool (designs/v1beta1-api.md).
- NodeClaim: the desired-machine handshake object
  (pkg/cloudprovider/cloudprovider.go:94-120).
- NodeClass: the provider-specific class, analogous to EC2NodeClass
  (pkg/apis/v1beta1/ec2nodeclass.go:28-107).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import logging
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.api.requirements import Op, Requirement, Requirements
from karpenter_tpu_torch.api.resources import Resources

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Taints and tolerations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = L.TAINT_EFFECT_NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def tolerates_all(tolerations: Sequence[Toleration], taints: Sequence[Taint]) -> bool:
    """A pod schedules onto a node iff every NoSchedule/NoExecute taint is
    tolerated (PreferNoSchedule is soft and ignored for feasibility)."""
    for t in taints:
        if t.effect == L.TAINT_EFFECT_PREFER_NO_SCHEDULE:
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


# ---------------------------------------------------------------------------
# Pod scheduling constraints
# ---------------------------------------------------------------------------


_EXPR_OPS = frozenset(("In", "NotIn", "Exists", "DoesNotExist"))
_warned_expr_ops = set()


def validate_match_expressions(exprs: Iterable[Tuple], context: str) -> None:
    """Construction-time check for matchExpressions operators: an unknown
    operator keeps kube's invalid-selector contract (match nothing — see
    _expr_matches), but a typo'd operator BUILT IN CODE must surface
    loudly instead of silently matching nothing forever, so it logs once
    per operator string here (ADVICE r5 low)."""
    for expr in exprs:
        op = expr[1] if len(expr) > 1 else None
        if op not in _EXPR_OPS and op not in _warned_expr_ops:
            _warned_expr_ops.add(op)
            log.warning(
                "unknown label-selector operator %r in %s matchExpressions "
                "(valid: %s); the selector will match nothing",
                op, context, "/".join(sorted(_EXPR_OPS)),
            )


def _expr_matches(labels: Mapping[str, str], expr: Tuple) -> bool:
    """One matchExpressions entry — (key, operator, values) with kube's
    label-selector operators (In/NotIn/Exists/DoesNotExist).

    An unknown operator makes the selector INVALID, and kube's contract
    for an invalid selector is to match nothing — returning False keeps
    one malformed pod spec from throwing inside the scheduling loop.
    Objects carrying match_expressions validate the operators once at
    construction (validate_match_expressions) so code-built typos still
    surface in the logs."""
    key, op, values = expr
    v = labels.get(key)
    if op == "In":
        return v is not None and v in values
    if op == "NotIn":
        return v is None or v not in values
    if op == "Exists":
        return v is not None
    if op == "DoesNotExist":
        return v is None
    return False


def selector_matches(
    labels: Mapping[str, str],
    match_labels: Tuple[Tuple[str, str], ...],
    match_expressions: Tuple[Tuple, ...] = (),
) -> bool:
    """Full kube label-selector semantics: matchLabels AND every
    matchExpressions entry (reference scheduling.md:360-373 uses
    matchExpressions selectors for pod affinity)."""
    return all(labels.get(k) == v for k, v in match_labels) and all(
        _expr_matches(labels, e) for e in match_expressions
    )


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Tuple[Tuple[str, str], ...] = ()  # matchLabels, sorted
    # (key, operator, values) triples; operator: In/NotIn/Exists/DoesNotExist
    match_expressions: Tuple[Tuple, ...] = ()

    def __post_init__(self):
        validate_match_expressions(
            self.match_expressions, "TopologySpreadConstraint"
        )

    def selects(self, pod: "Pod") -> bool:
        return selector_matches(
            pod.labels, self.label_selector, self.match_expressions
        )


@dataclass(frozen=True)
class PodAffinityTerm:
    """requiredDuringScheduling pod (anti-)affinity term."""

    topology_key: str
    label_selector: Tuple[Tuple[str, str], ...] = ()  # matchLabels, sorted
    anti: bool = False
    namespaces: Tuple[str, ...] = ()
    # (key, operator, values) triples; operator: In/NotIn/Exists/DoesNotExist
    match_expressions: Tuple[Tuple, ...] = ()

    def __post_init__(self):
        validate_match_expressions(self.match_expressions, "PodAffinityTerm")

    def selects(self, pod: "Pod") -> bool:
        if self.namespaces and pod.namespace not in self.namespaces:
            return False
        return selector_matches(
            pod.labels, self.label_selector, self.match_expressions
        )


_pod_seq = itertools.count()


def reset_name_sequences() -> None:
    """Rewind the auto-name counters (pod-N / nodeclaim-N).

    The cluster simulator's determinism contract is byte-identical traces
    for equal seeds, and generated names leak into the trace (CreateTags
    carries the claim name).  A fresh simulation therefore rewinds the
    process-global counters — only safe against a FRESH KubeStore/FakeCloud,
    where no live object can collide with a re-issued name."""
    global _pod_seq, _claim_seq
    _pod_seq = itertools.count()
    _claim_seq = itertools.count()


@dataclass
class Pod:
    """The scheduling-relevant projection of a v1.Pod."""

    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    requests: Resources = field(default_factory=Resources)
    node_selector: Dict[str, str] = field(default_factory=dict)
    required_affinity: List[Requirement] = field(default_factory=list)
    # OR-of-AND nodeSelectorTerms (reference scheduling.md:230-259):
    # karpenter goes through the terms in order and takes the first that
    # works.  When set, this supersedes `required_affinity` (the
    # single-term convenience); the tensor path compiles term 0 and the
    # oracle fallback iterates the rest.
    affinity_terms: List[Tuple[Requirement, ...]] = field(default_factory=list)
    preferred_affinity: List[Requirement] = field(default_factory=list)
    # names of PersistentVolumeClaims (same namespace) the pod mounts; the
    # provisioner resolves them into `volume_requirements` before solving
    # (reference website v0.31 concepts/scheduling.md "persistent volume
    # topology": nodes must land where the volumes can live)
    volume_claims: List[str] = field(default_factory=list)
    # zone requirements derived from the claims (bound PV zone, or the
    # storage class's allowed topologies for unbound WaitForFirstConsumer
    # claims) — injected/refreshed per provisioning pass, REQUIRED while set
    volume_requirements: List[Requirement] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    pod_affinity: List[PodAffinityTerm] = field(default_factory=list)
    priority: int = 0
    has_controller: bool = True
    node_name: str = ""  # bound node ("" = pending)
    is_daemonset: bool = False
    phase: str = "Pending"

    # fields that feed constraint_signature(); reassigning any of them
    # invalidates the memo (in-place mutation of the dict/list values is
    # still undetectable — replace, don't mutate)
    _SIG_FIELDS = frozenset(
        {
            "labels",
            "namespace",
            "node_selector",
            "required_affinity",
            "affinity_terms",
            "preferred_affinity",
            "volume_requirements",
            "tolerations",
            "topology_spread",
            "pod_affinity",
        }
    )

    def __setattr__(self, name, value):
        if name in Pod._SIG_FIELDS:
            d = self.__dict__
            d.pop("_sig", None)
            d.pop("_gkey", None)
            # mutation epoch: reassigning a constraint field (or requests,
            # below) bumps it, so identity-keyed caches above the signature
            # memo (the solver's incremental compile cache) key on
            # (id(pod), epoch) and a mutated pod can never serve a stale
            # compiled entry.  In-place mutation of the dict/list VALUES
            # remains undetectable, same as the signature memo — replace,
            # don't mutate.
            d["_mut"] = d.get("_mut", 0) + 1
        elif name == "requests":
            d = self.__dict__
            d.pop("_gkey", None)
            d["_mut"] = d.get("_mut", 0) + 1
        object.__setattr__(self, name, value)

    def mutation_epoch(self) -> int:
        """Monotonic per-pod counter of constraint/requests reassignments
        (see __setattr__) — the solver's compile-cache fingerprint input."""
        return self.__dict__.get("_mut", 0)

    def __post_init__(self):
        if not self.name:
            self.name = f"pod-{next(_pod_seq)}"
        # every pod consumes one pod slot
        if self.requests.get(L.RESOURCE_PODS) == 0:
            self.requests = self.requests + Resources({L.RESOURCE_PODS: 1})

    # -- derived scheduling state -------------------------------------------
    def node_affinity_terms(self) -> List[Tuple[Requirement, ...]]:
        """The OR-terms in karpenter's try-in-order semantics; the
        single-term convenience field maps to one term."""
        if self.affinity_terms:
            return self.affinity_terms
        if self.required_affinity:
            return [tuple(self.required_affinity)]
        return [()]

    def scheduling_requirements(
        self, preferred: bool = False, term: int = 0,
        keep_prefs: Optional[int] = None,
    ) -> Requirements:
        """nodeSelector + the ``term``-th node-affinity OR-term as one
        conjunction.

        With ``preferred`` the preferred-affinity terms merge in too:
        karpenter treats preferences as REQUIRED while simulating and
        relaxes them only when the pod proves unschedulable (reference
        website v0.31 concepts/scheduling.md "preferences").  The
        relaxation is TERM-BY-TERM: ``keep_prefs`` keeps only the first N
        preferences (list order is priority order, highest first), so the
        oracle's peel walk (scheduler._attempt_ladder) drops one
        preference per attempt from the tail — karpenter-core's
        RelaxMinimal, with list position standing in for weight."""
        reqs = Requirements.from_labels(self.node_selector)
        terms = self.node_affinity_terms()
        for r in terms[min(term, len(terms) - 1)]:
            reqs.add(r)
        for r in self.volume_requirements:
            reqs.add(r)
        if preferred:
            prefs = (
                self.preferred_affinity
                if keep_prefs is None
                else self.preferred_affinity[:keep_prefs]
            )
            for r in prefs:
                reqs.add(r)
        return reqs

    def do_not_evict(self) -> bool:
        return self.annotations.get(L.ANNOTATION_DO_NOT_EVICT, "") == "true"

    def deletion_cost(self) -> float:
        try:
            return float(self.annotations.get(L.ANNOTATION_POD_DELETION_COST, 0))
        except ValueError:
            return 0.0

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def constraint_signature(self) -> Tuple:
        """Hashable signature of everything that affects where this pod can
        go.  Pods with equal signatures are interchangeable to the solver
        (they may still differ in resource requests).

        Memoized: computed once per pod (the tensor solver calls this for
        every pod on every solve).  Reassigning a constraint field clears
        the memo (see __setattr__); mutating a constraint dict/list IN
        PLACE after the first solve is not detected — replace the value
        instead."""
        cached = self.__dict__.get("_sig")
        if cached is not None:
            return cached
        self.__dict__["_sig"] = sig = (
            tuple(sorted(self.node_selector.items())),
            tuple(sorted(map(repr, self.required_affinity))),
            tuple(sorted(self.tolerations, key=repr)),
            tuple(sorted(self.topology_spread, key=repr)),
            tuple(sorted(self.pod_affinity, key=repr)),
            tuple(sorted(self.labels.items())),
            self.namespace,
            # appended LAST so consumers indexing sig[0..6] stay valid.
            # preferred_affinity keeps LIST ORDER (not sorted): order is
            # priority under term-by-term peeling (keep_prefs slices the
            # list), so pods with the same preferences in different order
            # relax differently and must not share a class or a try_add
            # label-scan cache entry
            tuple(map(repr, self.preferred_affinity)),
            tuple(sorted(map(repr, self.volume_requirements))),
            tuple(tuple(map(repr, t)) for t in self.affinity_terms),
        )
        return sig

    def class_key(self) -> "ClassKey":
        """Interned (constraint_signature, requests) grouping key.

        The tensor solver groups every pod on every solve; hashing the deep
        signature tuple per lookup dominates the host-side compile at 10k
        pods.  Interning pays the deep hash once per pod, after which
        lookups hash a cached int and compare by identity."""
        ck = self.__dict__.get("_gkey")
        if ck is None:
            raw = (self.constraint_signature(), self.requests)
            ck = _CLASS_KEY_INTERN.get(raw)
            if ck is None:
                if len(_CLASS_KEY_INTERN) > 200_000:
                    _CLASS_KEY_INTERN.clear()  # unbounded-workload backstop
                ck = ClassKey(raw)
                _CLASS_KEY_INTERN[raw] = ck
            self.__dict__["_gkey"] = ck
        return ck


class ClassKey:
    """A pod-class grouping key with a precomputed hash (see
    Pod.class_key).  Equal keys are the same object via the intern table,
    so __eq__ is an identity check first."""

    __slots__ = ("key", "_h")

    def __init__(self, key: Tuple):
        self.key = key
        self._h = hash(key)

    def __hash__(self) -> int:
        return self._h

    def __eq__(self, other) -> bool:
        return self is other or (
            isinstance(other, ClassKey) and self.key == other.key
        )


_CLASS_KEY_INTERN: Dict[Tuple, ClassKey] = {}


# ---------------------------------------------------------------------------
# InstanceType and offerings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Offering:
    """zone x capacity-type purchasing option (reference
    pkg/providers/instancetype/types.go:130-158)."""

    zone: str
    capacity_type: str
    price: float
    available: bool = True

    def requirements(self) -> Requirements:
        return Requirements(
            [
                Requirement(L.LABEL_ZONE, Op.IN, [self.zone]),
                Requirement(L.LABEL_CAPACITY_TYPE, Op.IN, [self.capacity_type]),
            ]
        )


class Offerings(list):
    """list[Offering] with the reference's query helpers
    (`Offerings.Available().Requirements(reqs).Cheapest()`,
    reference pkg/providers/instance/instance.go:396-400)."""

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def compatible(self, reqs: Requirements) -> "Offerings":
        out = Offerings()
        for o in self:
            zr = reqs.get(L.LABEL_ZONE)
            cr = reqs.get(L.LABEL_CAPACITY_TYPE)
            if zr is not None and not zr.has(o.zone):
                continue
            if cr is not None and not cr.has(o.capacity_type):
                continue
            out.append(o)
        return out

    def cheapest(self) -> Optional[Offering]:
        return min(self, key=lambda o: o.price, default=None)

    def zones(self) -> List[str]:
        return sorted({o.zone for o in self})


@dataclass(frozen=True)
class Overhead:
    """Node resource overhead; Allocatable = Capacity - sum(overheads)
    (reference pkg/providers/instancetype/types.go:326-416)."""

    kube_reserved: Resources = field(default_factory=Resources)
    system_reserved: Resources = field(default_factory=Resources)
    eviction_threshold: Resources = field(default_factory=Resources)

    def total(self) -> Resources:
        return self.kube_reserved + self.system_reserved + self.eviction_threshold


@dataclass
class InstanceType:
    """One launchable machine shape (reference
    pkg/providers/instancetype/types.go:52-67)."""

    name: str
    requirements: Requirements
    capacity: Resources
    overhead: Overhead = field(default_factory=Overhead)
    offerings: Offerings = field(default_factory=Offerings)

    def __setattr__(self, name, value):
        if name in ("capacity", "overhead"):
            self.__dict__.pop("_alloc", None)
        object.__setattr__(self, name, value)

    def allocatable(self) -> Resources:
        # memoized: the oracle's fit loop calls this per (pod, node, type)
        # probe; capacity/overhead reassignment invalidates (__setattr__)
        a = self.__dict__.get("_alloc")
        if a is None:
            self.__dict__["_alloc"] = a = (
                self.capacity - self.overhead.total()
            ).clamp_nonnegative()
        return a

    def cheapest_price(self, reqs: Optional[Requirements] = None) -> float:
        offs = self.offerings.available()
        if reqs is not None:
            offs = offs.compatible(reqs)
        o = offs.cheapest()
        return o.price if o is not None else float("inf")

    def __repr__(self) -> str:
        return f"InstanceType({self.name})"


# ---------------------------------------------------------------------------
# NodePool (the provisioner) and NodeClaim
# ---------------------------------------------------------------------------


@dataclass
class Disruption:
    """NodePool disruption policy (karpenter-core v1beta1 NodePool.spec.disruption;
    semantics per reference website v0.31 concepts/deprovisioning.md)."""

    consolidation_policy: str = "WhenUnderutilized"  # or WhenEmpty
    consolidate_after: Optional[float] = None  # seconds; None = immediately
    expire_after: Optional[float] = None  # seconds; None = never
    budgets: List[str] = field(default_factory=list)  # e.g. ["10%", "5"]


@dataclass
class NodePool:
    name: str
    weight: int = 0  # higher first (designs/provisioner-priority.md)
    requirements: Requirements = field(default_factory=Requirements)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    limits: Resources = field(default_factory=Resources)  # empty = unlimited
    disruption: Disruption = field(default_factory=Disruption)
    node_class_ref: str = ""
    kubelet_max_pods: Optional[int] = None
    # dynamic pod density: pods capacity = min(maxPods/ENI limit,
    # podsPerCore x vCPUs) (reference pod-density.md:43)
    kubelet_pods_per_core: Optional[int] = None
    # kubeletConfiguration overrides (reference provisioner.spec.
    # kubeletConfiguration -> types.go:326-399): keys present here REPLACE
    # the computed defaults per resource; absent keys keep the curve
    kubelet_kube_reserved: Optional[Resources] = None
    kubelet_system_reserved: Optional[Resources] = None
    kubelet_eviction_hard: Optional[Resources] = None
    deleted: bool = False

    def __setattr__(self, name, value):
        # mutation epoch for the solver's compile cache: identity-based
        # keys (the catalog cache convention) can't see an in-place field
        # poke like `pool.weight = 5`, so every reassignment bumps the
        # epoch and the (id, epoch) pair keys stay sound.
        self.__dict__["_mut"] = self.__dict__.get("_mut", 0) + 1
        object.__setattr__(self, name, value)

    def mutation_epoch(self) -> int:
        return self.__dict__.get("_mut", 0)

    def template_requirements(self) -> Requirements:
        reqs = Requirements.from_labels(self.labels)
        reqs = reqs.union(self.requirements)
        reqs.add(Requirement(L.LABEL_NODEPOOL, Op.IN, [self.name]))
        return reqs


class NodeClaimCondition:
    LAUNCHED = "Launched"
    REGISTERED = "Registered"
    INITIALIZED = "Initialized"
    EMPTY = "Empty"
    EXPIRED = "Expired"
    DRIFTED = "Drifted"


_claim_seq = itertools.count()


@dataclass
class NodeClaim:
    """Desired-machine handshake object: core hands this down, the cloud
    provider launches and fills in status (reference
    pkg/cloudprovider/cloudprovider.go:94-120,348-383)."""

    name: str = ""
    pool_name: str = ""
    node_class_ref: str = ""
    requirements: Requirements = field(default_factory=Requirements)
    requests: Resources = field(default_factory=Resources)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    kubelet_max_pods: Optional[int] = None
    # status
    provider_id: str = ""
    instance_type_name: str = ""
    zone: str = ""
    capacity_type: str = ""
    image_id: str = ""
    price: float = 0.0
    capacity: Resources = field(default_factory=Resources)
    allocatable: Resources = field(default_factory=Resources)
    conditions: Dict[str, bool] = field(default_factory=dict)
    created_at: float = 0.0
    deleted_at: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            self.name = f"nodeclaim-{next(_claim_seq)}"

    def set_condition(self, cond: str, value: bool = True) -> None:
        self.conditions[cond] = value

    def has_condition(self, cond: str) -> bool:
        return self.conditions.get(cond, False)

    @property
    def launched(self) -> bool:
        return self.has_condition(NodeClaimCondition.LAUNCHED)

    @property
    def registered(self) -> bool:
        return self.has_condition(NodeClaimCondition.REGISTERED)

    @property
    def initialized(self) -> bool:
        return self.has_condition(NodeClaimCondition.INITIALIZED)


# ---------------------------------------------------------------------------
# NodeClass (provider-specific; analogous to EC2NodeClass)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SelectorTerm:
    """Tag/id selector term (reference pkg/apis/v1beta1/ec2nodeclass.go
    subnet/SG/AMI selector terms): OR-ed terms, AND-ed tag matches."""

    tags: Tuple[Tuple[str, str], ...] = ()
    id: str = ""
    name: str = ""

    @classmethod
    def of(cls, id: str = "", name: str = "", **tags: str) -> "SelectorTerm":
        return cls(tags=tuple(sorted(tags.items())), id=id, name=name)

    def matches(self, obj_id: str, obj_name: str, obj_tags: Mapping[str, str]) -> bool:
        if self.id:
            return self.id == obj_id
        if self.name and self.name != obj_name:
            return False
        return all(
            (k in obj_tags) if v == "*" else obj_tags.get(k) == v
            for k, v in self.tags
        )


@dataclass(frozen=True)
class BlockDeviceMapping:
    device_name: str = "/dev/xvda"
    volume_size: float = 20 * 2**30
    volume_type: str = "gp3"
    encrypted: bool = True
    delete_on_termination: bool = True


@dataclass
class NodeClass:
    """Provider-side machine class (image family, networking, storage).

    Analogous to EC2NodeClass (reference pkg/apis/v1beta1/ec2nodeclass.go:
    28-107): selector terms resolve against the cloud inventory into status,
    and the hash of the launch-relevant spec drives drift detection
    (reference pkg/cloudprovider/drift.go:136-152).
    """

    name: str
    subnet_selector_terms: List[SelectorTerm] = field(default_factory=list)
    security_group_selector_terms: List[SelectorTerm] = field(default_factory=list)
    image_selector_terms: List[SelectorTerm] = field(default_factory=list)
    image_family: str = "standard"  # standard | accelerated | custom
    # static launch-template passthrough: when set, template resolution is
    # bypassed and this user-owned template launches as-is (reference
    # launchtemplate.go:104-107)
    launch_template_name: str = ""
    user_data: str = ""
    role: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    block_device_mappings: List[BlockDeviceMapping] = field(default_factory=list)
    detailed_monitoring: bool = False
    metadata_options: Dict[str, str] = field(default_factory=dict)
    # status (resolved by the nodeclass controller)
    resolved_subnets: List[str] = field(default_factory=list)
    resolved_security_groups: List[str] = field(default_factory=list)
    resolved_images: List[str] = field(default_factory=list)
    resolved_instance_profile: str = ""
    deleted: bool = False

    def static_hash(self) -> str:
        """Hash of launch-relevant spec fields for drift detection
        (reference drift.go:136-152: NodeClass(Template)Drift)."""
        spec = {
            "image_family": self.image_family,
            "launch_template_name": self.launch_template_name,
            "user_data": self.user_data,
            "role": self.role,
            "tags": sorted(self.tags.items()),
            "bdm": [dataclasses.astuple(b) for b in self.block_device_mappings],
            "detailed_monitoring": self.detailed_monitoring,
            "metadata_options": sorted(self.metadata_options.items()),
        }
        return hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[
            :16
        ]


@dataclass
class StorageClass:
    """Zonal storage topology (reference website v0.31
    concepts/scheduling.md:387-411: a StorageClass's allowedTopologies +
    volumeBindingMode constrain where a consuming pod's node may land)."""

    name: str
    zones: Tuple[str, ...] = ()  # allowedTopologies; empty = any zone
    binding_mode: str = "WaitForFirstConsumer"  # or "Immediate"


@dataclass
class PersistentVolumeClaim:
    """The scheduling-relevant projection of a PVC: which storage class
    provisions it and, once provisioned, which zone the volume lives in."""

    name: str
    namespace: str = "default"
    storage_class: str = ""
    bound_zone: str = ""  # set when the volume provisions / first consumer binds

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"
