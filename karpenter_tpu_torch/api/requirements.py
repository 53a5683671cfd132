"""Label-requirement algebra: the scheduling constraint language.

Re-creation of karpenter-core's ``scheduling.Requirements`` as observed
through the reference's usage (pkg/cloudprovider/cloudprovider.go:301-306,
pkg/providers/instance/instance.go:377-389): a map label-key -> set algebra
supporting In/NotIn/Exists/DoesNotExist/Gt/Lt, with `Intersects` /
`Compatible` semantics, defaulting (reference
pkg/apis/v1alpha5/provisioner.go:44-60) and the node-selector ->
requirements conversion.

Representation: each Requirement normalizes to
  (complement=False, values)  -- an allow-list  ("In")
  (complement=True,  values)  -- a deny-list    ("NotIn"; Exists = empty deny)
plus optional numeric bounds (greater_than / less_than) which only constrain
keys whose values parse as numbers.  ``DoesNotExist`` is the empty allow-list.
Absent labels match NotIn / DoesNotExist (standard Kubernetes nodeAffinity
semantics) and fail In / Exists / Gt / Lt.

Port copy of ``karpenter_tpu/api/requirements.py``.
"""

from __future__ import annotations

import enum
from typing import Dict, FrozenSet, Iterable, Iterator, Mapping, Optional, Tuple


class Op(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


class Requirement:
    """One key's constraint in normalized set form.

    ``absent_ok`` records whether a node *lacking* the label satisfies the
    requirement — it distinguishes DoesNotExist (empty allow-list,
    absent_ok=True) from an unsatisfiable In-conjunction (empty allow-list,
    absent_ok=False), and NotIn (absent_ok=True) from Exists
    (absent_ok=False).  Standard Kubernetes nodeAffinity semantics.
    """

    __slots__ = (
        "key",
        "complement",
        "values",
        "greater_than",
        "less_than",
        "min_values",
        "absent_ok",
    )

    def __init__(
        self,
        key: str,
        op: Op | str = Op.EXISTS,
        values: Iterable[str] = (),
        min_values: Optional[int] = None,
    ):
        op = Op(op)
        self.key = key
        self.greater_than: Optional[float] = None
        self.less_than: Optional[float] = None
        self.min_values = min_values
        vals = frozenset(str(v) for v in values)
        if op is Op.IN:
            self.complement, self.values, self.absent_ok = False, vals, False
        elif op is Op.NOT_IN:
            self.complement, self.values, self.absent_ok = True, vals, True
        elif op is Op.EXISTS:
            self.complement, self.values, self.absent_ok = True, frozenset(), False
        elif op is Op.DOES_NOT_EXIST:
            self.complement, self.values, self.absent_ok = False, frozenset(), True
        elif op is Op.GT:
            (v,) = vals
            self.complement, self.values, self.absent_ok = True, frozenset(), False
            self.greater_than = float(v)
        elif op is Op.LT:
            (v,) = vals
            self.complement, self.values, self.absent_ok = True, frozenset(), False
            self.less_than = float(v)

    # -- constructors --------------------------------------------------------
    @classmethod
    def _raw(
        cls,
        key: str,
        complement: bool,
        values: FrozenSet[str],
        gt: Optional[float],
        lt: Optional[float],
        min_values: Optional[int] = None,
        absent_ok: bool = False,
    ) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = values
        r.greater_than = gt
        r.less_than = lt
        r.min_values = min_values
        r.absent_ok = absent_ok
        return r

    # -- predicates ----------------------------------------------------------
    def _bounds_admit(self, value: str) -> bool:
        if self.greater_than is None and self.less_than is None:
            return True
        if not _is_number(value):
            return False
        v = float(value)
        if self.greater_than is not None and not v > self.greater_than:
            return False
        if self.less_than is not None and not v < self.less_than:
            return False
        return True

    def has(self, value: str) -> bool:
        value = str(value)
        if not self._bounds_admit(value):
            return False
        return (value not in self.values) if self.complement else (value in self.values)

    def allows_absent(self) -> bool:
        """Whether a node lacking this label satisfies the requirement.

        NotIn/DoesNotExist match absent labels (k8s nodeAffinity semantics);
        In/Exists/Gt/Lt require the label to exist.
        """
        return self.absent_ok

    def is_exists(self) -> bool:
        return (
            self.complement
            and not self.values
            and self.greater_than is None
            and self.less_than is None
        )

    def _bounds_empty(self) -> bool:
        """No real value can satisfy both Gt and Lt bounds."""
        return (
            self.greater_than is not None
            and self.less_than is not None
            and self.less_than <= self.greater_than
        )

    def intersects(self, other: "Requirement") -> bool:
        """Whether any label value satisfies both requirements."""
        merged = self.intersection(other)
        if merged.complement:
            # complement of a finite set is nonempty unless the numeric
            # bounds contradict (e.g. Gt 5 ∧ Lt 3)
            return not merged._bounds_empty()
        if not merged.values:
            return False
        return any(merged._bounds_admit(v) for v in merged.values)

    def intersection(self, other: "Requirement") -> "Requirement":
        gt = max(
            (x for x in (self.greater_than, other.greater_than) if x is not None),
            default=None,
        )
        lt = min(
            (x for x in (self.less_than, other.less_than) if x is not None),
            default=None,
        )
        mv = max(
            (x for x in (self.min_values, other.min_values) if x is not None),
            default=None,
        )
        ao = self.absent_ok and other.absent_ok
        if self.complement and other.complement:
            return Requirement._raw(
                self.key, True, self.values | other.values, gt, lt, mv, ao
            )
        if self.complement:
            vals = frozenset(v for v in other.values if v not in self.values)
            return Requirement._raw(self.key, False, vals, gt, lt, mv, ao)
        if other.complement:
            vals = frozenset(v for v in self.values if v not in other.values)
            return Requirement._raw(self.key, False, vals, gt, lt, mv, ao)
        return Requirement._raw(
            self.key, False, self.values & other.values, gt, lt, mv, ao
        )

    def any_value(self) -> Optional[str]:
        """A representative allowed value (None if complement/unbounded)."""
        if self.complement:
            return None
        for v in sorted(self.values):
            if self._bounds_admit(v):
                return v
        return None

    def single_value(self) -> Optional[str]:
        """The value iff exactly one is admitted (determinate requirement);
        None otherwise.  Only determinate keys may project to node labels
        (reference pkg/scheduling/requirements.go Labels())."""
        if self.complement:
            return None
        admitted = [v for v in self.values if self._bounds_admit(v)]
        if len(admitted) == 1:
            return admitted[0]
        return None

    # -- plumbing ------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Requirement)
            and self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
            and self.min_values == other.min_values
            and self.absent_ok == other.absent_ok
        )

    def __hash__(self) -> int:
        return hash(
            (
                self.key,
                self.complement,
                self.values,
                self.greater_than,
                self.less_than,
                self.min_values,
                self.absent_ok,
            )
        )

    def __repr__(self) -> str:
        if self.greater_than is not None or self.less_than is not None:
            bounds = []
            if self.greater_than is not None:
                bounds.append(f">{self.greater_than:g}")
            if self.less_than is not None:
                bounds.append(f"<{self.less_than:g}")
            return f"Requirement({self.key} {' '.join(bounds)})"
        if self.complement:
            if not self.values:
                return f"Requirement({self.key} Exists)"
            return f"Requirement({self.key} NotIn {sorted(self.values)})"
        if not self.values:
            return f"Requirement({self.key} DoesNotExist)"
        return f"Requirement({self.key} In {sorted(self.values)})"


class Requirements:
    """A conjunction of per-key requirements with karpenter-core semantics."""

    __slots__ = ("_reqs",)

    def __init__(self, reqs: Iterable[Requirement] = ()):
        self._reqs: Dict[str, Requirement] = {}
        for r in reqs:
            self.add(r)

    @classmethod
    def from_labels(cls, labels: Mapping[str, str]) -> "Requirements":
        """Node labels / nodeSelector -> single-value In requirements."""
        return cls(Requirement(k, Op.IN, [v]) for k, v in labels.items())

    @classmethod
    def from_node_selector_terms(cls, exprs: Iterable[Mapping]) -> "Requirements":
        """matchExpressions dicts ({key, operator, values}) -> Requirements."""
        return cls(
            Requirement(e["key"], Op(e["operator"]), e.get("values", ()))
            for e in exprs
        )

    def add(self, req: Requirement) -> "Requirements":
        """Intersect `req` into the conjunction (karpenter scheduling.Requirements.Add)."""
        cur = self._reqs.get(req.key)
        self._reqs[req.key] = cur.intersection(req) if cur is not None else req
        return self

    def union(self, other: "Requirements") -> "Requirements":
        out = Requirements(self._reqs.values())
        for r in other:
            out.add(r)
        return out

    # -- accessors -----------------------------------------------------------
    def has(self, key: str) -> bool:
        return key in self._reqs

    def get(self, key: str) -> Optional[Requirement]:
        return self._reqs.get(key)

    def keys(self) -> Iterable[str]:
        return self._reqs.keys()

    def __iter__(self) -> Iterator[Requirement]:
        return iter(self._reqs.values())

    def __len__(self) -> int:
        return len(self._reqs)

    # -- semantics -----------------------------------------------------------
    def intersects(self, other: "Requirements") -> bool:
        """Symmetric overlap on shared keys (reference `Intersects`)."""
        for key, r in self._reqs.items():
            o = other.get(key)
            if o is not None and not r.intersects(o):
                return False
        return True

    def compatible(
        self, incoming: "Requirements", allow_undefined: bool = False
    ) -> bool:
        """Whether a node described by `self` can satisfy `incoming`.

        For every incoming requirement: if self defines the key, the sets
        must intersect; if self does not define the key, the incoming
        requirement must tolerate an absent label (NotIn/DoesNotExist).
        Mirrors the instance-type pre-filter at reference
        pkg/cloudprovider/cloudprovider.go:301-306.

        With ``allow_undefined`` (karpenter-core's
        AllowUndefinedWellKnownLabels mode, used when `self` is an instance
        type's requirements): undefined keys outside the catalog-label set
        are satisfiable anyway — they become node labels stamped by the
        NodePool rather than properties of the machine shape.
        """
        from karpenter_tpu_torch.api.labels import CATALOG_LABELS

        for key, inc in incoming._reqs.items():
            mine = self._reqs.get(key)
            if mine is None:
                if allow_undefined and key not in CATALOG_LABELS:
                    continue
                if not inc.allows_absent():
                    return False
            elif not mine.intersects(inc):
                return False
        return True

    def is_unsatisfiable(self) -> bool:
        """True iff some key's conjunction admits no value at all.

        An empty allow-list with values originally present (In ∩ In = ∅) is
        unsatisfiable; bare DoesNotExist (empty allow-list, satisfiable by
        absence) is not, because it still admits nodes lacking the label.
        Complement forms are unsatisfiable only via contradictory bounds.
        """
        for r in self._reqs.values():
            if r.complement:
                if r._bounds_empty():
                    return True
            elif not r.absent_ok and not any(r._bounds_admit(v) for v in r.values):
                return True
        return False

    def labels(self) -> Dict[str, str]:
        """Project DETERMINATE keys (exactly one admitted value) to labels.
        Multi-valued keys (e.g. a type offered in three zones) must not
        invent a label — the launched instance is authoritative for those."""
        out = {}
        for key, r in self._reqs.items():
            v = r.single_value()
            if v is not None:
                out[key] = v
        return out

    # -- plumbing ------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return isinstance(other, Requirements) and self._reqs == other._reqs

    def __hash__(self) -> int:
        return hash(frozenset(self._reqs.values()))

    def __repr__(self) -> str:
        return f"Requirements({sorted(self._reqs.values(), key=lambda r: r.key)})"
