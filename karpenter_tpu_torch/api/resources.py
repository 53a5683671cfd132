"""Resource vectors with Kubernetes quantity parsing.

Replaces the reference's `v1.ResourceList` / `resource.Quantity` usage
(pkg/providers/instancetype/types.go:171-206).  Internally every quantity is
a float in canonical units: cpu in cores, memory/storage in bytes, counts as
plain numbers.  The dense-tensor scheduler consumes these via
`Resources.as_vector` so the canonical units must be stable.

Port copy of ``karpenter_tpu/api/resources.py``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Mapping, Tuple

_SUFFIX = {
    "n": 1e-9, "u": 1e-6,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_QTY_RE = re.compile(r"^([0-9]*\.?[0-9]+)\s*([A-Za-z]{0,2})$")


def parse_quantity(value) -> float:
    """Parse a Kubernetes-style quantity ('100m', '1Gi', 2, '1.5') to float."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if s.endswith("m") and s[:-1].replace(".", "", 1).isdigit():
        return float(s[:-1]) / 1000.0
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"unparseable quantity: {value!r}")
    num, suffix = m.groups()
    if suffix and suffix not in _SUFFIX:
        raise ValueError(f"unparseable quantity: {value!r}")
    return float(num) * (_SUFFIX[suffix] if suffix else 1.0)


def format_quantity(name: str, value: float) -> str:
    if name == "memory" or name == "ephemeral-storage":
        for suf in ("Gi", "Mi", "Ki"):
            if value >= _SUFFIX[suf] and value % _SUFFIX[suf] == 0:
                return f"{int(value // _SUFFIX[suf])}{suf}"
        return str(int(value))
    if value == int(value):
        return str(int(value))
    return f"{value:g}"


class Resources:
    """An immutable-ish resource vector (name -> canonical float quantity).

    Supports the arithmetic the scheduler needs: +, -, fits (<= on every
    axis present in self), max-merge, and projection to a dense vector.
    """

    __slots__ = ("_q",)

    def __init__(self, quantities: Mapping[str, object] | None = None, **kw):
        q: Dict[str, float] = {}
        if quantities:
            for k, v in quantities.items():
                q[k] = parse_quantity(v)
        for k, v in kw.items():
            q[k.replace("_", "-")] = parse_quantity(v)
        # explicit zeros are kept: `limits: {cpu: 0}` means "provision
        # nothing" (karpenter limits idiom), not "unlimited"
        self._q = q

    # -- accessors -----------------------------------------------------------
    def get(self, name: str, default: float = 0.0) -> float:
        return self._q.get(name, default)

    def keys(self) -> Iterable[str]:
        return self._q.keys()

    def items(self) -> Iterable[Tuple[str, float]]:
        return self._q.items()

    def is_zero(self) -> bool:
        return all(v == 0.0 for v in self._q.values())

    def is_empty(self) -> bool:
        """No axes at all — distinct from is_zero(): `limits: {cpu: 0}`
        has an axis (and means "provision nothing"), `limits: {}` has none
        (and means "unlimited")."""
        return not self._q

    @property
    def cpu(self) -> float:
        return self.get("cpu")

    @property
    def memory(self) -> float:
        return self.get("memory")

    # -- algebra -------------------------------------------------------------
    # results of arithmetic are already-parsed floats; routing them through
    # __init__'s quantity parsing would re-validate every entry (the oracle
    # fit loop does millions of these per large hybrid solve)
    @classmethod
    def _from_raw(cls, q: Dict[str, float]) -> "Resources":
        r = object.__new__(cls)
        r._q = q
        return r

    def __add__(self, other: "Resources") -> "Resources":
        q = dict(self._q)
        for k, v in other._q.items():
            q[k] = q.get(k, 0.0) + v
        return Resources._from_raw(q)

    def __sub__(self, other: "Resources") -> "Resources":
        q = dict(self._q)
        for k, v in other._q.items():
            q[k] = q.get(k, 0.0) - v
        return Resources._from_raw(q)

    def clamp_nonnegative(self) -> "Resources":
        return Resources._from_raw({k: max(v, 0.0) for k, v in self._q.items()})

    def scaled(self, factor: float) -> "Resources":
        return Resources._from_raw({k: v * factor for k, v in self._q.items()})

    def merge_max(self, other: "Resources") -> "Resources":
        q = dict(self._q)
        for k, v in other._q.items():
            q[k] = max(q.get(k, 0.0), v)
        return Resources._from_raw(q)

    def fits(self, capacity: "Resources", eps: float = 1e-9) -> bool:
        """True iff every requested axis is <= capacity on that axis.

        Mirrors the `resources.Fits` check the facade applies when
        pre-filtering instance types (reference
        pkg/cloudprovider/cloudprovider.go:302-306).
        """
        return all(v <= capacity.get(k) + eps for k, v in self._q.items())

    def exceeds(self, limit: "Resources", eps: float = 1e-9) -> bool:
        """True iff any axis present in `limit` is exceeded by self."""
        return any(self.get(k) > v + eps for k, v in limit._q.items())

    def as_vector(self, axes: Iterable[str]) -> Tuple[float, ...]:
        return tuple(self.get(a) for a in axes)

    # -- plumbing ------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return isinstance(other, Resources) and self._q == other._q

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._q.items())))

    def __bool__(self) -> bool:
        return not self.is_zero()

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k}={format_quantity(k, v)}" for k, v in sorted(self._q.items())
        )
        return f"Resources({inner})"

    def to_dict(self) -> Dict[str, float]:
        return dict(self._q)


ZERO = Resources()


def total(items: Iterable[Resources]) -> Resources:
    out = Resources()
    for r in items:
        out = out + r
    return out
