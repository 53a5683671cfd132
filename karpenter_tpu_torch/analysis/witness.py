"""The runtime concurrency witness artifact (docs/designs/static-analysis.md
§runtime sanitizer).

A witness is what a sanitized run (analysis/sanitizer.py) leaves behind:
the lock-order graph actually exercised, the blocking operations observed
under held locks, the Eraser-style lockset verdict per annotated shared
field, and the findings the run produced.  It is the DYNAMIC half of the
static lock model, so it follows the same artifact discipline Findings
do: JSON with sorted keys, no wall clock, no thread ids, no memory
addresses — two runs of the same seeded scenario serialize to identical
bytes — and a content fingerprint (sha256 over the canonical payload,
truncated like ``Finding.fingerprint``) so CI can diff witnesses the way
it diffs lint reports.

Cross-validation (:func:`cross_validate`) is the payoff: merging a
witness into the static order graph reports BOTH directions —

- a runtime edge the static analyzer never predicted is *static model
  incompleteness* (a finding: either the static model's resolution has a
  hole or a lock name drifted from its ``Class.attr`` identity);
- a static edge never exercised at runtime is a *coverage gap*
  (informational: the sanitized suites simply never drove that path).

Only edges whose BOTH endpoints live in the static model's order
universe (``LOCK_ORDER_LAYERS``-scoped lock attributes) participate:
runtime edges touching out-of-layer locks (a metrics registry lock, a
cache lock) are reported separately as ``unmodeled`` so they cannot
drown the signal in noise the static rule deliberately scopes out.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

WITNESS_VERSION = 1


@dataclass
class Witness:
    """One sanitized run's serialized evidence.  Every list is kept
    sorted by the producer (sanitizer.py) so ``dumps`` is deterministic."""

    scenario: str = ""
    # lock names ("Class.attr") ever acquired
    locks: List[str] = field(default_factory=list)
    # {"outer", "inner", "sites": [rel:qual, ...]}
    edges: List[dict] = field(default_factory=list)
    # {"op", "locks": [held names], "site", "allowed": bool}
    blocking: List[dict] = field(default_factory=list)
    # {"field", "state", "lockset": [...], "threads": n, "writers": n}
    fields: List[dict] = field(default_factory=list)
    # Finding.to_dict() records the run produced (empty on a clean run)
    findings: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "version": WITNESS_VERSION,
            "scenario": self.scenario,
            "locks": list(self.locks),
            "edges": list(self.edges),
            "blocking": list(self.blocking),
            "fields": list(self.fields),
            "findings": list(self.findings),
        }

    @property
    def fingerprint(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def dumps(self) -> str:
        """The canonical artifact bytes: payload plus its own
        fingerprint, sorted keys, trailing newline."""
        doc = self.to_dict()
        doc["fingerprint"] = self.fingerprint
        return json.dumps(doc, indent=2, sort_keys=True) + "\n"

    def dump(self, path) -> str:
        path = pathlib.Path(path)
        path.write_text(self.dumps())
        return str(path)

    def edge_pairs(self) -> FrozenSet[Tuple[str, str]]:
        return frozenset((e["outer"], e["inner"]) for e in self.edges)

    @classmethod
    def from_dict(cls, doc: dict) -> "Witness":
        if doc.get("version") != WITNESS_VERSION:
            raise ValueError(
                f"witness version {doc.get('version')!r} != "
                f"{WITNESS_VERSION} (not a witness artifact, or a "
                "format this build does not read)"
            )
        return cls(
            scenario=doc.get("scenario", ""),
            locks=list(doc.get("locks", ())),
            edges=list(doc.get("edges", ())),
            blocking=list(doc.get("blocking", ())),
            fields=list(doc.get("fields", ())),
            findings=list(doc.get("findings", ())),
        )

    @classmethod
    def loads(cls, text: str) -> "Witness":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path) -> "Witness":
        return cls.loads(pathlib.Path(path).read_text())


@dataclass
class CrossValidation:
    """The static<->dynamic merge verdict for one witness."""

    # runtime edges the static model never predicted, minus the
    # allowlist — each is a finding (static model incompleteness)
    missing_static: List[dict] = field(default_factory=list)
    # static edges never exercised by this witness — informational
    # coverage gaps, never findings (a short scenario proves nothing
    # about paths it does not drive)
    unexercised_static: List[str] = field(default_factory=list)
    # runtime edges with an endpoint outside the static order universe —
    # out of the static rule's deliberate scope, listed for visibility
    unmodeled: List[dict] = field(default_factory=list)
    # runtime edges the static model also predicts (the agreement set)
    confirmed: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.missing_static

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "confirmed": list(self.confirmed),
            "missing_static": list(self.missing_static),
            "unexercised_static": list(self.unexercised_static),
            "unmodeled": list(self.unmodeled),
        }


def _pair_id(outer: str, inner: str) -> str:
    return f"{outer}|{inner}"


def cross_validate(
    witness: Witness,
    static_edges: FrozenSet[Tuple[str, str]],
    universe: FrozenSet[str],
    allowlist: Optional[Sequence[str]] = None,
) -> CrossValidation:
    """Merge a witness's runtime lock-order edges into the static order
    graph.  ``static_edges`` and ``universe`` come from
    :func:`karpenter_tpu_torch.analysis.locks.static_order_edges`;
    ``allowlist`` entries are ``"outer|inner"`` pair ids
    (allowlists.WITNESS_EDGES) sanctioning a runtime-only edge with a
    written argument."""
    allowed = frozenset(allowlist or ())
    out = CrossValidation()
    sites_by_pair: Dict[Tuple[str, str], List[str]] = {
        (e["outer"], e["inner"]): list(e.get("sites", ()))
        for e in witness.edges
    }
    for (outer, inner) in sorted(sites_by_pair):
        pair = _pair_id(outer, inner)
        entry = {
            "outer": outer,
            "inner": inner,
            "sites": sites_by_pair[(outer, inner)],
        }
        if outer not in universe or inner not in universe:
            out.unmodeled.append(entry)
        elif (outer, inner) in static_edges:
            out.confirmed.append(pair)
        elif pair not in allowed:
            out.missing_static.append(entry)
    runtime = witness.edge_pairs()
    out.unexercised_static = sorted(
        _pair_id(a, b) for (a, b) in static_edges if (a, b) not in runtime
    )
    return out
