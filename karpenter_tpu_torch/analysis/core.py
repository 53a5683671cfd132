"""Structured findings of the lock plane.

Port of `Finding` of ``karpenter_tpu/analysis/core.py``, the one piece of
the rule engine the runtime sanitizer (``sanitizer.py``) reads: its
findings are Finding-shaped, with the stable fingerprint (sha256 over
rule, file, message and occurrence, not the line) and the deterministic
ordering the witness artifact serializes.  The rule engine itself (the
parsed package snapshot, the registry, the baseline) is not ported
(ROADMAP A8b).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Finding:
    """One structured finding.  Ordering is (rule, file, line, message)
    so sorted finding lists — and therefore the JSON report — are
    deterministic.

    ``occurrence`` disambiguates IDENTICAL (rule, file, message)
    findings by line order — the runner stamps it — so baselining one
    known instance cannot silently suppress a new duplicate added
    later; the fingerprint still survives mere line drift."""

    rule: str
    file: str
    line: int
    message: str
    occurrence: int = 0

    @property
    def fingerprint(self) -> str:
        digest = hashlib.sha256(
            f"{self.rule}|{self.file}|{self.message}|{self.occurrence}"
            .encode()
        ).hexdigest()
        return digest[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"
