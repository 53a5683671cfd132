"""Rule engine: parsed-package snapshot, rule registry, findings.

The engine is deliberately import-light: a snapshot is pure ``ast`` over
the package's source files (no module execution), so most rules run in
milliseconds and the CLI can lint a tree that does not even import.  The
two runtime rules (import-clean, annotations-resolve) import the package
explicitly and say so.

Findings carry a stable fingerprint — sha256 over (rule, file, message),
deliberately excluding the line number — so a baseline survives unrelated
line drift and the ``--json`` output diffs deterministically in CI.
"""

from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import time
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BASELINE_NAME = "baseline.json"


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


@dataclass
class ModuleInfo:
    """One parsed source file of the snapshot."""

    rel: str  # repo-relative posix path ("karpenter_tpu_torch/pipeline.py")
    name: str  # dotted module name ("karpenter_tpu_torch.pipeline")
    path: pathlib.Path
    source: str
    tree: ast.Module

    @property
    def rel_in_pkg(self) -> str:
        """Path relative to the package directory ("pipeline.py",
        "service/store_server.py") — what scope predicates match on, so
        synthetic test trees with a different package name still scope
        identically."""
        return self.rel.partition("/")[2]


class PackageSnapshot:
    """Parsed-AST view of one package directory.

    ``root`` is the package directory; ``repo_root`` is its parent (doc
    files are resolved against it, and ``rel`` paths are repo-relative
    to match the historical allowlist entries).  A file that fails to
    parse becomes a ``parse`` finding instead of aborting the snapshot —
    the engine must be able to report on a broken tree.
    """

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.repo_root = self.root.parent
        self.package = self.root.name
        self.modules: Dict[str, ModuleInfo] = {}
        self.parse_errors: List[Finding] = []
        for path in sorted(self.root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(self.repo_root).as_posix()
            source = path.read_text()
            try:
                tree = ast.parse(source)
            except SyntaxError as exc:
                self.parse_errors.append(
                    Finding(
                        rule="parse",
                        file=rel,
                        line=exc.lineno or 1,
                        message=f"syntax error: {exc.msg}",
                    )
                )
                continue
            name = rel[: -len(".py")].replace("/", ".")
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            self.modules[rel] = ModuleInfo(
                rel=rel, name=name, path=path, source=source, tree=tree
            )

    @classmethod
    def load(cls, root: Optional[pathlib.Path] = None) -> "PackageSnapshot":
        if root is None:
            import karpenter_tpu_torch

            root = pathlib.Path(karpenter_tpu_torch.__path__[0])
        return cls(pathlib.Path(root))

    def module_names(self) -> List[str]:
        return sorted(m.name for m in self.modules.values())

    def in_package(self, *rel_in_pkg: str):
        """Modules whose package-relative path starts with any given
        prefix (e.g. ``in_package("controllers/")``); no args = all."""
        for rel in sorted(self.modules):
            info = self.modules[rel]
            if not rel_in_pkg or any(
                info.rel_in_pkg == p or info.rel_in_pkg.startswith(p)
                for p in rel_in_pkg
            ):
                yield info

    def doc_text(self, *parts: str) -> str:
        """A repo doc file's text, empty when absent (synthetic trees)."""
        path = self.repo_root.joinpath(*parts)
        return path.read_text() if path.exists() else ""


class Rule:
    """Base class: subclasses register with :func:`register` and
    implement ``check``.  ``allowlist`` is the rule's entry from the ONE
    declarative table (allowlists.py) — its element type is rule-defined
    (rel paths, ``(rel, qualname)`` tuples, lock-pair ids, ...)."""

    name: str = ""
    title: str = ""  # one-line catalog entry
    guards: str = ""  # the guarantee this rule protects

    def check(
        self, snap: PackageSnapshot, allowlist: frozenset
    ) -> List[Finding]:
        raise NotImplementedError

    def finding(self, rel: str, line: int, message: str) -> Finding:
        return Finding(rule=self.name, file=rel, line=line, message=message)


RULES: Dict[str, type] = {}


def register(cls):
    assert cls.name and cls.name not in RULES, cls
    RULES[cls.name] = cls
    return cls


class ScopedVisitor(ast.NodeVisitor):
    """Shared visitor: tracks the class/function scope stack and the
    lexical loop depth — the qualified-name + in-loop machinery every
    call-site rule shares.  Subclasses override ``on_call``."""

    def __init__(self):
        self.scope: List[str] = []
        self.loops = 0

    @property
    def qual(self) -> str:
        return ".".join(self.scope)

    def _scoped(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_ClassDef = _scoped
    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped

    def _loop(self, node):
        self.loops += 1
        self.generic_visit(node)
        self.loops -= 1

    visit_For = visit_While = visit_AsyncFor = _loop

    def visit_Call(self, node):
        self.on_call(node)
        self.generic_visit(node)

    def on_call(self, node: ast.Call) -> None:  # pragma: no cover
        pass


def call_name(node: ast.Call) -> Optional[str]:
    """The called name for bare (``f(...)``) and attribute
    (``x.f(...)``) call forms."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


# --------------------------------------------------------------- baseline
def load_baseline(path: Optional[pathlib.Path]) -> Dict[str, str]:
    """fingerprint -> note.  Missing file = empty baseline."""
    if path is None or not pathlib.Path(path).exists():
        return {}
    data = json.loads(pathlib.Path(path).read_text())
    return {
        entry["fingerprint"]: entry.get("note", "")
        for entry in data.get("suppressions", [])
    }


def default_baseline_path(snap: PackageSnapshot) -> pathlib.Path:
    return snap.root / "analysis" / BASELINE_NAME


# ------------------------------------------------------------------ runner
def run_rules(
    snap: PackageSnapshot,
    rule_names: Optional[Sequence[str]] = None,
    allowlists: Optional[Dict[str, frozenset]] = None,
    baseline: Optional[Dict[str, str]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Run the selected rules (default: all registered) and split the
    sorted findings into (live, baselined).  ``timings`` — when a dict
    is passed — receives per-rule wall seconds (the ``--profile``
    surface; never part of the deterministic JSON)."""
    from karpenter_tpu_torch.analysis import load_rules

    load_rules()  # the registry must be complete, however we were imported
    if allowlists is None:
        from karpenter_tpu_torch.analysis.allowlists import ALLOWLISTS

        allowlists = ALLOWLISTS
    baseline = baseline or {}
    all_rules = rule_names is None or not rule_names
    names = list(rule_names) if rule_names else sorted(RULES)
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)}")
    if timings is not None and any(
        n in ("lock-blocking", "lock-order") for n in names
    ):
        # --profile attribution fix: the lock rules share ONE memoized
        # region scan (locks.region_scan), so whichever rule ran first
        # used to absorb the whole scan's wall time and the others read
        # as free — profile numbers did not reflect real cost.  Warm the
        # shared scan OUTSIDE the per-rule timers and report it as its
        # own line; per-rule numbers are then each rule's marginal cost.
        from karpenter_tpu_torch.analysis.locks import region_scan

        t0 = time.perf_counter()
        region_scan(snap).scan_regions()
        timings["shared-scan"] = time.perf_counter() - t0
    findings: List[Finding] = list(snap.parse_errors)
    for name in names:
        rule = RULES[name]()
        t0 = time.perf_counter()
        findings.extend(
            rule.check(snap, frozenset(allowlists.get(name, frozenset())))
        )
        if timings is not None:
            timings[name] = time.perf_counter() - t0
    findings.sort()
    # stamp occurrence indexes (line order) onto identical
    # (rule, file, message) findings so their fingerprints differ
    counts: Dict[Tuple[str, str, str], int] = {}
    stamped: List[Finding] = []
    for f in findings:
        key = (f.rule, f.file, f.message)
        n = counts.get(key, 0)
        counts[key] = n + 1
        stamped.append(replace(f, occurrence=n) if n else f)
    findings = stamped
    if baseline and all_rules:
        # stale-baseline hygiene: a suppression whose fingerprint matches
        # no current finding is itself a finding — otherwise a fixed
        # violation's entry rots silently (and keeps reviewers trusting a
        # suppression list that no longer suppresses anything).  Checked
        # against the occurrence-stamped fingerprints (what baselines
        # store), and only when the FULL rule set ran: a --rule subset
        # cannot judge entries owned by rules it did not run.
        matched = {f.fingerprint for f in findings}
        stale = [
            Finding(
                rule="stale-baseline",
                file=f"{snap.package}/analysis/{BASELINE_NAME}",
                line=1,
                message=(
                    f"baseline entry {fp} ({baseline[fp] or 'no note'}) "
                    "matches no current finding — the suppressed "
                    "violation is gone; delete the entry"
                ),
            )
            for fp in sorted(baseline)
            if fp not in matched
        ]
        if stale:
            findings = sorted(findings + stale)
    live = [f for f in findings if f.fingerprint not in baseline]
    suppressed = [f for f in findings if f.fingerprint in baseline]
    return live, suppressed


def to_report(
    snap: PackageSnapshot,
    live: Iterable[Finding],
    suppressed: Iterable[Finding],
    rule_names: Sequence[str],
    timings: Optional[Dict[str, float]] = None,
) -> dict:
    """The stable ``--json`` schema: versioned, keys sorted by the
    emitter, finding lists pre-sorted.  ``timings`` appears only under
    ``--profile`` (wall clock is deliberately not in the default,
    CI-diffable report)."""
    live, suppressed = sorted(live), sorted(suppressed)
    report = {
        "version": 1,
        "package": snap.package,
        "rules": sorted(rule_names),
        "counts": {
            "findings": len(live),
            "baselined": len(suppressed),
        },
        "findings": [f.to_dict() for f in live],
        "baselined": [f.to_dict() for f in suppressed],
    }
    if timings is not None:
        report["timings_s"] = {
            name: round(dt, 6) for name, dt in sorted(timings.items())
        }
    return report
