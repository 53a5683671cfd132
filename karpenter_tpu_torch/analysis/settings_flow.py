"""The settings-flow rule: every ``Settings`` field must actually FLOW.

The dead-twin-knob bug class (once caught by hand in review):
a field lands on the dataclass, gets validated, maybe even documented —
and is never read by any layer, or never exposed through the chart, so
operators "configure" a knob that changes nothing.  Machine-checked:

1. **read somewhere**: the field name is read as an attribute (or via a
   ``getattr`` string literal) somewhere in the package OUTSIDE
   api/settings.py itself (reads inside ``validate()`` don't make a
   knob live);
2. **chart-exposed**: the field appears in ``deploy/chart/values.yaml``
   under ``settings:`` AND in the configmap template, so the rendered
   ``settings.json`` can actually carry it (tests/test_deploy.py proves
   the rendered payload loads — this rule proves the key EXISTS to
   render).  A field may instead live under a STRUCTURED values block
   (the ``service.multiTenant.*`` shape): its configmap line then
   references ``.Values.<dotted>`` paths, and the rule resolves each
   against the values.yaml document — an unresolvable path is the same
   dead knob, just spelled nested.

Read detection is deliberately name-based and over-approximating: any
``x.field_name`` counts, whoever ``x`` is.  A false "read" keeps the
rule quiet, which is the safe failure direction for a doc-rot class of
check.  The allowlist names fields exempt from the READ requirement
(reference-parity knobs retained for config compatibility), each with
its argument in allowlists.py; chart presence is never exempt — an
accepted field costs one values.yaml line.

Synthetic trees without an ``api/settings.py`` (or without chart files)
skip the corresponding half — the teeth harness forges both.
"""

from __future__ import annotations

import ast
import re
from typing import List, Set

from karpenter_tpu_torch.analysis.core import (
    Finding,
    PackageSnapshot,
    Rule,
    register,
)

SETTINGS_REL = "api/settings.py"


def settings_fields(snap: PackageSnapshot) -> List[tuple]:
    """[(field name, line)] of the Settings dataclass, public fields
    only, declaration order."""
    info = next(
        (m for m in snap.in_package(SETTINGS_REL)), None
    )
    if info is None:
        return []
    out: List[tuple] = []
    for node in ast.walk(info.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Settings":
            for stmt in node.body:
                if (
                    isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and not stmt.target.id.startswith("_")
                ):
                    out.append((stmt.target.id, stmt.lineno))
    return out


def _attribute_reads(snap: PackageSnapshot) -> Set[str]:
    """Every attribute name read (or getattr'd by literal) anywhere in
    the package outside the settings module."""
    reads: Set[str] = set()
    for info in snap.in_package():
        if info.rel_in_pkg == SETTINGS_REL:
            continue
        for node in ast.walk(info.tree):
            if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load
            ):
                reads.add(node.attr)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "getattr"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                reads.add(node.args[1].value)
    return reads


_VALUES_REF = re.compile(r"\.Values\.([A-Za-z0-9_.]+)")


def _values_paths(values_text: str) -> Set[str]:
    """Every dotted path definable from values.yaml's mapping structure
    ("service.multiTenant.enabled", ...), by indentation walk — no YAML
    dependency, and forgiving of the teeth harness's forged snippets."""
    paths: Set[str] = set()
    stack: List[tuple] = []  # (indent, key)
    for line in values_text.splitlines():
        stripped = line.split("#", 1)[0].rstrip()
        m = re.match(r"^(\s*)([A-Za-z0-9_]+):", stripped)
        if not m:
            continue
        indent = len(m.group(1))
        while stack and stack[-1][0] >= indent:
            stack.pop()
        stack.append((indent, m.group(2)))
        paths.add(".".join(k for _, k in stack))
    return paths


def _configmap_refs_resolve(
    fname: str, configmap_text: str, values_paths: Set[str]
) -> bool:
    """True when the configmap line carrying ``"fname"`` references at
    least one ``.Values.`` path and every referenced path resolves in
    values.yaml — the nested-values exposure route."""
    for line in configmap_text.splitlines():
        if f'"{fname}"' not in line:
            continue
        refs = _VALUES_REF.findall(line)
        return bool(refs) and all(r in values_paths for r in refs)
    return False


def _settings_block(values_text: str) -> str:
    """The ``settings:`` mapping of values.yaml — keys are matched
    INSIDE this block only, so a Settings field named like some other
    chart key (``replicas``, ``port``) cannot satisfy the presence
    check by accident."""
    m = re.search(
        r"^settings:\s*\n((?:[ \t]+.*\n?|\n)*)", values_text, re.M
    )
    return m.group(1) if m else ""


@register
class SettingsFlowRule(Rule):
    """Every Settings field is read in the package and chart-exposed."""

    name = "settings-flow"
    title = "every Settings field read in-package and chart-exposed"
    guards = "no dead twin knobs (a configured setting always flows)"

    def check(self, snap, allowlist) -> List[Finding]:
        fields = settings_fields(snap)
        if not fields:
            return []
        reads = _attribute_reads(snap)
        full_values = snap.doc_text("deploy", "chart", "values.yaml")
        values_text = _settings_block(full_values)
        values_paths = _values_paths(full_values)
        configmap_text = snap.doc_text(
            "deploy", "chart", "templates", "configmap.yaml"
        )
        out: List[Finding] = []
        rel = f"{snap.package}/{SETTINGS_REL}"
        for fname, line in fields:
            if fname not in reads and fname not in allowlist:
                out.append(
                    self.finding(
                        rel, line,
                        f"Settings.{fname} is never read in the package "
                        "— a dead twin knob: configuring it changes "
                        "nothing.  Wire it or allowlist it with an "
                        "argument",
                    )
                )
            if (
                values_text
                and not re.search(
                    rf"^\s+{re.escape(fname)}:", values_text, re.M
                )
                and not _configmap_refs_resolve(
                    fname, configmap_text, values_paths
                )
            ):
                out.append(
                    self.finding(
                        rel, line,
                        f"Settings.{fname} missing from deploy/chart/"
                        "values.yaml — the chart cannot set it (neither "
                        "a settings: key nor a resolvable nested "
                        ".Values path in its configmap line)",
                    )
                )
            if configmap_text and f'"{fname}"' not in configmap_text:
                out.append(
                    self.finding(
                        rel, line,
                        f"Settings.{fname} missing from the configmap "
                        "template — the rendered settings.json cannot "
                        "carry it",
                    )
                )
        return out
