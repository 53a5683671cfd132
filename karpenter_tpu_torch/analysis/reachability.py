"""Determinism-reachability analyzer.

The repo's byte-compared surfaces — per-tick sim trace digests, ledger
``led`` lines, the SLO report, and the pipelined twin-run adoption seam
— promise that two runs of equal seed produce identical bytes.  The
legacy wall-clock rule fences ``time.time`` at file granularity; this
rule upgrades it to CALL-GRAPH reachability over tainted SOURCES:

- wall clock (``time.time``/``time_ns``, ``datetime.now/utcnow/today``),
- the unseeded module-level ``random.*`` API (seeded ``random.Random(s)``
  instances are the sanctioned way to be random),
- ambient process state: ``os.environ`` / ``os.getenv``, ``os.urandom``,
  ``uuid.uuid1/uuid4``,
- iteration DIRECTLY over a set (``for x in {...}`` / ``for x in
  set(...)``) — id-order iteration feeding ordered output.

A finding means: some function reachable from a byte-compared root
contains a tainted source and is not on the sanctioned-sink list.  The
sanctioned sinks (allowlists.py) are the deliberate exceptions with the
argument for each — e.g. ``utils/clock.py`` IS the wall clock, and
determinism holds because the simulator injects a FakeClock there (the
replay tests prove it byte-for-byte).

Roots are declared in allowlists.DETERMINISM_ROOTS; a root that no
longer resolves is itself a finding, so a refactor cannot silently drop
a surface out of coverage.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.analysis.core import (
    Finding,
    PackageSnapshot,
    Rule,
    register,
)
from karpenter_tpu_torch.analysis.graph import call_graph

_WALL = {"time": {"time", "time_ns"}, "datetime": {"now", "utcnow", "today"}}
_RANDOM_FNS = frozenset(
    {
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "gauss", "betavariate", "expovariate",
        "getrandbits", "normalvariate", "triangular", "vonmisesvariate",
        "seed",
    }
)


def _classify(mod: str, attr: str) -> Optional[str]:
    """Taint description for a call of ``mod.attr``, or None."""
    if mod == "time" and attr in _WALL["time"]:
        return f"wall clock time.{attr}()"
    if mod in ("datetime", "date") and attr in _WALL["datetime"]:
        return f"wall clock {mod}.{attr}()"
    if mod == "random" and attr in _RANDOM_FNS:
        return f"unseeded global random.{attr}()"
    if mod == "os" and attr in ("getenv", "urandom"):
        return f"ambient os.{attr}()"
    if mod == "uuid" and attr in ("uuid1", "uuid4"):
        return f"nondeterministic uuid.{attr}()"
    return None


_TAINT_MODULES = frozenset({"time", "datetime", "date", "random", "os",
                            "uuid"})


def stdlib_aliases(
    tree: ast.Module,
) -> Tuple[Dict[str, str], Dict[str, Tuple[str, str]]]:
    """(module aliases, from-imported names) for the taint-relevant
    stdlib modules: ``import time as _time`` must not hide the wall
    clock, and neither must ``from time import time`` (a BARE call the
    attribute matcher would never see)."""
    aliases: Dict[str, str] = {}
    from_names: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in _TAINT_MODULES:
                    aliases[alias.asname or alias.name] = alias.name
                # `import datetime` exposes datetime.datetime.now();
                # map the submodule-style alias too
        elif isinstance(node, ast.ImportFrom) and node.module in (
            _TAINT_MODULES
        ):
            for alias in node.names:
                from_names[alias.asname or alias.name] = (
                    node.module, alias.name,
                )
                # `from datetime import datetime/date` behaves like a
                # module alias for the .now()/.today() matcher
                if node.module == "datetime" and alias.name in (
                    "datetime", "date",
                ):
                    aliases[alias.asname or alias.name] = alias.name
    return aliases, from_names


def taint_sources(
    node: ast.AST,
    aliases: Optional[Dict[str, str]] = None,
    from_names: Optional[Dict[str, Tuple[str, str]]] = None,
) -> List[Tuple[int, str]]:
    """(line, description) for every tainted source in a def body."""
    aliases = aliases or {}
    from_names = from_names or {}
    out: List[Tuple[int, str]] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Name) and f.id in from_names:
                mod, attr = from_names[f.id]
                what = _classify(mod, attr)
                if what:
                    out.append((sub.lineno, what))
            elif isinstance(f, ast.Attribute):
                base = None
                if isinstance(f.value, ast.Name):
                    base = aliases.get(f.value.id, f.value.id)
                elif isinstance(f.value, ast.Attribute):
                    # dotted chains: datetime.datetime.now(),
                    # datetime.date.today()
                    tail = f.value.attr
                    if tail in ("datetime", "date"):
                        base = tail
                if base is not None:
                    what = _classify(base, f.attr)
                    if what:
                        out.append((sub.lineno, what))
        elif isinstance(sub, ast.Attribute):
            if (
                isinstance(sub.value, ast.Name)
                and aliases.get(sub.value.id, sub.value.id) == "os"
                and sub.attr == "environ"
            ):
                out.append((sub.lineno, "ambient os.environ"))
        elif isinstance(sub, ast.Name) and from_names.get(sub.id) == (
            "os", "environ",
        ):
            out.append((sub.lineno, "ambient os.environ"))
        elif isinstance(sub, (ast.For, ast.AsyncFor)):
            it = sub.iter
            if isinstance(it, ast.Set):
                out.append((it.lineno, "iteration over a set literal"))
            elif (
                isinstance(it, ast.Call)
                and isinstance(it.func, ast.Name)
                and it.func.id in ("set", "frozenset")
            ):
                out.append(
                    (it.lineno, f"direct iteration over {it.func.id}(...)")
                )
    return out


@register
class DeterminismReachabilityRule(Rule):
    """No tainted source reachable from a byte-compared surface."""

    name = "determinism-reachability"
    title = "byte-compared surfaces cannot reach a nondeterminism source"
    guards = "replay identity, twin-run identity, led/dig/report bytes"

    def check(self, snap, allowlist) -> List[Finding]:
        from karpenter_tpu_torch.analysis.allowlists import DETERMINISM_ROOTS

        graph = call_graph(snap)
        out: List[Finding] = []
        roots = []
        for root in DETERMINISM_ROOTS:
            # roots are package-relative ("sim/trace.py:TraceWriter.digest")
            # so synthetic trees keep the same vocabulary
            resolved = [
                k for k, d in graph.defs.items()
                if d.module.rel_in_pkg == root.split(":", 1)[0]
                and d.qual == root.split(":", 1)[1]
            ]
            if not resolved:
                # only report unresolved roots against the REAL package
                # (synthetic teeth trees declare their own roots via the
                # allowlist mechanism below).  The package name is
                # DERIVED, not a literal — tools/gen_metrics_doc scrapes
                # quoted karpenter_* literals and must not list this
                # file; the finding anchors at the roots' declaration
                # site, which is also where the fix goes.
                own_pkg = (__package__ or "").split(".")[0]
                if snap.package == own_pkg:
                    out.append(
                        self.finding(
                            f"{own_pkg}/analysis/allowlists.py", 1,
                            f"byte-compared root {root!r} no longer "
                            "resolves — the surface moved; update "
                            "DETERMINISM_ROOTS so it stays covered",
                        )
                    )
                continue
            roots.extend(resolved)
        # synthetic trees: any allowlist entry of the form
        # "root:<rel_in_pkg>:<qual>" adds a root (teeth harness hook)
        for entry in allowlist:
            if isinstance(entry, str) and entry.startswith("root:"):
                _, rel_in_pkg, qual = entry.split(":", 2)
                roots.extend(
                    k for k, d in graph.defs.items()
                    if d.module.rel_in_pkg == rel_in_pkg and d.qual == qual
                )
        sanctioned_files = {
            e for e in allowlist if isinstance(e, str) and e.endswith(".py")
        }
        sanctioned_defs = {e for e in allowlist if isinstance(e, tuple)}
        alias_cache: Dict[str, tuple] = {}
        for key, path in sorted(graph.reachable_from(roots).items()):
            d = graph.defs[key]
            if d.rel in sanctioned_files or (d.rel, d.qual) in sanctioned_defs:
                continue
            if d.rel not in alias_cache:
                alias_cache[d.rel] = stdlib_aliases(d.module.tree)
            aliases, from_names = alias_cache[d.rel]
            for line, what in taint_sources(d.node, aliases, from_names):
                out.append(
                    self.finding(
                        d.rel, line,
                        f"{what} in {d.qual} is reachable from the "
                        f"byte-compared surface via "
                        f"{graph.render_path(path)} — inject it (Clock, "
                        "seeded Random) or sanction the sink with a "
                        "written argument",
                    )
                )
        return out
