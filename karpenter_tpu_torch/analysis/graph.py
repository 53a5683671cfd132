"""Intra-package definition index + call graph.

The whole-program analyzers (locks.py, reachability.py) need "what does
this function reach?" answers the per-callsite rules cannot give.  The
graph is a deliberate over-approximation tuned for THIS codebase:

- **bare names** resolve through the module's own top-level defs and its
  ``from pkg.mod import f`` imports;
- **self/cls attribute calls** resolve through the enclosing class, then
  its by-name base classes within the package (the ``RemoteKubeStore ->
  KubeStore`` chain);
- **module-alias calls** (``mod.f(...)`` after ``import pkg.mod as
  mod``) resolve into that module;
- **other attribute calls** (``store.subscribe(...)``) resolve to EVERY
  package def of that name — sound for reachability, and kept sane by a
  stoplist of generic container/stdlib-shaped names that would otherwise
  alias half the package together (``get``, ``items``, ``close``, ...).

Nested functions and lambdas are attributed to their enclosing def: a
closure handed to ``mutate(lambda: ...)`` or a local ``def apply()``
runs on the caller's stack for every pattern in this repo, which is
exactly the approximation the lock analyzer wants.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.core import ModuleInfo, PackageSnapshot

# Attribute names too generic to resolve globally: linking every
# `x.get(...)` to every package class defining `get` would weld the
# graph into one blob.  self-calls still resolve through the class, so
# a stoplisted name only loses the cross-object edge.
ATTR_STOPLIST = frozenset(
    {
        "get", "set", "add", "pop", "items", "keys", "values", "append",
        "extend", "insert", "remove", "discard", "clear", "copy", "update",
        "count", "index", "sort", "split", "join", "strip", "read",
        "write", "flush", "open", "close", "encode", "decode", "format",
        "startswith", "endswith", "lower", "upper", "replace", "setdefault",
        "submit", "result", "wait", "notify", "notify_all", "acquire",
        "release", "start", "run", "stop", "send", "recv", "settimeout",
        "fileno", "shutdown", "popleft", "appendleft", "partition",
        "mark", "match", "fullmatch", "search", "findall", "group",
    }
)


@dataclass
class DefInfo:
    """One function/method definition."""

    key: str  # "rel:Qual.name"
    rel: str
    module: ModuleInfo
    qual: str  # "Class.method" or "func"
    name: str
    cls: Optional[str]
    node: ast.AST
    line: int
    # resolved callee keys for calls anywhere in the def (nested
    # defs/lambdas included)
    callees: Set[str] = field(default_factory=set)


class _ClassIndex:
    def __init__(self):
        # class name -> (rel, bases, {method name -> def key})
        self.classes: Dict[str, List[dict]] = {}

    def add(self, name: str, rel: str, bases: List[str]):
        entry = {"rel": rel, "bases": bases, "methods": {}}
        self.classes.setdefault(name, []).append(entry)
        return entry

    def method(self, cls_name: str, attr: str, _seen=None) -> List[str]:
        """Def keys for ``cls_name.attr``, walking by-name bases within
        the package (first match per class entry wins, like the MRO)."""
        _seen = _seen if _seen is not None else set()
        if cls_name in _seen:
            return []
        _seen.add(cls_name)
        out: List[str] = []
        for entry in self.classes.get(cls_name, ()):
            if attr in entry["methods"]:
                out.append(entry["methods"][attr])
                continue
            for base in entry["bases"]:
                got = self.method(base, attr, _seen)
                if got:
                    out.extend(got)
                    break
        return out


class CallGraph:
    def __init__(self, snap: PackageSnapshot):
        self.snap = snap
        self.defs: Dict[str, DefInfo] = {}
        self.by_name: Dict[str, List[str]] = {}
        self.classes = _ClassIndex()
        # per-module: imported name -> dotted module ("from m import f"
        # maps f -> (module, f); "import m as a" maps a -> (module, None))
        self._imports: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        self._module_by_dotted = {
            info.name: info for info in snap.modules.values()
        }
        for info in snap.modules.values():
            self._index_module(info)
        for info in snap.modules.values():
            self._link_module(info)

    # ------------------------------------------------------------- indexing
    def _index_module(self, info: ModuleInfo) -> None:
        imports: Dict[str, Tuple[str, Optional[str]]] = {}
        pkg = self.snap.package

        # imports are collected over the WHOLE module (function-level
        # lazy imports included — this repo uses them heavily), scoped
        # module-wide as a deliberate over-approximation
        for child in ast.walk(info.tree):
            if isinstance(child, ast.Import):
                for alias in child.names:
                    if alias.name.split(".")[0] == pkg:
                        imports[alias.asname or alias.name.split(".")[0]] = (
                            alias.name, None,
                        )
            elif isinstance(child, ast.ImportFrom):
                mod = child.module or ""
                if child.level:  # relative import -> absolute
                    base = info.name.split(".")
                    # a package __init__'s dotted name is the package
                    # itself (".__init__" stripped), so level 1 keeps
                    # the full name; plain modules drop one more part
                    is_pkg = info.rel.endswith("/__init__.py")
                    drop = child.level - 1 if is_pkg else child.level
                    base = base[: len(base) - drop] if drop else base
                    mod = ".".join(base + ([mod] if mod else []))
                if mod.split(".")[0] == pkg:
                    for alias in child.names:
                        imports[alias.asname or alias.name] = (
                            mod, alias.name,
                        )

        def walk(node, scope: List[str], cls_entry):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    bases = [
                        b.id if isinstance(b, ast.Name) else b.attr
                        for b in child.bases
                        if isinstance(b, (ast.Name, ast.Attribute))
                    ]
                    entry = self.classes.add(child.name, info.rel, bases)
                    walk(child, scope + [child.name], entry)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = ".".join(scope + [child.name])
                    key = f"{info.rel}:{qual}"
                    cls = scope[-1] if scope else None
                    self.defs[key] = DefInfo(
                        key=key, rel=info.rel, module=info, qual=qual,
                        name=child.name, cls=cls, node=child,
                        line=child.lineno,
                    )
                    self.by_name.setdefault(child.name, []).append(key)
                    if cls_entry is not None:
                        cls_entry["methods"].setdefault(child.name, key)
                    # nested defs are attributed to the enclosing def:
                    # do NOT recurse into child here — _link walks the
                    # full body including nested defs
                else:
                    walk(child, scope, cls_entry)

        walk(info.tree, [], None)
        self._imports[info.rel] = imports

    # -------------------------------------------------------------- linking
    def resolve_call(
        self,
        node: ast.Call,
        info: ModuleInfo,
        cls: Optional[str],
        strict: bool = False,
    ) -> List[str]:
        """Callee def keys for one Call node (possibly empty).

        ``strict=True`` drops the global by-attribute-name fallback:
        only self/cls/super and module-resolved calls link.  The lock
        analyzers use strict resolution — a lock region reaching every
        same-named method in the package would drown the real convoys
        in cross-object noise; reachability keeps the sound default."""
        imports = self._imports[info.rel]
        f = node.func
        if isinstance(f, ast.Name):
            name = f.id
            if name in imports:
                mod, attr = imports[name]
                target = self._module_by_dotted.get(mod)
                if target is not None and attr is not None:
                    key = f"{target.rel}:{attr}"
                    return [key] if key in self.defs else []
                return []
            key = f"{info.rel}:{name}"
            return [key] if key in self.defs else []
        if isinstance(f, ast.Attribute):
            attr = f.attr
            value = f.value
            if isinstance(value, ast.Name):
                if value.id in ("self", "cls") and cls is not None:
                    got = self.classes.method(cls, attr)
                    if got:
                        return got
                elif value.id in imports:
                    mod, sub = self._imports[info.rel][value.id]
                    target = self._module_by_dotted.get(mod)
                    if target is not None:
                        key = f"{target.rel}:{attr}"
                        return [key] if key in self.defs else []
                    return []
            # super().m(...): the enclosing class's by-name bases
            if (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "super"
                and cls is not None
            ):
                out: List[str] = []
                for entry in self.classes.classes.get(cls, ()):
                    for base in entry["bases"]:
                        out.extend(self.classes.method(base, attr))
                return out
            if strict:
                return []
            if attr.startswith("__") or attr in ATTR_STOPLIST:
                return []
            return list(self.by_name.get(attr, ()))
        return []

    def _link_module(self, info: ModuleInfo) -> None:
        for d in self.defs.values():
            if d.rel != info.rel:
                continue
            for node in ast.walk(d.node):
                if isinstance(node, ast.Call):
                    d.callees.update(self.resolve_call(node, info, d.cls))

    # ---------------------------------------------------------- reachability
    def reachable_from(self, keys: Iterable[str]) -> Dict[str, List[str]]:
        """BFS closure: def key -> shortest call path (list of keys,
        root first) for every def reachable from ``keys``."""
        paths: Dict[str, List[str]] = {}
        frontier: List[str] = []
        for k in keys:
            if k in self.defs and k not in paths:
                paths[k] = [k]
                frontier.append(k)
        while frontier:
            nxt: List[str] = []
            for k in frontier:
                for callee in sorted(self.defs[k].callees):
                    if callee not in paths:
                        paths[callee] = paths[k] + [callee]
                        nxt.append(callee)
            frontier = nxt
        return paths

    def render_path(self, path: List[str]) -> str:
        return " -> ".join(
            f"{self.defs[k].rel}:{self.defs[k].qual}" for k in path
        )


# one-entry memo: (snapshot, its graph).  The snapshot is held by
# STRONG reference on purpose — an id()-keyed cache would go stale the
# moment a collected snapshot's address is reused by a new one.
_GRAPH_CACHE: List[Tuple[PackageSnapshot, CallGraph]] = []


def call_graph(snap: PackageSnapshot) -> CallGraph:
    """Snapshot-keyed memo: the lock and reachability rules share one
    graph build per lint run."""
    if _GRAPH_CACHE and _GRAPH_CACHE[0][0] is snap:
        return _GRAPH_CACHE[0][1]
    got = CallGraph(snap)
    _GRAPH_CACHE.clear()  # one live snapshot at a time
    _GRAPH_CACHE.append((snap, got))
    return got
