"""Launch-seam analyzer for the CUDA library's wrappers.

Port of ``karpenter_tpu/analysis/tracer.py``.  The reference discovers
every ``jax.jit`` callable from its binding and fences its calls to the
device observatory's counted seam.  The port has no jit: its device work
is the hand-written CUDA library that ``ops/_build.load`` builds and
``ops/fused_packer._lib()`` loads, launched by ctypes calls.  So the rule
(it keeps its name, ``tracer-safety``, so the allowlist table and the CLI
keep their keys) discovers **launch wrappers** instead:

- a function whose own body calls ``_lib().<entry>(...)`` (or
  ``lib.<entry>(...)`` on a name bound to ``_lib()`` in that body), where
  ``<entry>`` is not one of the library's host queries.  The queries launch
  nothing (an occupancy or shared-memory figure, a tile size); each is
  exempted by name, with its argument, as a bare-name entry of the rule's
  allowlist (allowlists.py);
- a def nested in a factory that does so (fenced within its factory, as
  the reference fences a locally-jitted name);
- then, to a fixed point, the composition around them: a module-level
  function or method that calls a wrapper of its OWN module (the library
  module's entry points: ``ffd_pack`` is ``choose_config`` then
  ``ffd_scan``), and a function handed to ``OBSERVATORY.dispatch`` as its
  ``fn`` that calls any wrapper (``ops/packer.admit_kernel``, the
  dispatched entry that picks the CUDA wrapper or the plain version).

and checks property 1 of the reference, **seamed dispatch**: a wrapper is
never called directly outside the counted seam (obs/device.py).  It is
handed to ``OBSERVATORY.dispatch(name, fn, ...)`` as ``fn`` (passing is not
calling), or called from inside another wrapper (composition on the device
side, the exception the reference makes for a jit called in a traced
body).  Every launch is then counted by the observatory: a path from host
code into the library passes a dispatch before it reaches a wrapper.
Calls resolve through the shared call graph (graph.py, strict: bare
names through the module's defs and imports, ``self``/``cls`` through the
class, module aliases through the module), so a same-named method of
another object is not a wrapper.

The reference's properties 2 and 3, no host mutation of a traced parameter
and no ``time.*`` or ``print`` in a traced body, have no counterpart in
eager PyTorch: a launch wrapper runs on every call, with real tensors, and
there is no trace time at which a side effect could fire once per compile
and be folded into a program.  The port drops them.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Set, Tuple

from karpenter_tpu_torch.analysis.core import (
    Finding,
    PackageSnapshot,
    Rule,
    register,
)
from karpenter_tpu_torch.analysis.graph import CallGraph, call_graph

# the sanctioned seam file (package-relative)
_SEAM_FILE = "obs/device.py"
# the loader of the built library (ops/fused_packer.py)
_LOADER = "_lib"
# the counted seam's receiver: OBSERVATORY.dispatch(name, fn, ...)
_SEAM = "OBSERVATORY"

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """The nodes of one def's body, nested defs and classes excluded (a
    nested def is a wrapper in its own right, or not)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (*_DEFS, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def library_calls(fn: ast.AST) -> List[Tuple[str, int]]:
    """``(entry, line)`` for each call into the library in ``fn``'s own
    body: ``_lib().<entry>(...)``, or ``<name>.<entry>(...)`` on a name
    bound to ``_lib()`` there."""
    nodes = list(_own_nodes(fn))
    bound = {
        t.id
        for node in nodes
        if isinstance(node, ast.Assign) and _is_loader(node.value)
        for t in node.targets
        if isinstance(t, ast.Name)
    }
    out = []
    for node in nodes:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        value = node.func.value
        if _is_loader(value) or (
            isinstance(value, ast.Name) and value.id in bound
        ):
            out.append((node.func.attr, node.lineno))
    return sorted(out, key=lambda e: (e[1], e[0]))


def _is_loader(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == _LOADER
    )


@dataclass
class LaunchWrappers:
    """What discovery found over one snapshot."""

    # graph def key ("rel:Qual") -> why it is a wrapper: "library" (calls
    # the library itself), "module" (composes a wrapper of its own module)
    # or "dispatched" (a dispatch fn that calls a wrapper)
    keys: Dict[str, str] = field(default_factory=dict)
    # factory-nested wrappers: rel -> {factory def node: {nested names}}
    nested: Dict[str, Dict[ast.AST, Set[str]]] = field(default_factory=dict)
    # "rel:factory.name" of each factory-nested wrapper
    nested_keys: Set[str] = field(default_factory=set)

    def names(self) -> List[str]:
        """Every wrapper, "rel:Qual", sorted."""
        return sorted(set(self.keys) | self.nested_keys)


def _dispatched(graph: CallGraph, snap: PackageSnapshot) -> Set[str]:
    """Def keys handed to ``OBSERVATORY.dispatch`` as its ``fn``."""
    out: Set[str] = set()
    for info in snap.in_package():
        for cls, node in _calls_with_class(info.tree):
            f = node.func
            if not (
                isinstance(f, ast.Attribute)
                and f.attr == "dispatch"
                and isinstance(f.value, ast.Name)
                and f.value.id == _SEAM
                and len(node.args) >= 2
            ):
                continue
            probe = ast.Call(func=node.args[1], args=[], keywords=[])
            out.update(graph.resolve_call(probe, info, cls, strict=True))
    return out


def _calls_with_class(tree: ast.AST):
    """(enclosing class name or None, Call node) for every call."""

    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            else:
                if isinstance(child, ast.Call):
                    yield cls, child
                yield from walk(child, cls)

    yield from walk(tree, None)


def discover_wrappers(
    snap: PackageSnapshot, exempt: frozenset = frozenset()
) -> LaunchWrappers:
    """Every launch wrapper of the snapshot.  ``exempt`` holds the
    library's host-query entry names."""
    graph = call_graph(snap)
    found = LaunchWrappers()
    for key in sorted(graph.defs):
        d = graph.defs[key]
        if any(e not in exempt for e, _ in library_calls(d.node)):
            found.keys[key] = "library"
        for sub in ast.walk(d.node):
            if sub is d.node or not isinstance(sub, _DEFS):
                continue
            if any(e not in exempt for e, _ in library_calls(sub)):
                found.nested.setdefault(d.rel, {}).setdefault(
                    d.node, set()
                ).add(sub.name)
                found.nested_keys.add(f"{d.rel}:{d.qual}.{sub.name}")
    dispatched = _dispatched(graph, snap)
    callees = {
        key: {
            c
            for node in ast.walk(d.node)
            if isinstance(node, ast.Call)
            for c in graph.resolve_call(node, d.module, d.cls, strict=True)
        }
        for key, d in graph.defs.items()
    }
    changed = True
    while changed:
        changed = False
        for key in sorted(graph.defs):
            if key in found.keys:
                continue
            d = graph.defs[key]
            hit = [c for c in callees[key] if c in found.keys]
            if any(graph.defs[c].rel == d.rel for c in hit):
                found.keys[key] = "module"
                changed = True
            elif hit and key in dispatched:
                found.keys[key] = "dispatched"
                changed = True
    return found


@register
class TracerSafetyRule(Rule):
    """Launch wrappers of the CUDA library take the counted seam."""

    name = "tracer-safety"
    title = "CUDA launch wrappers dispatched through the counted seam"
    guards = "every launch counted by the device observatory"

    def check(self, snap, allowlist) -> List[Finding]:
        exempt = frozenset(e for e in allowlist if isinstance(e, str))
        found = discover_wrappers(snap, exempt)
        graph = call_graph(snap)
        out: List[Finding] = []
        for info in snap.in_package():
            if info.rel_in_pkg == _SEAM_FILE:
                continue
            out.extend(self._lint_call_sites(info, graph, found, allowlist))
            for fn_node, names in found.nested.get(info.rel, {}).items():
                out.extend(
                    self._lint_local_calls(info, fn_node, names, allowlist)
                )
        return out

    def _lint_local_calls(
        self, info, fn_node, names: Set[str], allowlist
    ) -> List[Finding]:
        out: List[Finding] = []
        rel = info.rel
        for node in ast.walk(fn_node):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in names
            ):
                qual = fn_node.name
                if (rel, qual) in allowlist:
                    continue
                out.append(
                    self.finding(
                        rel, node.lineno,
                        f"{qual}: direct call of the nested launch wrapper "
                        f"{node.func.id}(...) bypasses the counted seam "
                        "— route it through OBSERVATORY.dispatch, or "
                        "consciously allowlist this site",
                    )
                )
        return out

    def _lint_call_sites(
        self, info, graph: CallGraph, found: LaunchWrappers, allowlist
    ) -> List[Finding]:
        out: List[Finding] = []
        rel = info.rel
        rule = self

        class V(ast.NodeVisitor):
            def __init__(self):
                self.scope: List[str] = []
                self.classes: List[str] = []

            def visit_ClassDef(self, node):
                self.scope.append(node.name)
                self.classes.append(node.name)
                self.generic_visit(node)
                self.classes.pop()
                self.scope.pop()

            def _def(self, node):
                self.scope.append(node.name)
                self.generic_visit(node)
                self.scope.pop()

            visit_FunctionDef = visit_AsyncFunctionDef = _def

            def inside_wrapper(self) -> bool:
                return any(
                    f"{rel}:{'.'.join(self.scope[:i])}" in found.keys
                    for i in range(1, len(self.scope) + 1)
                )

            def visit_Call(self, node):
                cls = self.classes[-1] if self.classes else None
                hit = [
                    k
                    for k in graph.resolve_call(node, info, cls, strict=True)
                    if k in found.keys
                ]
                qual = ".".join(self.scope)
                if hit and not self.inside_wrapper() and (
                    rel, qual
                ) not in allowlist:
                    name = graph.defs[hit[0]].name
                    out.append(
                        rule.finding(
                            rel, node.lineno,
                            f"{qual or '<module>'}: direct call of launch "
                            f"wrapper {name}(...) bypasses the counted "
                            "seam — route it through OBSERVATORY.dispatch("
                            f"'{name}', {name}, ...), or consciously "
                            "allowlist this site",
                        )
                    )
                self.generic_visit(node)

        V().visit(info.tree)
        return out
