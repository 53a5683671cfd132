"""Lock-discipline analyzers (two bug classes once caught in review, CI-checked).

Two rules over a discovered lock model:

- **lock-blocking**: a blocking operation — socket I/O, a store RPC,
  payload encoding, a device fetch, a ``run_concurrently`` join —
  reachable while a ``threading.Lock/RLock/Condition`` is held.  This is
  exactly the class a review once caught by hand (a JSON snapshot
  encoded under the store lock): a blocking call under a hot lock turns
  every other thread's cheap critical section into a convoy.
- **lock-order**: two locks acquired in both nesting orders anywhere in
  the analyzed layers — the cross-thread deadlock seam the pipelined
  reconcile introduced a whole new class of.

The model is discovery-driven: lock attributes are found from
``self.X = threading.Lock()/RLock()/Condition(...)`` assignments, a
``Condition(self.Y)`` aliases onto Y, and cross-class aliases the AST
cannot see (a Condition built over another object's lock) are declared
in allowlists.LOCK_ALIASES.  Reachability inside a held region follows
the shared call graph (graph.py) to a bounded depth, so a lock held
around ``self._flush_dirty()`` still sees the socket write three calls
down.

Lock identity: ``Class.attr`` when the attribute is resolvable to one
defining class, else ``?.attr``.  Ambiguous identities still get
blocking-scan coverage but are excluded from order edges — a false
inversion between two unrelated ``_lock`` attributes would be noise,
not signal.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.core import (
    Finding,
    PackageSnapshot,
    Rule,
    call_name,
    register,
)
from karpenter_tpu_torch.analysis.graph import CallGraph, call_graph

# lock constructors: the raw stdlib forms plus the sanitizer seam
# (analysis/sanitizer.py make_*) the package routes construction
# through — the kind is what Condition-aliasing keys on
LOCK_CTORS: Dict[str, str] = {
    "Lock": "Lock",
    "RLock": "RLock",
    "Condition": "Condition",
    "make_lock": "Lock",
    "make_rlock": "RLock",
    "make_condition": "Condition",
}

# blocking-call detectors: called name -> why it must not run under a
# lock.  Name-based on purpose — the package's own seams (send_frame,
# _rpc, run_concurrently) are the vocabulary the rule fences.
BLOCKING_CALLS: Dict[str, str] = {
    "send_frame": "socket send",
    "recv_frame": "socket recv",
    "sendall": "socket send",
    "create_connection": "socket connect",
    "encode_payload": "payload codec encode",
    "dumps": "json.dumps of a payload",
    "_rpc": "store RPC round trip",
    "block_until_ready": "device sync fetch",
    "device_get": "device fetch",
    "fetch_verdict_rows": "device fetch",
    "run_concurrently": "thread fan-out join",
    # the port's device fetches: each waits for the card's queued work
    "cpu": "device fetch (.cpu())",
    "item": "device fetch (.item())",
    "tolist": "device fetch (.tolist())",
    "synchronize": "device sync (torch.cuda.synchronize)",
}

# call-graph expansion depth inside a held region: deep enough for the
# lease -> flush -> forward -> rpc chain, bounded so name-resolution
# over-approximation cannot weld the whole package into one region
MAX_DEPTH = 5

# Bounded per-OBJECT codecs: one dataclass in, one small string/tree out.
# The blocking rule targets PAYLOAD-sized work (frames, snapshots) under
# a lock; a single-object canonical() IS the in-place-mutation detector
# the store mirror deliberately runs under its lock, so descending into
# it would flag the design itself.
BOUNDED_OPAQUE = frozenset({"canonical", "to_wire", "from_wire",
                            "materialize"})


def _blocking_reason(node: ast.Call) -> Optional[Tuple[str, str]]:
    name = call_name(node)
    if name is None or name not in BLOCKING_CALLS:
        return None
    if name == "dumps":
        f = node.func
        if not (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "json"
        ):
            return None
    return name, BLOCKING_CALLS[name]


@dataclass
class LockModel:
    """Discovered lock attributes + per-function lock/blocking facts."""

    # (class name, attr) -> kind ("Lock"/"RLock"/"Condition")
    owners: Dict[Tuple[str, str], str] = field(default_factory=dict)
    # attr -> defining class names
    by_attr: Dict[str, Set[str]] = field(default_factory=dict)
    # canonical id -> canonical id (Condition-over-lock aliases)
    aliases: Dict[str, str] = field(default_factory=dict)
    # (class name, attr) -> package-relative defining file (the
    # cross-validation universe filter keys on the defining layer)
    files: Dict[Tuple[str, str], str] = field(default_factory=dict)

    def canonical(self, lock_id: str) -> str:
        seen = set()
        while lock_id in self.aliases and lock_id not in seen:
            seen.add(lock_id)
            lock_id = self.aliases[lock_id]
        return lock_id

    def resolve(self, expr: ast.expr, cls: Optional[str]) -> Optional[str]:
        """Lock identity for a ``with EXPR:`` context expression, or
        None when EXPR is not a discovered lock attribute."""
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        owners = self.by_attr.get(attr)
        if not owners:
            return None
        if (
            isinstance(expr.value, ast.Name)
            and expr.value.id in ("self", "cls")
            and cls in owners
        ):
            return self.canonical(f"{cls}.{attr}")
        if len(owners) == 1:
            return self.canonical(f"{next(iter(owners))}.{attr}")
        return f"?.{attr}"


def class_own_nodes(cls_node: ast.ClassDef):
    """Walk one class's OWN subtree, excluding nested ClassDefs — those
    are visited as classes in their own right by the caller's outer
    walk; descending into them here would attribute an inner class's
    lock assignments to the outer class (a phantom ``Outer.attr``
    identity next to the real ``Inner.attr``)."""
    stack = list(cls_node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def build_lock_model(snap: PackageSnapshot, extra_aliases=None) -> LockModel:
    model = LockModel()
    for info in snap.in_package():
        for node in ast.walk(info.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in class_own_nodes(node):
                if not (
                    isinstance(sub, ast.Assign)
                    and isinstance(sub.value, ast.Call)
                ):
                    continue
                ctor = call_name(sub.value)
                kind = LOCK_CTORS.get(ctor or "")
                if kind is None:
                    continue
                for target in sub.targets:
                    attr = None
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        attr = target.attr
                    elif isinstance(target, ast.Name):
                        attr = target.id
                    if attr is None:
                        continue
                    model.owners[(node.name, attr)] = kind
                    model.by_attr.setdefault(attr, set()).add(node.name)
                    model.files[(node.name, attr)] = info.rel_in_pkg
                    # Condition(self.X) / make_condition(name, self.X):
                    # alias onto the wrapped lock
                    wrap_idx = 1 if ctor == "make_condition" else 0
                    if (
                        kind == "Condition"
                        and len(sub.value.args) > wrap_idx
                    ):
                        arg = sub.value.args[wrap_idx]
                        if (
                            isinstance(arg, ast.Attribute)
                            and isinstance(arg.value, ast.Name)
                            and arg.value.id == "self"
                        ):
                            model.aliases[f"{node.name}.{attr}"] = (
                                f"{node.name}.{arg.attr}"
                            )
    for src, dst in (extra_aliases or {}).items():
        model.aliases[src] = dst
    return model


@dataclass
class _DefFacts:
    """Per-def direct facts (anywhere in the body)."""

    blocking: List[Tuple[str, str, int]] = field(default_factory=list)
    acquires: List[Tuple[str, int]] = field(default_factory=list)


class _RegionScan:
    """Held-region analysis over one snapshot: per-def facts plus a
    bounded-depth closure of what a held body reaches."""

    def __init__(self, snap: PackageSnapshot, model: LockModel,
                 graph: CallGraph):
        self.snap = snap
        self.model = model
        self.graph = graph
        self.facts: Dict[str, _DefFacts] = {}
        # strict callee sets (no global by-name fallback): lock regions
        # follow only calls the receiver provably owns
        self.strict_callees: Dict[str, Set[str]] = {}
        for key, d in graph.defs.items():
            facts = _DefFacts()
            callees: Set[str] = set()
            local_types = self._local_types(d)
            for node in ast.walk(d.node):
                if isinstance(node, ast.Call):
                    hit = _blocking_reason(node)
                    if hit:
                        facts.blocking.append((hit[0], hit[1], node.lineno))
                    callees.update(self._resolve(node, d, local_types))
                elif isinstance(node, ast.With):
                    for item in node.items:
                        lock = model.resolve(item.context_expr, d.cls)
                        if lock is not None:
                            facts.acquires.append((lock, node.lineno))
            self.facts[key] = facts
            self.strict_callees[key] = callees

    def _local_types(self, d) -> Dict[str, str]:
        """Constructor-based local type inference: ``bucket =
        _Bucket(...)`` binds bucket's class for the rest of the def, so
        ``bucket.add(...)`` resolves even though ``add`` is a stoplisted
        generic name — the runtime witness caught exactly this hole (the
        Batcher._lock -> _Bucket._cv edge was invisible statically).  A
        name rebound to DIFFERENT classes in one def is dropped as
        ambiguous."""
        out: Dict[str, str] = {}
        ambiguous: Set[str] = set()
        for node in ast.walk(d.node):
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
            ):
                continue
            cls = node.value.func.id
            if cls not in self.graph.classes.classes:
                continue
            var = node.targets[0].id
            if var in out and out[var] != cls:
                ambiguous.add(var)
            out[var] = cls
        for var in ambiguous:
            del out[var]
        return out

    def _resolve(self, node: ast.Call, d,
                 local_types: Dict[str, str]) -> List[str]:
        """Strict resolution plus the local constructor-type fallback."""
        got = self.graph.resolve_call(node, d.module, d.cls, strict=True)
        if got:
            return got
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in local_types
        ):
            return self.graph.classes.method(
                local_types[f.value.id], f.attr
            )
        return []

    def region_calls(self, body: List[ast.stmt], d,
                     local_types: Optional[Dict[str, str]] = None) -> Set[str]:
        """Callee def keys for calls lexically inside a with-body."""
        if local_types is None:
            local_types = self._local_types(d)
        out: Set[str] = set()
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    out.update(self._resolve(node, d, local_types))
        return out

    def closure(self, keys: Set[str]) -> Dict[str, List[str]]:
        """key -> shortest path from the region, depth-bounded; bounded
        per-object codecs are opaque (never descended into)."""
        paths = {
            k: [k]
            for k in keys
            if k in self.graph.defs
            and self.graph.defs[k].name not in BOUNDED_OPAQUE
        }
        frontier = list(paths)
        for _ in range(MAX_DEPTH - 1):
            nxt = []
            for k in frontier:
                for callee in sorted(self.strict_callees[k]):
                    if (
                        callee not in paths
                        and self.graph.defs[callee].name
                        not in BOUNDED_OPAQUE
                    ):
                        paths[callee] = paths[k] + [callee]
                        nxt.append(callee)
            frontier = nxt
        return paths

    def _path_str(self, path: List[str]) -> str:
        return " -> ".join(self.graph.defs[k].qual for k in path)

    def scan_regions(self):
        """(def, lock_id, with_line, blocking hits, order edges) per held
        region, computed once per scan and cached — both lock rules read
        the same list.  Blocking hits: (op, reason, site, path str).
        Order edges: (inner lock, site, path str)."""
        cached = getattr(self, "_regions", None)
        if cached is None:
            cached = list(self._scan_regions())
            self._regions = cached
        return cached

    def _scan_regions(self):
        for key in sorted(self.graph.defs):
            d = self.graph.defs[key]
            for node in ast.walk(d.node):
                if not isinstance(node, ast.With):
                    continue
                resolved = [
                    self.model.resolve(item.context_expr, d.cls)
                    for item in node.items
                ]
                for idx, lock in enumerate(resolved):
                    if lock is None:
                        continue
                    blocking: List[Tuple[str, str, str, str]] = []
                    edges: List[Tuple[str, str, str]] = []
                    # sibling items of the SAME with acquire in item
                    # order: `with a, b:` is an a -> b edge exactly like
                    # the nested form
                    for later in resolved[idx + 1:]:
                        if later is not None and later != lock:
                            edges.append(
                                (later, f"{d.rel}:{node.lineno}", d.qual)
                            )
                    # site strings carry the FILE only, never the line:
                    # finding messages feed line-stable fingerprints
                    # (core.py's baseline contract), and the with-line
                    # on the Finding itself locates the region
                    # direct hits inside the body
                    for stmt in node.body:
                        for sub in ast.walk(stmt):
                            if isinstance(sub, ast.Call):
                                hit = _blocking_reason(sub)
                                if hit:
                                    blocking.append(
                                        (hit[0], hit[1], d.rel, d.qual)
                                    )
                            elif isinstance(sub, ast.With):
                                for it in sub.items:
                                    inner = self.model.resolve(
                                        it.context_expr, d.cls
                                    )
                                    if inner and inner != lock:
                                        edges.append(
                                            (inner, d.rel, d.qual)
                                        )
                    # transitive hits through the call graph
                    region = self.region_calls(node.body, d)
                    for callee, path in sorted(self.closure(region).items()):
                        cf = self.facts.get(callee)
                        cd = self.graph.defs[callee]
                        if cf is None:
                            continue
                        for op, reason, _line in cf.blocking:
                            blocking.append(
                                (
                                    op, reason, cd.rel,
                                    f"{d.qual} -> {self._path_str(path)}",
                                )
                            )
                        for inner, _line in cf.acquires:
                            if inner != lock:
                                edges.append(
                                    (
                                        inner, cd.rel,
                                        f"{d.qual} -> {self._path_str(path)}",
                                    )
                                )
                    yield d, lock, node.lineno, blocking, edges


def _layer(info_rel_in_pkg: str, layers) -> bool:
    return any(
        info_rel_in_pkg == p or info_rel_in_pkg.startswith(p) for p in layers
    )


# one-entry memo (snapshot held by strong ref, the call_graph pattern):
# the two lock rules share one model+region scan per lint run instead of
# each paying the full-package held-region analysis
_SCAN_CACHE: List[tuple] = []


def region_scan(snap: PackageSnapshot) -> _RegionScan:
    from karpenter_tpu_torch.analysis.allowlists import LOCK_ALIASES

    if _SCAN_CACHE and _SCAN_CACHE[0][0] is snap:
        return _SCAN_CACHE[0][1]
    model = build_lock_model(snap, LOCK_ALIASES)
    scan = _RegionScan(snap, model, call_graph(snap))
    _SCAN_CACHE.clear()
    _SCAN_CACHE.append((snap, scan))
    return scan


@register
class LockBlockingRule(Rule):
    """Blocking operations reachable under a held lock."""

    name = "lock-blocking"
    title = "no blocking op (socket/RPC/encode/device/join) under a lock"
    guards = "store and pipeline tick latency; no convoy on hot locks"

    def check(self, snap, allowlist) -> List[Finding]:
        scan = region_scan(snap)
        out: List[Finding] = []
        for d, lock, line, blocking, _edges in scan.scan_regions():
            if (d.rel, d.qual) in allowlist:
                continue
            seen = set()
            for op, reason, site, path in blocking:
                if (op, site) in seen:
                    continue
                seen.add((op, site))
                out.append(
                    self.finding(
                        d.rel, line,
                        f"{d.qual}: {op}(...) ({reason}) at {site} runs "
                        f"under {lock} via {path} — move the blocking "
                        "work outside the critical section, or "
                        "consciously allowlist this region",
                    )
                )
        return out


@register
class LockOrderRule(Rule):
    """Inconsistent lock-acquisition order across the analyzed layers."""

    name = "lock-order"
    title = "consistent lock acquisition order (no A->B and B->A)"
    guards = "no cross-thread deadlock between store/pipeline/operator"

    def check(self, snap, allowlist) -> List[Finding]:
        from karpenter_tpu_torch.analysis.allowlists import LOCK_ORDER_LAYERS

        scan = region_scan(snap)
        # (outer, inner) -> [(file, line, path)]
        edges: Dict[Tuple[str, str], List[Tuple[str, int, str]]] = {}
        for d, lock, line, _blocking, region_edges in scan.scan_regions():
            if not _layer(d.module.rel_in_pkg, LOCK_ORDER_LAYERS):
                continue
            for inner, _site, path in region_edges:
                if inner.startswith("?.") or lock.startswith("?."):
                    continue  # ambiguous identities make false inversions
                edges.setdefault((lock, inner), []).append(
                    (d.rel, line, path)
                )
        out: List[Finding] = []
        for (a, b), sites in sorted(edges.items()):
            if (b, a) not in edges or a >= b:
                continue  # report each inverted pair once, from the
                # lexicographically smaller side
            pair = f"{a}|{b}"
            if pair in allowlist:
                continue
            rel, line, path = sites[0]
            rsites = edges[(b, a)]
            # no line numbers in the MESSAGE (fingerprint stability);
            # the finding's own line anchors the forward site
            out.append(
                self.finding(
                    rel, line,
                    f"lock order inversion: {a} -> {b} (here, via {path}) "
                    f"but {b} -> {a} in "
                    f"{rsites[0][0]} (via {rsites[0][2]}) "
                    "— pick one global order or merge the locks",
                )
            )
        return out


# ---------------------------------------------- static<->dynamic surface
def static_order_edges(
    snap: PackageSnapshot,
) -> Tuple[frozenset, frozenset]:
    """(edges, universe) for witness cross-validation (witness.py):
    every nested-acquisition edge the static model predicts within
    ``LOCK_ORDER_LAYERS`` — ALL of them, not just inverted pairs — plus
    the universe of layer-scoped canonical lock ids.  A runtime edge
    between universe locks that is absent here means the static model's
    resolution has a hole (or a seam lock name drifted)."""
    from karpenter_tpu_torch.analysis.allowlists import LOCK_ORDER_LAYERS

    scan = region_scan(snap)
    edges: Set[Tuple[str, str]] = set()
    for d, lock, _line, _blocking, region_edges in scan.scan_regions():
        if not _layer(d.module.rel_in_pkg, LOCK_ORDER_LAYERS):
            continue
        for inner, _site, _path in region_edges:
            if inner.startswith("?.") or lock.startswith("?."):
                continue
            edges.add((lock, inner))
    universe = frozenset(
        scan.model.canonical(f"{cls}.{attr}")
        for (cls, attr), rel in scan.model.files.items()
        if _layer(rel, LOCK_ORDER_LAYERS)
    )
    return frozenset(edges), universe


@register
class LockSeamRule(Rule):
    """Raw ``threading.Lock/RLock/Condition`` construction is fenced to
    the sanitizer seam (analysis/sanitizer.py make_lock/make_rlock/
    make_condition) — a raw lock is invisible to the runtime witness,
    so a sanitized suite proves nothing about it.  The rule also checks
    the seam's ``name`` argument against the assignment's static
    identity (``Class.attr``): the witness and the static model must
    speak the same vocabulary or cross-validation silently rots."""

    name = "lock-seam"
    title = "locks constructed via the sanitizer seam, names = Class.attr"
    guards = "runtime witness coverage + static<->dynamic name agreement"

    _RAW = frozenset({"Lock", "RLock", "Condition"})
    _SEAM = frozenset({"make_lock", "make_rlock", "make_condition"})

    def check(self, snap, allowlist) -> List[Finding]:
        out: List[Finding] = []
        for info in snap.in_package():
            # names imported straight off threading (`from threading
            # import Lock`): a bare `Lock()` built through them is just
            # as raw as `threading.Lock()` — the fence must not be
            # bypassable by import style
            from_threading = {
                (alias.asname or alias.name): alias.name
                for imp in ast.walk(info.tree)
                if isinstance(imp, ast.ImportFrom)
                and imp.module == "threading"
                for alias in imp.names
            }
            for node in ast.walk(info.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in class_own_nodes(node):
                    if not (
                        isinstance(sub, ast.Assign)
                        and isinstance(sub.value, ast.Call)
                    ):
                        continue
                    ctor = call_name(sub.value)
                    target = sub.targets[0]
                    attr = None
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        attr = target.attr
                    if attr is None:
                        continue
                    f = sub.value.func
                    raw_kind = None
                    if ctor in self._RAW and (
                        isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "threading"
                    ):
                        raw_kind = ctor
                    elif (
                        isinstance(f, ast.Name)
                        and from_threading.get(f.id) in self._RAW
                    ):
                        raw_kind = from_threading[f.id]
                    if raw_kind is not None:
                        if (info.rel, f"{node.name}.{attr}") in allowlist:
                            continue
                        out.append(
                            self.finding(
                                info.rel, sub.lineno,
                                f"{node.name}.{attr} = threading."
                                f"{raw_kind}() constructed raw — route "
                                "through analysis.sanitizer."
                                f"make_{raw_kind.lower()}(...) so "
                                "sanitized runs can witness it, or "
                                "consciously allowlist it",
                            )
                        )
                    elif ctor in self._SEAM:
                        args = sub.value.args
                        want = f"{node.name}.{attr}"
                        got = (
                            args[0].value
                            if args
                            and isinstance(args[0], ast.Constant)
                            and isinstance(args[0].value, str)
                            else None
                        )
                        if got != want:
                            out.append(
                                self.finding(
                                    info.rel, sub.lineno,
                                    f"{want} = {ctor}({got!r}) — the "
                                    "seam name must be the lock's "
                                    f"static identity {want!r} "
                                    "(witness<->static cross-validation "
                                    "matches on it)",
                                )
                            )
        return out
