"""The 11 legacy lint rules, ported onto the rule engine.

These are the checks tests/test_lint.py originally enforced as ad-hoc
test functions; each keeps its historical allowlist (allowlists.py) and
semantics.  The shared machinery — scope stacks, in-loop tagging,
(file, qualname) allowlisting — lives in :class:`CallSiteRule` instead
of six copy-pasted visitors.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from karpenter_tpu_torch.analysis.core import (
    Finding,
    PackageSnapshot,
    Rule,
    ScopedVisitor,
    call_name,
    register,
)


# ---------------------------------------------------------------- runtime
def import_snapshot_modules(snap: PackageSnapshot):
    """Import every module of the snapshot, yielding (ModuleInfo,
    module-or-None, exception-or-None).  The snapshot's repo root is
    put on sys.path for synthetic trees; the real package is already
    importable (and mostly already imported)."""
    import importlib
    import sys

    added = str(snap.repo_root) not in sys.path
    if added:
        sys.path.insert(0, str(snap.repo_root))
    try:
        for info in snap.in_package():
            try:
                yield info, importlib.import_module(info.name), None
            except Exception as exc:
                yield info, None, exc
    finally:
        if added:
            sys.path.remove(str(snap.repo_root))


@register
class ImportCleanRule(Rule):
    """Rule 1: every module imports cleanly."""

    name = "import-clean"
    title = "every package module imports without error"
    guards = "a module that cannot import cannot be reconciled against"

    def check(self, snap, allowlist) -> List[Finding]:
        out = []
        for info, _mod, exc in import_snapshot_modules(snap):
            if exc is not None and info.rel not in allowlist:
                out.append(
                    self.finding(
                        info.rel, 1,
                        f"module {info.name} failed to import: "
                        f"{type(exc).__name__}: {exc}",
                    )
                )
        return out


@register
class AnnotationsResolveRule(Rule):
    """Rule 2: ``typing.get_type_hints`` resolves on every public
    function/method — catches annotations referencing never-imported
    names (the ``Optional``-without-import bug class)."""

    name = "annotations-resolve"
    title = "type annotations resolve on every public def"
    guards = "annotation rot (names referenced but never imported)"

    def check(self, snap, allowlist) -> List[Finding]:
        import inspect
        import typing

        out = []
        for info, mod, exc in import_snapshot_modules(snap):
            if mod is None or info.rel in allowlist:
                continue
            targets = []
            for _, obj in vars(mod).items():
                if inspect.isfunction(obj) and obj.__module__ == info.name:
                    targets.append(obj)
                elif inspect.isclass(obj) and obj.__module__ == info.name:
                    targets.append(obj)
                    for _, m in vars(obj).items():
                        if inspect.isfunction(m):
                            targets.append(m)
            for t in targets:
                try:
                    typing.get_type_hints(t)
                except NameError as err:
                    qual = getattr(t, "__qualname__", t)
                    line = 1
                    try:
                        line = t.__code__.co_firstlineno
                    except AttributeError:
                        pass
                    out.append(
                        self.finding(
                            info.rel, line,
                            f"unresolvable annotation on {qual}: {err}",
                        )
                    )
                except Exception:
                    pass  # forward refs to runtime-only types are fine
        return out


# -------------------------------------------------------------- wall clock
_WALL_CLOCK_RE = re.compile(r"\btime\.(?:time|sleep)\s*\(")


@register
class WallClockRule(Rule):
    """Rule 3: no ``time.time``/``time.sleep`` calls outside
    utils/clock.py — all time flows through the injectable Clock so a
    FakeClock compresses every wait and two equal seeds replay
    byte-identically.
    (``time.monotonic``/``perf_counter`` stay free: they measure host
    durations no simulated clock can compress.)"""

    name = "wall-clock"
    title = "wall clock only inside the injectable Clock"
    guards = "byte-identical sim replay (docs/designs/simulation.md)"

    def check(self, snap, allowlist) -> List[Finding]:
        out = []
        for info in snap.in_package():
            if info.rel in allowlist:
                continue
            for lineno, line in enumerate(info.source.splitlines(), 1):
                code = line.split("#", 1)[0]
                if _WALL_CLOCK_RE.search(code):
                    out.append(
                        self.finding(
                            info.rel, lineno,
                            f"wall-clock call outside the Clock seam: "
                            f"{line.strip()} (route through the injected "
                            "Clock, or allowlist a genuinely-wall-clock "
                            "spot)",
                        )
                    )
        return out


# ---------------------------------------------------- call-site rule base
class CallSiteRule(Rule):
    """Shared machinery for the fenced-call-site rules: a set of call
    names (bare or attribute form), an optional package-relative scan
    scope, allowlisting by ``(file, qualified name)``, and in-loop
    tagging for the per-candidate antipatterns."""

    names: frozenset = frozenset()
    scan: tuple = ()  # rel_in_pkg prefixes; () = whole package
    loop_tag = True
    advice = ""
    # DENY fence: rel-path suffixes where no allowlist entry may ever
    # sanction a match — the rule fires there even when an entry exists,
    # and the entry itself is flagged.  This is how a module whose whole
    # contract is "never does X" (the admission fast path vs tensorize)
    # stays un-allowlistable by construction.
    deny: tuple = ()

    def enter(self, info) -> None:
        """Called before each module is scanned: a rule whose predicate
        reads module facts (device-put's dtype aliases) gathers them."""

    def match(self, node: ast.Call, name: Optional[str]) -> Optional[str]:
        """The matched display name, or None.  Subclasses with richer
        predicates (scheduler-update's receiver check) override."""
        return name if name in self.names else None

    def check(self, snap, allowlist) -> List[Finding]:
        out: List[Finding] = []
        rule = self

        if self.deny:
            # an allowlist entry pointing into a DENIED file is itself a
            # finding: the fence must be visible at review time, not
            # only when someone writes the forbidden call
            for entry in sorted(allowlist, key=repr):
                rel_entry = entry[0] if isinstance(entry, tuple) else entry
                if isinstance(rel_entry, str) and rel_entry.endswith(
                    self.deny
                ):
                    out.append(
                        self.finding(
                            rel_entry, 0,
                            f"allowlist entry {entry!r} references a "
                            f"DENIED file — no exception to "
                            f"'{self.title}' may be sanctioned there",
                        )
                    )

        for info in snap.in_package(*self.scan):
            rel = info.rel
            self.enter(info)
            # str.endswith(()) is False, so an empty deny never matches
            denied = rel.endswith(self.deny)

            class V(ScopedVisitor):
                def on_call(self, node):
                    matched = rule.match(node, call_name(node))
                    if matched is None:
                        return
                    if (rel, self.qual) in allowlist and not denied:
                        return
                    where = (
                        "INSIDE A LOOP"
                        if rule.loop_tag and self.loops
                        else "call"
                    )
                    if denied:
                        where += ", DENIED file"
                    out.append(
                        rule.finding(
                            rel, node.lineno,
                            f"{self.qual or '<module>'}: {matched}(...) "
                            f"[{where}] — {rule.advice}",
                        )
                    )

            V().visit(info.tree)
        return out


@register
class SchedulerUpdateRule(CallSiteRule):
    """Rule 4: ``scheduler.update()`` in controllers/ only at the
    sanctioned sites — a per-candidate update loop re-compiles the whole
    problem per subset (docs/designs/consolidation-batching.md)."""

    name = "scheduler-update"
    title = "scheduler.update() fenced to the sanctioned controller sites"
    guards = "the batched consolidation win (no serial re-simulation)"
    scan = ("controllers/",)
    advice = (
        "batch the simulations through TensorScheduler.evaluate_removals, "
        "or allowlist a genuinely one-shot site"
    )

    def match(self, node, name):
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "update"
            and "scheduler" in ast.unparse(f.value).lower()
        ):
            return f"{ast.unparse(f.value)}.update"
        return None


@register
class FullTensorizeRule(CallSiteRule):
    """Rule 7: no full-tensorize call outside the sanctioned cold-build
    and rebuild-fallback sites — warm ticks flow through the resident
    delta path (ops/resident.py, docs/designs/resident-tensors.md)."""

    name = "full-tensorize"
    title = "full tensorize fenced to cold-build/rebuild sites"
    guards = "the resident-tensor warm path (35 ms flagship p50)"
    names = frozenset({"compile_problem", "_compile_tensor"})
    scan = ("controllers/", "scheduling/")
    # the admission fast path's sub-millisecond budget is STRUCTURAL:
    # its module may never tensorize, and no future allowlist entry may
    # carve an exception (docs/designs/admission-fastpath.md)
    deny = ("scheduling/fastpath.py",)
    advice = (
        "route warm updates through the resident delta path, or "
        "consciously allowlist a cold-build/rebuild site"
    )


@register
class SequentialDescentRule(CallSiteRule):
    """Rule 8: the sequential consolidation descent is reachable only
    from the allowlisted fallback and re-derivation sites — what-ifs
    flow through the population/verdict kernels
    (docs/designs/consolidation-search.md)."""

    name = "sequential-descent"
    title = "sequential descent fenced to fallback/re-derivation sites"
    guards = "the device-resident consolidation search promotion"
    names = frozenset(
        {"_simulate", "_consolidate_multi", "_consolidate_multi_descent"}
    )
    advice = (
        "batch the what-ifs through evaluate_population/evaluate_removals, "
        "or consciously allowlist a fallback/re-derivation site"
    )


# the port's upload idioms (DevicePutRule): tensor constructors that copy
# host data, and torch's dtype names (a ``.to(<dtype>)`` is a cast, not a
# move)
_DATA_CTORS = frozenset({"tensor", "as_tensor", "asarray"})
_TORCH_DTYPES = frozenset(
    {
        "bool", "uint8", "int8", "int16", "int32", "int64", "short", "int",
        "long", "float16", "bfloat16", "float32", "float64", "half",
        "float", "double", "complex64", "complex128", "cfloat", "cdouble",
    }
)


def _torch_dtype(expr: ast.expr) -> bool:
    return (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "torch"
        and expr.attr in _TORCH_DTYPES
    )


def _host(expr: ast.expr) -> bool:
    """A literal host device: ``"cpu"``."""
    return isinstance(expr, ast.Constant) and expr.value == "cpu"


@register
class DevicePutRule(CallSiteRule):
    """Rule 9: raw host->device uploads only inside the counted seam
    (obs/device.py DeviceObservatory.put) — an upload that bypasses it
    vanishes from ``karpenter_device_transfer_bytes_total{site}``.

    The reference fences ``device_put``; the port's uploads are a tensor
    constructor that copies host data with a ``device=`` argument
    (``torch.tensor``, ``torch.as_tensor``, ``torch.asarray``), a
    ``.to(<device>)`` (``torch.from_numpy(a).to(dev)`` included; a
    ``.to(<dtype>)`` cast and a move to ``"cpu"`` are not uploads), a
    ``.cuda()``, and a ``.copy_(src)`` into a device tensor (the seam's own
    idiom).  A device-to-device move or a plain version that runs on CPU
    tensors matches the same syntax: each such site is argued in the
    allowlist."""

    name = "device-put"
    title = "raw host->device uploads fenced to the observatory's counted seam"
    guards = "complete host->device transfer accounting"
    advice = (
        "route the upload through OBSERVATORY.put(site, ...), or "
        "consciously allowlist it"
    )

    def enter(self, info) -> None:
        # names bound to a torch dtype in this module (``i32 =
        # torch.int32``, ``i32, f32 = torch.int32, torch.float32``), and
        # the conventional ``dtype`` parameter
        self._dtypes = {"dtype"}
        for node in ast.walk(info.tree):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = [(t, node.value)]
                if isinstance(t, ast.Tuple) and isinstance(
                    node.value, ast.Tuple
                ):
                    pairs = list(zip(t.elts, node.value.elts))
                self._dtypes.update(
                    name.id
                    for name, value in pairs
                    if isinstance(name, ast.Name) and _torch_dtype(value)
                )

    def match(self, node, name):
        kw = {k.arg: k.value for k in node.keywords}
        if name in _DATA_CTORS and "device" in kw:
            return None if _host(kw["device"]) else name
        if not isinstance(node.func, ast.Attribute):
            return None
        if name in ("cuda", "copy_"):
            return name
        if name != "to":
            return None
        if "device" in kw:
            return None if _host(kw["device"]) else name
        if not node.args:
            return None
        first = node.args[0]
        if _torch_dtype(first) or _host(first) or (
            isinstance(first, ast.Name) and first.id in self._dtypes
        ):
            return None
        return name


@register
class ThreadSeamRule(CallSiteRule):
    """Rule 11: thread construction in the controller layer is fenced to
    the pipeline seam — a raw Thread/ThreadPoolExecutor in controllers/
    or operator.py is an unscheduled side channel the twin-run and
    byte-identity proofs cannot see."""

    name = "thread-seam"
    title = "controller-layer threads fenced to pipeline.run_concurrently"
    guards = "the pipelined-reconcile determinism story"
    names = frozenset({"Thread", "ThreadPoolExecutor"})
    scan = ("controllers/", "operator.py", "pipeline.py")
    loop_tag = False
    advice = (
        "route the fan-out through pipeline.run_concurrently / declare a "
        "pipeline stage, or consciously allowlist it"
    )


# ----------------------------------------------------------- doc-rot rules
_REGISTRY_VERBS = frozenset(
    {
        "inc", "set", "observe", "time", "unset", "reset_gauge",
        "counter", "gauge", "histogram", "quantile",
    }
)


@register
class MetricDocRule(Rule):
    """Rule 5: every metric-name literal passed to a registry verb
    appears in docs/torch/metrics.md (the port's page; docs/metrics.md is
    the reference's) — a new series cannot ship without
    regenerating the reference page (tools/gen_metrics_doc.py)."""

    name = "metric-doc"
    title = "metric literals documented in docs/torch/metrics.md"
    guards = "the /metrics HELP/TYPE catalog and the metrics doc"

    def documented(self, snap) -> set:
        return set(
            re.findall(
                r"`(karpenter_[a-z0-9_]+)`",
                snap.doc_text("docs", "torch", "metrics.md"),
            )
        )

    def check(self, snap, allowlist) -> List[Finding]:
        documented = self.documented(snap) | set(
            e for e in allowlist if isinstance(e, str)
        )
        out = []
        for info in snap.in_package():
            for node in ast.walk(info.tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REGISTRY_VERBS
                    and node.args
                ):
                    continue
                first = node.args[0]
                if not (
                    isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and first.value.startswith("karpenter_")
                ):
                    continue
                if first.value not in documented:
                    out.append(
                        self.finding(
                            info.rel, node.lineno,
                            f"{first.value!r} passed to "
                            f".{node.func.attr}() but absent from "
                            "docs/torch/metrics.md (run `python -m "
                            "karpenter_tpu_torch.tools.gen_metrics_doc`)",
                        )
                    )
        return out


_EVENT_VERBS = frozenset({"event", "emit"})
_EVENT_TYPE_RE = re.compile(r"[A-Z][A-Za-z0-9]*")


@register
class EventDocRule(Rule):
    """Rule 6: every ledger event-type literal emitted via
    ``Registry.event(...)`` / ``EventLedger.emit(...)`` appears in the
    observability design's taxonomy."""

    name = "event-doc"
    title = "ledger event types documented in the observability design"
    guards = "the decision-event taxonomy (SLOBreach, ... cannot ship dark)"

    def documented(self, snap) -> set:
        return set(
            re.findall(
                r"`([A-Z][A-Za-z0-9]*)`",
                snap.doc_text("docs", "designs", "observability.md"),
            )
        )

    def check(self, snap, allowlist) -> List[Finding]:
        documented = self.documented(snap) | set(
            e for e in allowlist if isinstance(e, str)
        )
        out = []
        for info in snap.in_package():
            for node in ast.walk(info.tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EVENT_VERBS
                    and node.args
                ):
                    continue
                first = node.args[0]
                if not (
                    isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and _EVENT_TYPE_RE.fullmatch(first.value)
                ):
                    continue
                if first.value not in documented:
                    out.append(
                        self.finding(
                            info.rel, node.lineno,
                            f"event type {first.value!r} passed to "
                            f".{node.func.attr}() but absent from "
                            "docs/designs/observability.md",
                        )
                    )
        return out


_STORE_FRAME_FILES = (
    "service/store_server.py",
    "state/remote.py",
    "service/shardrouter.py",
    "state/storelog.py",
)
_STORE_FRAME_KEYS = frozenset({"method", "type"})


@register
class StoreFrameRule(Rule):
    """Rule 10: every wire frame ``method``/``type`` literal the store
    plane sends must appear (backticked) in docs/designs/store-scale.md
    — the protocol-vocabulary doc-rot guard."""

    name = "store-frame"
    title = "store wire-frame vocabulary documented in the design doc"
    guards = "the reviewable mixed-version negotiation story"

    def documented(self, snap) -> set:
        return set(
            re.findall(
                r"`([a-z][a-z0-9_]*)`",
                snap.doc_text("docs", "designs", "store-scale.md"),
            )
        )

    def check(self, snap, allowlist) -> List[Finding]:
        documented = self.documented(snap) | set(
            e for e in allowlist if isinstance(e, str)
        )
        out = []
        for info in snap.in_package():
            if info.rel_in_pkg not in _STORE_FRAME_FILES:
                continue
            for node in ast.walk(info.tree):
                if not isinstance(node, ast.Dict):
                    continue
                for key, value in zip(node.keys, node.values):
                    if not (
                        isinstance(key, ast.Constant)
                        and key.value in _STORE_FRAME_KEYS
                        and isinstance(value, ast.Constant)
                        and isinstance(value.value, str)
                    ):
                        continue
                    if value.value not in documented:
                        out.append(
                            self.finding(
                                info.rel, value.lineno,
                                f"frame {key.value} literal "
                                f"{value.value!r} absent from "
                                "docs/designs/store-scale.md",
                            )
                        )
        return out
