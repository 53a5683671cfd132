"""Runtime concurrency sanitizer: the dynamic half of the lock plane.

The static analyzers (locks.py) prove ordering and blocking discipline
over the edges the AST can resolve; this module witnesses what the
threads actually DO — the TSan/lockdep/Eraser lineage:

- **Lock-order witness**: instrumented ``Lock``/``RLock``/``Condition``
  wrappers record, per thread, the stack of held locks; every first
  acquisition under held locks adds ``held -> new`` edges to a runtime
  order graph.  A pair acquired in both orders anywhere in the run is an
  ``rt-lock-order`` finding — the same pairwise inversion semantics as
  the static ``lock-order`` rule, over observed rather than predicted
  edges.
- **Blocking witness**: the package's blocking seams (socket frame I/O,
  ``_rpc``, payload encodes, the ``run_concurrently`` join — exactly the
  vocabulary locks.py names) call :func:`note_blocking`; a blocking op
  executed while the thread holds a non-sanctioned lock is an
  ``rt-lock-blocking`` finding.
- **Eraser lockset**: annotated shared state (store maps, subscriber
  queues, the pipeline speculation slot, the observatory merge dict)
  calls :func:`note_access`; a field touched from >= 2 threads whose
  candidate lockset intersection goes empty with a writer involved is an
  ``rt-race`` finding.

**The construction seam.**  ``make_lock(name)`` / ``make_rlock(name)`` /
``make_condition(name, lock)`` is the ONE place the package constructs
its synchronization primitives (the ``lock-seam`` lint rule fences raw
``threading.Lock()`` construction the way rule 11 fences raw threads to
``run_concurrently``).  ``name`` must be the lock's static identity —
``"Class.attr"`` exactly as locks.py discovers it (lint-checked) — which
is what makes the runtime witness and the static model speak the same
vocabulary and cross-validation (analysis/witness.py) meaningful.

**Production default: off.**  With no sanitizer enabled the seam returns
the stdlib classes themselves — not wrappers with a fast path, the very
objects ``threading`` hands out — so steady-state cost is zero beyond
one ``is None`` test at construction time; ``note_blocking`` and
``note_access`` are a module-global load and a branch.  Enabled (the
sanitized test suites, ``Settings.enable_lock_sanitizer``), every
acquisition pays a thread-local update plus, on first acquisition, a
stack walk for the site string — measured by the
``sanitizer_lock_overhead`` bench line.

Everything serialized is deterministic: lock names, repo-relative site
strings, sorted JSON — never thread ids, wall-clock stamps, or object
addresses (witness.py holds the artifact contract).

The deadlock watchdog (:class:`LockWatchdog`) reuses the same holder
table: an optional thread that, when EVERY currently-held lock has been
held past a stall threshold, hands the live lock graph to a callback
(the operator dumps it next to a flight record) — a production
``hung tick`` postmortem artifact, not a test assertion.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.analysis.core import Finding
from karpenter_tpu_torch.analysis.witness import Witness

# the active sanitizer, None in production.  Module-global on purpose:
# the seams (note_blocking in codec/remote/pipeline) must be reachable
# without constructor plumbing through every layer, exactly like the
# device OBSERVATORY.
_ACTIVE: Optional["LockSanitizer"] = None


def current() -> Optional["LockSanitizer"]:
    return _ACTIVE


def enable(scenario: str = "default") -> "LockSanitizer":
    """Install a fresh sanitizer.  Locks constructed from here on are
    wrapped; locks constructed before stay stdlib (enable BEFORE
    building the object graph under test)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(
            "lock sanitizer already enabled; disable() the previous one "
            "(nesting would split the witness across two graphs)"
        )
    _ACTIVE = LockSanitizer(scenario)
    return _ACTIVE


def disable() -> Optional["LockSanitizer"]:
    """Uninstall and return the active sanitizer (its witness stays
    readable; already-wrapped locks keep recording into it, which is
    fine for teardown races — the artifact is read after join)."""
    global _ACTIVE
    san = _ACTIVE
    _ACTIVE = None
    return san


# ------------------------------------------------------------------ seam
def make_lock(name: str):
    """``threading.Lock()``, instrumented when a sanitizer is active.
    ``name`` is the lock's static identity ("Class.attr", lint-checked
    against the assignment site)."""
    san = _ACTIVE
    if san is None:
        return threading.Lock()
    return _SanitizedLock(san, name, threading.Lock())


def make_rlock(name: str):
    san = _ACTIVE
    if san is None:
        return threading.RLock()
    return _SanitizedRLock(san, name, threading.RLock())


def make_condition(name: str, lock=None):
    """``threading.Condition(lock)``.  A condition over a sanitized lock
    aliases onto that lock's identity (the ``_Subscriber.cond`` ==
    ``VersionedStore.lock`` relationship LOCK_ALIASES declares for the
    static model) — waiting releases it, waking re-acquires it, and the
    witness sees one lock, not two."""
    san = _ACTIVE
    if san is None:
        return threading.Condition(lock)
    if isinstance(lock, (_SanitizedLock, _SanitizedRLock)):
        inner = threading.Condition(lock._inner)
        return _SanitizedCondition(san, lock.name, inner)
    inner = threading.Condition(lock)
    return _SanitizedCondition(san, name, inner)


# the blocking-op vocabulary mirrors locks.BLOCKING_CALLS: these are the
# seams that actually call note_blocking (socket frame I/O, the store
# RPC, payload encodes, the fan-out join)
def note_blocking(op: str) -> None:
    """Called by the package's blocking seams.  No-op unless sanitized."""
    san = _ACTIVE
    if san is not None:
        san._note_blocking(op)


def note_access(fieldname: str, write: bool = True) -> None:
    """Eraser lockset annotation for one shared field ("Class.attr").
    Called at the field's touch points.  No-op unless sanitized."""
    san = _ACTIVE
    if san is not None:
        san._note_access(fieldname, write)


# ------------------------------------------------------------- wrappers
class _SanitizedLock:
    """Drop-in ``threading.Lock`` recording into the sanitizer."""

    __slots__ = ("_san", "name", "_inner")

    def __init__(self, san: "LockSanitizer", name: str, inner):
        self._san = san
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san._note_acquire(self.name)
        return got

    def release(self) -> None:
        self._san._note_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _SanitizedRLock(_SanitizedLock):
    """Reentrant variant: the sanitizer tracks per-thread hold counts,
    so only the 0->1 acquisition records edges and only the 1->0 release
    pops the held stack."""

    __slots__ = ()

    def locked(self) -> bool:  # RLock has no .locked() pre-3.12
        return self._san._held_somewhere(self.name)


class _SanitizedCondition:
    """Wraps a real Condition built over the REAL underlying lock (so
    the stdlib wait/notify machinery is untouched) and mirrors the
    acquire/release bookkeeping under the aliased lock name.  ``wait``
    releases every reentrant hold and restores it on wake, exactly as
    ``Condition._release_save`` does underneath."""

    __slots__ = ("_san", "name", "_inner")

    def __init__(self, san: "LockSanitizer", name: str, inner):
        self._san = san
        self.name = name
        self._inner = inner

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            self._san._note_acquire(self.name)
        return got

    def release(self) -> None:
        self._san._note_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        saved = self._san._note_release_all(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            if saved:
                self._san._note_acquire(self.name, count=saved)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        saved = self._san._note_release_all(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            if saved:
                self._san._note_acquire(self.name, count=saved)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# ------------------------------------------------------------ the brain
class _FieldState:
    """Eraser state machine for one annotated field.

    virgin -> exclusive (first thread; init pattern, no refinement) ->
    shared (second thread reads) / shared-modified (any later write).
    The candidate lockset starts as the held set at the FIRST
    cross-thread access and intersects on every access after; an empty
    lockset in shared-modified is a race (reported once)."""

    __slots__ = ("state", "first_thread", "lockset", "threads", "writers",
                 "raced")

    def __init__(self):
        self.state = "virgin"
        self.first_thread: Optional[int] = None
        self.lockset: Optional[frozenset] = None  # None = not yet shared
        self.threads = 0
        self.writers = 0
        self.raced = False


class LockSanitizer:
    """One sanitized run's recording state.  All shared tables live
    under a RAW ``threading.Lock`` (wrapping the sanitizer's own mutex
    in itself would recurse; the lock-seam allowlist names this
    construction)."""

    def __init__(self, scenario: str = "default"):
        self.scenario = scenario
        self._mu = threading.Lock()
        self._tls = threading.local()
        # stable per-thread tokens, assigned at first touch: OS thread
        # idents are REUSED the moment a thread exits (a writer that
        # finishes before its sibling starts can hand its ident over,
        # collapsing two threads into "one" for the lockset algorithm),
        # so thread identity lives in the thread-local, which dies with
        # the thread and is never recycled
        self._tid_counter = itertools.count(1)
        # (outer, inner) -> sorted-on-read set of site strings
        self._edges: Dict[Tuple[str, str], set] = {}
        # (op, heldtuple, site, allowed) observation dedup
        self._blocking: Dict[Tuple[str, Tuple[str, ...], str], bool] = {}
        self._fields: Dict[str, _FieldState] = {}
        self._locks: set = set()
        self._field_threads: Dict[str, set] = {}
        self._field_writers: Dict[str, set] = {}
        # (lock name, site) of releases by threads that never acquired
        # — cross-thread ownership handoff the bookkeeping cannot track
        self._foreign_releases: set = set()
        # live holds for the watchdog: (thread token, lock name) ->
        # (thread name, since-monotonic-seconds); never serialized into
        # the witness
        self._holds: Dict[Tuple[int, str], Tuple[str, float]] = {}
        # sanctioned blocking regions: a lock that EXISTS to serialize
        # the blocking op (the one-in-flight-RPC pattern); populated
        # from allowlists.SANITIZER_BLOCKING_LOCKS
        from karpenter_tpu_torch.analysis.allowlists import (
            SANITIZER_BLOCKING_LOCKS,
        )

        self._blocking_ok = frozenset(SANITIZER_BLOCKING_LOCKS)

    # ---------------------------------------------------------- per-thread
    def _state(self):
        st = getattr(self._tls, "state", None)
        if st is None:
            st = {
                "held": [],
                "counts": {},
                "tid": next(self._tid_counter),
                "name": threading.current_thread().name,
            }
            self._tls.state = st
        return st

    @staticmethod
    def _site() -> Tuple[str, int]:
        """(repo-relative file, line) of the first frame outside this
        module — the acquisition/annotation site.  Deterministic across
        runs (code locations, not addresses)."""
        f = sys._getframe(2)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:  # pragma: no cover - only if called at module top
            return "?", 0
        fname = f.f_code.co_filename.replace("\\", "/")
        idx = fname.rfind("karpenter_tpu_torch/")
        rel = fname[idx:] if idx >= 0 else fname.rsplit("/", 1)[-1]
        return f"{rel}:{f.f_code.co_name}", f.f_lineno

    # ------------------------------------------------------------ recording
    def _note_acquire(self, name: str, count: int = 1) -> None:
        st = self._state()
        counts = st["counts"]
        prev = counts.get(name, 0)
        counts[name] = prev + count
        if prev:
            return  # reentrant re-acquire: no new edges, no new hold
        held: List[str] = st["held"]
        site = self._site()[0] if held else ""
        with self._mu:  # one round trip: edges + lock set + holder table
            self._locks.add(name)
            for h in held:
                if h != name:
                    self._edges.setdefault((h, name), set()).add(site)
            self._holds[(st["tid"], name)] = (
                st["name"], time.monotonic()
            )
        held.append(name)

    def _note_release(self, name: str) -> None:
        st = self._state()
        counts = st["counts"]
        prev = counts.get(name, 0)
        if prev == 0:
            # released on a thread that never acquired it (ownership
            # handoff — legal for threading.Lock, but it would corrupt
            # the per-thread bookkeeping silently): record loudly as an
            # anomaly finding instead of emitting wrong edges forever
            site, _line = self._site()
            with self._mu:
                self._foreign_releases.add((name, site))
            return
        if prev > 1:
            counts[name] = prev - 1
            return
        counts.pop(name, None)
        held: List[str] = st["held"]
        # locks are normally released LIFO, but non-nested release is
        # legal — remove by value from the tail
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break
        with self._mu:
            self._holds.pop((st["tid"], name), None)

    def _note_release_all(self, name: str) -> int:
        """Condition.wait: drop EVERY reentrant hold of ``name`` for
        this thread, returning the count to restore on wake (0 when the
        thread held nothing — stdlib wait() raises in that case and no
        bookkeeping must be restored)."""
        st = self._state()
        saved = st["counts"].get(name, 0)
        if saved:
            st["counts"][name] = 1
            self._note_release(name)
        return saved

    def _held_somewhere(self, name: str) -> bool:
        with self._mu:
            keys = list(self._holds)
        return any(k[1] == name for k in keys)

    def _note_blocking(self, op: str) -> None:
        st = self._state()
        held = tuple(st["held"])
        if not held:
            return
        site, _line = self._site()
        # sanctioned ONLY when every held lock is sanctioned: holding a
        # one-in-flight RPC lock must not launder an unrelated outer
        # lock (the convoy the finding exists to catch is exactly
        # blocking-op-under-SOME-unsanctioned-lock)
        allowed = all(h in self._blocking_ok for h in held)
        with self._mu:
            self._blocking[(op, held, site)] = allowed

    def _note_access(self, fieldname: str, write: bool) -> None:
        st = self._state()
        held = frozenset(st["held"])
        ident = st["tid"]
        with self._mu:
            fs = self._fields.get(fieldname)
            if fs is None:
                fs = _FieldState()
                self._fields[fieldname] = fs
                self._field_threads[fieldname] = set()
                self._field_writers[fieldname] = set()
            self._field_threads[fieldname].add(ident)
            if write:
                self._field_writers[fieldname].add(ident)
            if fs.state == "virgin":
                fs.state = "exclusive"
                fs.first_thread = ident
                return
            if fs.state == "exclusive" and ident == fs.first_thread:
                return  # init pattern: same thread, no refinement
            # a second thread arrived (or sharing already began):
            # candidate lockset = intersection of held sets from the
            # first cross-thread access on
            fs.lockset = held if fs.lockset is None else fs.lockset & held
            if write:
                fs.state = "shared-modified"
            elif fs.state != "shared-modified":
                fs.state = "shared"
            if fs.state == "shared-modified" and not fs.lockset:
                fs.raced = True

    # -------------------------------------------------------------- reports
    def live_holds(self) -> List[dict]:
        """The watchdog's view: every currently-held lock with its hold
        age.  Thread identity is the thread NAME (stable for named test
        threads; informative either way) — never the id."""
        now = time.monotonic()
        with self._mu:
            holds = dict(self._holds)
        return [
            {
                "lock": name,
                "thread": tname,
                "held_s": round(now - since, 3),
            }
            for (_tid, name), (tname, since) in sorted(
                holds.items(),
                key=lambda kv: (kv[0][1], kv[1][0], kv[0][0]),
            )
        ]

    def findings(self) -> List[Finding]:
        """The run's verdict, Finding-shaped so the sanitized suites
        assert on it exactly like the lint gate asserts on rules."""
        out: List[Finding] = []
        with self._mu:
            edges = {k: sorted(v) for k, v in self._edges.items()}
            blocking = dict(self._blocking)
            fields = {
                f: (fs, sorted(self._field_threads[f]),
                    sorted(self._field_writers[f]))
                for f, fs in self._fields.items()
            }
        for (a, b), sites in sorted(edges.items()):
            if (b, a) not in edges or a >= b:
                continue
            rsites = sorted(edges[(b, a)])
            rel = sites[0].split(":", 1)[0]
            out.append(
                Finding(
                    rule="rt-lock-order",
                    file=rel,
                    line=0,
                    message=(
                        f"runtime lock order inversion: {a} -> {b} "
                        f"(at {sites[0]}) but {b} -> {a} "
                        f"(at {rsites[0]}) — two live threads took "
                        "these locks in opposite orders"
                    ),
                )
            )
        for (op, held, site), allowed in sorted(blocking.items()):
            if allowed:
                continue
            rel = site.split(":", 1)[0]
            out.append(
                Finding(
                    rule="rt-lock-blocking",
                    file=rel,
                    line=0,
                    message=(
                        f"blocking op {op}(...) executed at {site} while "
                        f"holding {', '.join(held)} — observed at "
                        "runtime, not just reachable"
                    ),
                )
            )
        with self._mu:
            foreign = sorted(self._foreign_releases)
        for name, site in foreign:
            rel = site.split(":", 1)[0]
            out.append(
                Finding(
                    rule="rt-foreign-release",
                    file=rel,
                    line=0,
                    message=(
                        f"{name} released at {site} by a thread that "
                        "never acquired it — cross-thread lock handoff "
                        "the witness cannot track; its edges and holds "
                        "for this lock are unreliable from here on"
                    ),
                )
            )
        for fname, (fs, threads, writers) in sorted(fields.items()):
            if fs.raced:
                out.append(
                    Finding(
                        rule="rt-race",
                        file="karpenter_tpu_torch/analysis/sanitizer.py",
                        line=0,
                        message=(
                            f"lockset race on {fname}: touched by "
                            f"{len(threads)} threads "
                            f"({len(writers)} writing) with an EMPTY "
                            "common lockset — no single lock protects "
                            "every access"
                        ),
                    )
                )
        return sorted(out)

    def witness(self) -> Witness:
        """The deterministic artifact (witness.py owns the contract)."""
        with self._mu:
            edges = {k: sorted(v) for k, v in self._edges.items()}
            blocking = dict(self._blocking)
            locks = sorted(self._locks)
            fields = {
                f: (fs, len(self._field_threads[f]),
                    len(self._field_writers[f]))
                for f, fs in self._fields.items()
            }
        return Witness(
            scenario=self.scenario,
            locks=locks,
            edges=[
                {"outer": a, "inner": b, "sites": sites}
                for (a, b), sites in sorted(edges.items())
            ],
            blocking=[
                {
                    "op": op,
                    "locks": list(held),
                    "site": site,
                    "allowed": allowed,
                }
                for (op, held, site), allowed in sorted(blocking.items())
            ],
            fields=[
                {
                    "field": f,
                    "state": fs.state,
                    "lockset": (
                        sorted(fs.lockset) if fs.lockset is not None
                        else None
                    ),
                    "threads": nthreads,
                    "writers": nwriters,
                }
                for f, (fs, nthreads, nwriters) in sorted(fields.items())
            ],
            findings=[f.to_dict() for f in self.findings()],
        )


# ----------------------------------------------------------- the watchdog
class LockWatchdog:
    """Production deadlock watchdog over the sanitizer's holder table.

    Fires ``on_stall(report)`` when locks are held and EVERY current
    holder has been stuck past ``stall_s`` — the all-holders-stalled
    shape of a deadlock or a wedged tick, as opposed to one long busy
    critical section among healthy ones.  One report per episode: it
    re-arms only after the stalled hold-set changes.  The thread is
    constructed HERE (analysis/, outside the thread-seam fence) so the
    operator only starts/stops it."""

    def __init__(
        self,
        sanitizer: LockSanitizer,
        stall_s: float,
        on_stall: Callable[[dict], None],
        interval_s: Optional[float] = None,
    ):
        self.sanitizer = sanitizer
        self.stall_s = stall_s
        self.on_stall = on_stall
        self.interval_s = interval_s or max(0.1, stall_s / 4.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_fired: Optional[frozenset] = None

    def check(self, now: Optional[float] = None) -> Optional[dict]:
        """One poll (exposed for deterministic tests).  Returns the
        stall report when it fires, else None."""
        now = time.monotonic() if now is None else now
        with self.sanitizer._mu:
            holds = dict(self.sanitizer._holds)
        if not holds:
            self._last_fired = None
            return None
        ages = [now - since for (_tname, since) in holds.values()]
        if min(ages) < self.stall_s:
            self._last_fired = None
            return None
        key = frozenset(holds)
        if key == self._last_fired:
            return None  # same episode, already reported
        self._last_fired = key
        report = {
            "stall_s": self.stall_s,
            "holds": self.sanitizer.live_holds(),
            "witness_fingerprint": self.sanitizer.witness().fingerprint,
        }
        self.on_stall(report)
        return report

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="lock-watchdog", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:  # pragma: no cover - must never kill the
                pass  # process it is diagnosing

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
