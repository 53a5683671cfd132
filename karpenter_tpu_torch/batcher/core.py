"""Request coalescing (reference pkg/batcher/batcher.go:63-120).

Concurrent identical cloud calls merge into one: requests hash into
buckets; a bucket flushes when `idle_s` passes with no new arrivals, when
`max_s` elapses since the first request, or when `max_items` accumulate.
One worker thread per bucket executes the merged call and fans results
back out to the waiting callers.

Window defaults mirror the reference: CreateFleet 35ms idle / 1s max /
1000 items (createfleet.go:35-37), DescribeInstances and
TerminateInstances 100ms / 1s / 500 (describeinstances.go:38-40,
terminateinstances.go:38-40).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple
from karpenter_tpu_torch.utils.locks import make_condition, make_lock

CREATE_FLEET_WINDOWS = (0.035, 1.0, 1000)
DESCRIBE_WINDOWS = (0.1, 1.0, 500)
TERMINATE_WINDOWS = (0.1, 1.0, 500)


@dataclass
class CoalesceWindow:
    """The idle/max coalescing deadline arithmetic, time-source-agnostic.

    One definition shared by BOTH batching layers: the cloud-call buckets
    below (wall-clock `time.monotonic`) and the provisioner's pod batch
    window (the injected Clock — controllers/provisioning.PodBatcher), so
    the reference's "1s idle / 10s max pod batching, 35ms idle / 1s max
    CreateFleet coalescing" discipline has exactly one implementation.

    A window OPENS at the first arrival and CLOSES when `idle_s` passes
    with no new arrivals or `max_s` elapses since the first one; callers
    that also cap by item count check that themselves (the deadline is
    pure time arithmetic).
    """

    idle_s: float
    max_s: float
    first_at: Optional[float] = None
    last_at: Optional[float] = None

    @property
    def open(self) -> bool:
        return self.first_at is not None

    def observe(self, now: float, fresh: bool = True) -> None:
        """An arrival at `now`; `fresh=False` re-observations (the same
        pending pods seen again next tick) do not push the idle deadline."""
        if self.first_at is None:
            self.first_at = now
            self.last_at = now
        elif fresh:
            self.last_at = now

    def deadline(self) -> float:
        assert self.first_at is not None and self.last_at is not None
        return min(self.last_at + self.idle_s, self.first_at + self.max_s)

    def ready(self, now: float) -> bool:
        return self.open and now >= self.deadline()

    def reset(self) -> None:
        self.first_at = self.last_at = None


@dataclass
class BatchStats:
    """Running totals; per-batch distributions live in the metrics
    registry (karpenter_cloudprovider_batcher_batch_size/_time_seconds,
    reference batcher/metrics.go)."""

    batches: int = 0
    items: int = 0

    def record(self, size: int) -> None:
        self.batches += 1
        self.items += size


class Batcher:
    """Generic request batcher.

    ``executor(requests) -> list[result]`` receives the merged bucket (in
    arrival order) and returns one result per request (or raises — the
    exception fans out to every waiter).  ``hasher(request)`` routes
    requests that cannot be merged into separate buckets (e.g.
    DescribeInstances calls with different filters,
    describeinstances.go:44-55).
    """

    def __init__(
        self,
        executor: Callable[[Sequence[Any]], Sequence[Any]],
        idle_s: float = 0.035,
        max_s: float = 1.0,
        max_items: int = 1000,
        hasher: Callable[[Any], Hashable] = lambda _req: 0,
        name: str = "batcher",
        registry=None,
    ):
        self.executor = executor
        self.idle_s = idle_s
        self.max_s = max_s
        self.max_items = max_items
        self.hasher = hasher
        self.name = name
        self.stats = BatchStats()
        # exported as karpenter_cloudprovider_batcher_batch_size /
        # _batch_time_seconds{batcher} (reference pkg/batcher/metrics.go)
        if registry is None:
            from karpenter_tpu_torch.metrics.registry import REGISTRY as registry
        self.registry = registry
        self._lock = make_lock("Batcher._lock")
        self._buckets: Dict[Hashable, _Bucket] = {}

    def submit(self, request: Any) -> Future:
        """Queue a request; the returned Future resolves to its result."""
        key = self.hasher(request)
        fut: Future = Future()
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None or bucket.closed:
                bucket = _Bucket(self, key)
                self._buckets[key] = bucket
                bucket.add(request, fut)
                bucket.start()
            else:
                bucket.add(request, fut)
        return fut

    def call(self, request: Any) -> Any:
        """Submit and wait (convenience for synchronous callers)."""
        return self.submit(request).result()

    def _detach(self, key: Hashable, bucket: "_Bucket") -> None:
        with self._lock:
            if self._buckets.get(key) is bucket:
                del self._buckets[key]


class _Bucket:
    def __init__(self, parent: Batcher, key: Hashable):
        self.parent = parent
        self.key = key
        self.items: List[Tuple[Any, Future]] = []
        self.closed = False
        self._cv = make_condition("_Bucket._cv")
        self._window = CoalesceWindow(parent.idle_s, parent.max_s)
        self._window.observe(time.monotonic())

    def add(self, request: Any, fut: Future) -> None:
        with self._cv:
            self.items.append((request, fut))
            self._window.observe(time.monotonic())
            if len(self.items) >= self.parent.max_items:
                self.closed = True
            self._cv.notify()

    def start(self) -> None:
        threading.Thread(target=self._run, daemon=True, name=self.parent.name).start()

    def _run(self) -> None:
        with self._cv:
            while not self.closed:
                now = time.monotonic()
                if self._window.ready(now):
                    self.closed = True
                    break
                self._cv.wait(timeout=self._window.deadline() - now)
        self.parent._detach(self.key, self)
        requests = [r for r, _ in self.items]
        futures = [f for _, f in self.items]
        self.parent.stats.record(len(requests))
        labels = {"batcher": self.parent.name}
        self.parent.registry.observe(
            "karpenter_cloudprovider_batcher_batch_size", len(requests), labels
        )
        self.parent.registry.observe(
            "karpenter_cloudprovider_batcher_batch_time_seconds",
            time.monotonic() - (self._window.first_at or 0.0),
            labels,
        )
        try:
            results = self.parent.executor(requests)
            if len(results) != len(requests):
                raise RuntimeError(
                    f"{self.parent.name}: executor returned {len(results)} "
                    f"results for {len(requests)} requests"
                )
            for fut, res in zip(futures, results):
                fut.set_result(res)
        except Exception as exc:  # fan the failure out to every caller
            for fut in futures:
                if not fut.done():
                    fut.set_exception(exc)


class WeightedRoundRobin:
    """Deterministic smooth weighted round-robin over named queues.

    The fairness half of the multi-tenant SolverService's admission plane
    (docs/designs/solver-service.md): when a coalescing window closes with
    more queued solves than one batch can carry, the drain order decides
    who rides the next dispatch — and a tenant flooding requests at 10x
    the others' rate must not buy itself 10x the batch slots.

    Smooth WRR (the nginx upstream discipline): every pick, each candidate
    accrues its weight; the highest accumulated credit wins and pays back
    the total.  Over any window, a candidate's share of picks converges to
    weight/total, and between two picks of one candidate every other
    candidate with comparable weight is picked — bounded burstiness, not
    just bounded share.  Ties break by sorted name, so the schedule is a
    pure function of (pick history, candidate sets) — the determinism the
    fleet sim's tape discipline demands.  Not thread-safe; callers hold
    their own admission lock.
    """

    def __init__(self):
        self._credit: Dict[Hashable, float] = {}

    def select(self, weights: Dict[Hashable, float]) -> Hashable:
        """One pick among ``weights`` (name -> positive weight)."""
        if not weights:
            raise ValueError("select from no candidates")
        total = sum(weights.values())
        best = None
        for name in sorted(weights, key=str):
            cur = self._credit.get(name, 0.0) + weights[name]
            self._credit[name] = cur
            if best is None or cur > self._credit[best]:
                best = name
        self._credit[best] -= total
        return best

    def drain(
        self,
        queues: Dict[Hashable, Any],
        limit: int,
        weights: Optional[Dict[Hashable, float]] = None,
    ) -> List[Tuple[Hashable, Any]]:
        """Pop up to ``limit`` items from the named queues (anything with
        ``popleft`` and truthiness, e.g. collections.deque) in smooth-WRR
        order; missing weights default to 1.0.  Returns (name, item)
        pairs in drain order."""
        out: List[Tuple[Hashable, Any]] = []
        while len(out) < limit:
            cands = {
                n: (weights or {}).get(n, 1.0)
                for n, q in queues.items()
                if q
            }
            if not cands:
                break
            pick = self.select(cands)
            out.append((pick, queues[pick].popleft()))
        return out

    def forget(self, name: Hashable) -> None:
        """Drop a departed tenant's credit so its name's return starts
        fresh instead of inheriting stale debt."""
        self._credit.pop(name, None)
