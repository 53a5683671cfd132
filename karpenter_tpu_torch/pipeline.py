"""Pipelined reconcile schedule (docs/designs/pipelined-reconcile.md).

The operator's tick is a fixed controller sequence; run strictly
sequentially, its wall time is the SUM of every phase even though the
device is idle during host phases and the host is idle while the device
scores consolidation masks.  This module is the ONE seam that overlaps
them: each controller declares its stages —

- **mutate** (always): the ordinary ``reconcile()``, run in the
  canonical sequence position.  All state mutation happens here.
- **dispatch** (optional, pipelined mode only): a read-only speculative
  stage run at the END of the tick, after every mutate stage — async
  device enqueues only, so the device works through the tick tail, the
  inter-tick sleep, and the next tick's host phases.
- **advance** (optional, pipelined mode only): run at the START of the
  next tick, before any mutate stage — the controller fetches what the
  dispatch stage enqueued and chains the next async round, so the device
  stays busy under the next provisioning solve.

The JOIN is a hard barrier inside the controller's own mutate stage: a
staged controller must validate that the state its speculation read is
still current (a fingerprint over everything the speculative compute
consumed) and otherwise discard it and recompute synchronously — which
is exactly what makes pipelining on/off take IDENTICAL actions tick for
tick (tests/test_pipeline.py proves it).  Sim mode runs with ``enabled=False``: the schedule
degrades to the plain sequential order bit for bit, so byte-compared
traces never contain speculative work.

This module is also the sanctioned home for thread construction in the
controller layer: :func:`run_concurrently` is the one fan-out primitive
(lint rule 11 fences raw ``ThreadPoolExecutor``/``Thread`` construction
in controllers/operator to this seam).

The admission fast path (scheduling/fastpath.py) needs no stage of its
own: a fast-path nomination happens INSIDE the provisioner's mutate
stage, in the canonical sequence position, exactly where the batched
solve would have nominated — so the disruption controller's speculation
fingerprints (which hash cluster state AFTER the provisioning slot)
observe identical state whether an arrival took the fast or the batched
path, and pipelining composes with the fast path with no new join.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence
from karpenter_tpu_torch.utils.locks import note_blocking

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class StageSpec:
    """One controller's declared stages.  ``name`` labels metrics/spans;
    ``dispatch``/``advance`` are the optional pipelined hooks (bound
    methods; None = a plain sequential controller)."""

    name: str
    controller: object
    dispatch: Optional[Callable[[], None]] = None
    advance: Optional[Callable[[], None]] = None


class TickPipeline:
    """Runs one tick over the declared stage sequence.

    ``enabled=False`` (the simulator, ``enable_pipelined_reconcile``
    off) runs ONLY the mutate stages, in declaration order — the exact
    sequential schedule every PR before this one ran, bit for bit.
    ``enabled=True`` brackets that same mutate order with the advance
    hooks (tick start) and dispatch hooks (tick end).

    Speculative stages are crash-contained here: a raising dispatch or
    advance hook is logged and counted, and the tick proceeds — the
    controller's mutate stage simply finds no (valid) speculation and
    recomputes synchronously, so a speculation bug can degrade latency
    but never actions.
    """

    def __init__(self, specs: Sequence[StageSpec], registry, tracer,
                 enabled: bool = False):
        self.specs = list(specs)
        self.registry = registry
        self.tracer = tracer
        self.enabled = enabled

    def run(self, reconcile: Callable[[str, object], None],
            gate: Callable[[], bool],
            ready: Optional[Callable[[str], bool]] = None) -> bool:
        """One tick: ``reconcile(name, controller)`` is the operator's
        crash-contained mutate runner; ``gate()`` False aborts between
        stages (mid-tick leadership loss must stop before the next
        mutation — speculative stages are read-only but skipped too:
        a non-leader must not burn device time scoring a cluster it no
        longer owns).  ``ready(name)`` False skips a controller's
        speculative stages only (a controller sitting in crash-requeue
        backoff will not consume what they produce, so speculating for
        it is pure waste; its mutate stage keeps its own backoff
        check).  Returns False when the gate aborted the tick."""
        ready = ready or (lambda _name: True)
        if self.enabled:
            for spec in self.specs:
                if spec.advance is None or not ready(spec.name):
                    continue
                if not gate():
                    return False
                self._speculative(spec, "advance", spec.advance)
        for spec in self.specs:
            if not gate():
                return False
            reconcile(spec.name, spec.controller)
        if self.enabled:
            for spec in self.specs:
                if spec.dispatch is None or not ready(spec.name):
                    continue
                if not gate():
                    return False
                self._speculative(spec, "dispatch", spec.dispatch)
        return True

    def _speculative(self, spec: StageSpec, stage: str,
                     fn: Callable[[], None]) -> None:
        with self.tracer.span(f"pipeline.{stage}.{spec.name}"):
            try:
                fn()
            except Exception:
                self.registry.inc(
                    "karpenter_pipeline_stage_errors_total",
                    {"controller": spec.name, "stage": stage},
                )
                log.exception(
                    "pipelined %s stage of %s failed; tick continues "
                    "sequentially", stage, spec.name,
                )


def run_concurrently(calls: List[Callable[[], object]],
                     max_workers: int) -> List[Optional[Exception]]:
    """Run ``calls`` and return each one's raised exception (None on
    success), preserving submission order.  ``max_workers <= 1`` runs
    serially in order on the calling thread — the determinism knob the
    simulator uses (thread scheduling must never order a byte-compared
    cloud-call stream).  The ONE sanctioned thread-pool constructor for
    the controller layer (lint rule 11)."""

    def outcome(fn) -> Optional[Exception]:
        try:
            fn()
            return None
        except Exception as exc:
            return exc

    if max_workers <= 1 or len(calls) <= 1:
        return [outcome(fn) for fn in calls]
    # runtime blocking witness (analysis/sanitizer.py): joining a
    # fan-out while holding a lock is the convoy class the static
    # lock-blocking rule fences; sanitized runs observe it here
    note_blocking("run_concurrently")
    with ThreadPoolExecutor(
        max_workers=min(max_workers, len(calls))
    ) as pool:
        futures = [pool.submit(fn) for fn in calls]
        return [outcome(fut.result) for fut in futures]
