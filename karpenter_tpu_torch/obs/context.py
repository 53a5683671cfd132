"""Trace-context propagation: one ID per reconcile tick, everywhere.

The operator mints a trace ID at the top of every reconcile tick
(`mint_trace_id`) and installs it as the PROCESS default (`set_tick`).
Everything that happens on behalf of that tick — controller reconcile
spans, solver phases, cloud retry attempts, ledger events, store RPCs —
reads `current_trace_id()` and stamps it, so one ID follows a pod from
arrival through nomination, launch, and the remote store write.

Two scopes, cheapest-possible reads:

- the **tick default** is a module global: the reconcile loop is
  single-threaded per operator, and worker threads spawned mid-tick
  (launch fan-out, interruption workers) inherit the tick's identity by
  reading the same global — exactly the correlation we want;
- `trace_context(tid)` installs a **thread-local override** for code
  that acts on behalf of a DIFFERENT timeline than the process's current
  tick: the store server handling a client's RPC adopts the CLIENT's
  trace ID for the duration of the dispatch, which is what stitches the
  two processes into one timeline.

IDs are deterministic by construction (`<identity-or-tick>-<seq>`): the
simulator's ledger and trace lines must be byte-identical across replays,
so nothing wall-clock or random may enter an ID.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

_local = threading.local()
_tick_id = ""


def mint_trace_id(seq: int, identity: str = "") -> str:
    """Deterministic per-tick trace ID.  `identity` distinguishes
    operators in multi-replica setups (the elector identity); the
    simulator's single operator has none, so sim IDs are `tick-NNNNNN`."""
    return f"{identity or 'tick'}-{seq:06d}"


def set_tick(trace_id: str) -> None:
    """Install the process-default trace ID (the operator, once per
    reconcile tick)."""
    global _tick_id
    _tick_id = trace_id


def current_trace_id() -> str:
    """The active trace ID: a thread-local override if one is installed
    (RPC servers adopting a client's context), else the tick default."""
    return getattr(_local, "trace_id", None) or _tick_id


@contextlib.contextmanager
def trace_context(trace_id: str) -> Iterator[None]:
    """Thread-local trace-ID override for the block (restores the prior
    override on exit).  An empty ID is a no-op installer: the block keeps
    reading the tick default."""
    prev = getattr(_local, "trace_id", None)
    _local.trace_id = trace_id or prev
    try:
        yield
    finally:
        _local.trace_id = prev
