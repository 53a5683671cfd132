"""Device observatory: launch, transfer and resident-memory telemetry for
the on-device hot path.

The port of ``karpenter_tpu/obs/device.py`` onto PyTorch and the
hand-written CUDA kernels.  It owns the same three seams and exports the
same ``karpenter_device_*`` families with the same labels:

- :meth:`DeviceObservatory.dispatch` — every kernel entry point (the pack,
  the verdict batch, the population round, the resident delta step) is
  invoked through this seam.  It counts the launch under its name, records
  a ``device.<fn>`` span, and keys the launch by its signature: the name
  with each tensor argument's shape, dtype and device, every other argument
  by value.  There is no jit cache on this side: the first launch of a
  signature stands where the reference counts a compile (its
  ``_jit_cache_size`` growth), and it is warm when the function was first
  launched in an earlier tick.  The one real compile, the ``nvcc`` build of
  a CUDA library (``ops/_build.py``), is reported by :meth:`record_build`
  and exported as ``karpenter_device_compile_seconds{fn=<source>}`` once a
  process.
- :meth:`DeviceObservatory.put` — the ONE counted upload: a host array
  (numpy or a CPU tensor) copied into a fresh allocation on the target
  device.  Its bytes count under the caller's site whatever the device, so
  a CPU run counts what the card run counts.  Site names follow the
  reference's (``resident_seed``, ``resident_delta``,
  ``pack_kernel_buffered``, ``pack_constants``, ``removal_base``,
  ``population_tensors``, ``population_verdict_kernel``,
  ``removal_verdict_kernel``), where the reference counts jit-argument
  uploads under the dispatch's name.
- the resident hooks (:meth:`set_resident_footprint`,
  :meth:`count_resident_update`) — ``ops/resident.py`` reports its live
  device footprint per consumer and whether an update reused the resident
  buffers (``donated``), re-seeded (``seed``) or changed nothing
  (``noop``).

Process totals feed the operator's tick tail (:func:`export_device_metrics`,
:meth:`tick_section`); scopes (:meth:`begin_scope`) give a caller counters
of its own window.  With ``enabled = False`` every seam passes through
with nothing counted.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.utils.locks import make_lock, note_access
from karpenter_tpu_torch.utils.trace import TRACER


def _sig_part(v) -> tuple:
    """One argument's contribution to a launch signature: tensors and
    arrays by (shape, dtype, device); strings, flags and None (static
    options such as the objective) by value; numbers by type, since the
    wrappers take data as host numbers (the first free slot, a span), as
    the reference's numpy scalars count by shape; anything else by type."""
    if isinstance(v, torch.Tensor):
        return ("a", tuple(v.shape), str(v.dtype), str(v.device))
    if isinstance(v, np.ndarray):
        return ("a", v.shape, str(v.dtype), "host")
    if isinstance(v, (str, bool, type(None))):
        return ("s", v)
    return ("t", type(v).__name__)


def dispatch_signature(args: tuple, kwargs: dict) -> tuple:
    return tuple(_sig_part(a) for a in args) + tuple(
        (k, _sig_part(kwargs[k])) for k in sorted(kwargs)
    )


def _nbytes(value) -> int:
    """Bytes of a numpy array or a tensor."""
    if isinstance(value, torch.Tensor):
        return int(value.numel() * value.element_size())
    return int(value.nbytes)


def upload(value, device) -> torch.Tensor:
    """A whole new allocation on ``device`` holding a copy of ``value``:
    never a view of the host array (on the CPU `torch.from_numpy` would
    alias it) and never an offset into a larger buffer (the scan wants
    ``feas`` 16-byte aligned)."""
    src = (
        value if isinstance(value, torch.Tensor)
        else torch.from_numpy(np.require(value, requirements=("C", "W")))
    )
    return torch.empty(src.shape, dtype=src.dtype, device=device).copy_(src)


class DeviceScope:
    """One accounting window: the process totals, or a caller's run.  All
    fields are counts and bytes except ``compile_s`` (wall seconds of the
    library builds, totals only)."""

    __slots__ = (
        "dispatches", "compiles", "compile_s", "warm_recompiles",
        "shapes", "transfer_bytes", "resident_updates",
    )

    def __init__(self):
        self.dispatches: Dict[str, int] = {}
        self.compiles: Dict[str, int] = {}  # new launch signatures
        self.compile_s: Dict[str, float] = {}  # library build seconds
        self.warm_recompiles: Dict[str, int] = {}
        self.shapes: Dict[str, set] = {}  # fn -> distinct launch signatures
        self.transfer_bytes: Dict[str, int] = {}  # site -> bytes
        self.resident_updates: Dict[str, int] = {}  # donated / seed / noop

    def unique_shapes(self) -> Dict[str, int]:
        return {fn: len(s) for fn, s in sorted(self.shapes.items())}


class DeviceObservatory:
    def __init__(self):
        self.enabled = True
        self._lock = make_lock("DeviceObservatory._lock")
        self.total = DeviceScope()
        self._scopes: List[DeviceScope] = []
        # warm-tick bookkeeping: the operator bumps the tick; a new
        # signature of a function first launched in an earlier tick is a
        # warm "recompile" (a fresh padded bucket, an axis change)
        self._tick = 0
        self._first_tick: Dict[str, int] = {}
        # compile events not yet drained by export: (fn, seconds or None,
        # warm); seconds only for a library build
        self._pending_compiles: List[Tuple[str, Optional[float], bool]] = []
        # per-owner resident footprints, weakly keyed: a cache dying with
        # its scheduler drops out of the reported footprint on its own
        self._resident_sources: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )
        # the totals at the top of the current tick
        self._tick_base: dict = self._base_snapshot()
        self._tick_detail_base: dict = self._detail_snapshot()

    # ------------------------------------------------------------- scopes
    def begin_scope(self) -> DeviceScope:
        scope = DeviceScope()
        with self._lock:
            self._scopes.append(scope)
        return scope

    def end_scope(self, scope: DeviceScope) -> DeviceScope:
        with self._lock:
            if scope in self._scopes:
                self._scopes.remove(scope)
        return scope

    def _all_scopes(self) -> List[DeviceScope]:
        return [self.total] + self._scopes

    # ------------------------------------------------------------- seams
    def dispatch(self, name: str, fn, *args, **kwargs):
        """Invoke a kernel entry point through the counted seam.  Returns
        whatever ``fn`` returns; disabled, a bare passthrough."""
        if not self.enabled:
            return fn(*args, **kwargs)
        sig = dispatch_signature(args, kwargs)
        with TRACER.span(f"device.{name}"):
            out = fn(*args, **kwargs)
        with self._lock:
            fresh = sig not in self.total.shapes.get(name, ())
            warm = fresh and (
                self._first_tick.get(name, self._tick) < self._tick
            )
            self._first_tick.setdefault(name, self._tick)
            for sc in self._all_scopes():
                sc.dispatches[name] = sc.dispatches.get(name, 0) + 1
                sc.shapes.setdefault(name, set()).add(sig)
                if fresh:
                    sc.compiles[name] = sc.compiles.get(name, 0) + 1
                    if warm:
                        sc.warm_recompiles[name] = (
                            sc.warm_recompiles.get(name, 0) + 1
                        )
            if fresh:
                self._pending_compiles.append((name, None, warm))
        return out

    def put(self, site: str, value, device) -> torch.Tensor:
        """The ONE counted upload: ``value`` (a numpy array or a CPU
        tensor) copied into a fresh allocation on ``device``, its bytes
        counted under ``site``."""
        dev = upload(value, device)
        if self.enabled:
            self.count_transfer(site, _nbytes(value))
        return dev

    def count_transfer(self, site: str, nbytes: int) -> None:
        if not self.enabled or nbytes <= 0:
            return
        with self._lock:
            for sc in self._all_scopes():
                sc.transfer_bytes[site] = (
                    sc.transfer_bytes.get(site, 0) + nbytes
                )

    def record_build(self, fn: str, seconds: float) -> None:
        """A CUDA library built (or loaded from its build directory) for
        ``fn``: the port's one real compile, exported as
        ``karpenter_device_compile_seconds{fn}``."""
        if not self.enabled:
            return
        with self._lock:
            for sc in self._all_scopes():
                sc.compile_s[fn] = sc.compile_s.get(fn, 0.0) + seconds
            self._pending_compiles.append((fn, seconds, False))

    # ----------------------------------------------------------- resident
    def set_resident_footprint(
        self, owner, footprint: Dict[str, int]
    ) -> None:
        """Replace ONE owner's live device footprint (consumer -> bytes);
        the merge over live owners happens at read time."""
        if not self.enabled:
            return
        with self._lock:
            note_access("DeviceObservatory._resident_sources")
            self._resident_sources[owner] = dict(footprint)

    def _merged_resident(self) -> Dict[str, int]:
        """Consumer -> bytes summed over the live owners (under the lock)."""
        merged: Dict[str, int] = {}
        for fp in self._resident_sources.values():
            for consumer, v in fp.items():
                merged[consumer] = merged.get(consumer, 0) + v
        return merged

    def count_resident_update(self, kind: str) -> None:
        """kind: 'donated' (a delta applied in the resident buffers),
        'seed' (a fresh full upload), 'noop' (a refresh that changed no
        tensor)."""
        if not self.enabled:
            return
        with self._lock:
            for sc in self._all_scopes():
                sc.resident_updates[kind] = (
                    sc.resident_updates.get(kind, 0) + 1
                )

    # --------------------------------------------------------------- ticks
    def _base_snapshot(self) -> dict:
        t = self.total
        return {
            "compiles": sum(t.compiles.values()),
            "warm_recompiles": sum(t.warm_recompiles.values()),
            "dispatches": sum(t.dispatches.values()),
            "transfer_bytes": sum(t.transfer_bytes.values()),
            "resident_bytes": sum(self._merged_resident().values()),
        }

    def _detail_snapshot(self) -> dict:
        t = self.total
        return {
            "dispatches": dict(t.dispatches),
            "compiles": dict(t.compiles),
            "transfer_bytes": dict(t.transfer_bytes),
            "resident_updates": dict(t.resident_updates),
        }

    def begin_tick(self, seq: int) -> None:
        """Mark a reconcile-tick boundary: new signatures from here on are
        warm for any function launched in an earlier tick, and the tick
        sections delta against this point."""
        with self._lock:
            self._tick = seq
            self._tick_base = self._base_snapshot()
            self._tick_detail_base = self._detail_snapshot()

    def tick_section(self) -> dict:
        """What the device layer did THIS tick (deltas against the
        begin_tick snapshot) plus the current and per-tick-delta resident
        footprint: the reference's section, key for key."""
        with self._lock:
            cur = self._base_snapshot()
            base = self._tick_base
            return {
                "compiles": cur["compiles"] - base["compiles"],
                "warm_recompiles": (
                    cur["warm_recompiles"] - base["warm_recompiles"]
                ),
                "dispatches": cur["dispatches"] - base["dispatches"],
                "transfer_bytes": (
                    cur["transfer_bytes"] - base["transfer_bytes"]
                ),
                "resident_bytes": cur["resident_bytes"],
                "resident_delta_bytes": (
                    cur["resident_bytes"] - base["resident_bytes"]
                ),
            }

    def tick_detail(self) -> dict:
        """This tick's deltas broken down: launches and new signatures by
        function, transfer bytes by site, resident updates by kind."""
        with self._lock:
            cur = self._detail_snapshot()
            base = self._tick_detail_base
        return {
            key: {
                k: v - base[key].get(k, 0)
                for k, v in sorted(cur[key].items())
                if v != base[key].get(k, 0)
            }
            for key in ("dispatches", "compiles", "transfer_bytes",
                        "resident_updates")
        }

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """The full live picture: process totals per function and site,
        warm signatures, library build seconds, the resident footprint."""
        with self._lock:
            t = self.total
            resident = self._merged_resident()
            return {
                "enabled": self.enabled,
                "tick": self._tick,
                "compiles": dict(sorted(t.compiles.items())),
                "compile_seconds": {
                    fn: round(s, 6)
                    for fn, s in sorted(t.compile_s.items())
                },
                "warm_recompiles": dict(sorted(t.warm_recompiles.items())),
                "unique_shapes": t.unique_shapes(),
                "dispatches": dict(sorted(t.dispatches.items())),
                "transfer_bytes": dict(sorted(t.transfer_bytes.items())),
                "resident": {
                    "bytes": dict(sorted(resident.items())),
                    "bytes_total": sum(resident.values()),
                    "updates": dict(sorted(t.resident_updates.items())),
                },
            }


# the process observatory every seam records into (ops-layer code holds no
# registry; emission happens at the export seam)
OBSERVATORY = DeviceObservatory()


def export_device_metrics(
    registry, obs: DeviceObservatory, exported: Optional[dict]
) -> Tuple[dict, List[dict]]:
    """Mirror the observatory's monotonic totals into the registry's
    ``karpenter_device_*`` families by DELTA (the caller keeps what it last
    exported).  Drains the pending compile events: library builds into the
    ``karpenter_device_compile_seconds{fn}`` histogram, and the warm new
    signatures returned as ``{"fn", "compile_s"}`` attributions for the
    caller (``compile_s`` 0.0: a new signature compiles nothing here)."""
    exported = exported or {}
    with obs._lock:
        t = obs.total
        totals = {
            "compiles": dict(t.compiles),
            "warm": dict(t.warm_recompiles),
            "dispatches": dict(t.dispatches),
            "transfer": dict(t.transfer_bytes),
            "updates": dict(t.resident_updates),
        }
        resident = obs._merged_resident()
        pending = obs._pending_compiles
        obs._pending_compiles = []

    def _inc(metric: str, label: str, key: str) -> Dict[str, float]:
        prev = exported.get(key, {})
        cur = totals[key]
        for name, v in cur.items():
            d = v - prev.get(name, 0)
            if d > 0:
                registry.inc(metric, {label: name}, by=d)
        return dict(cur)

    new = {
        "compiles": _inc("karpenter_device_compiles_total", "fn", "compiles"),
        "warm": _inc(
            "karpenter_device_warm_recompiles_total", "fn", "warm"
        ),
        "dispatches": _inc(
            "karpenter_device_dispatches_total", "fn", "dispatches"
        ),
        "transfer": _inc(
            "karpenter_device_transfer_bytes_total", "site", "transfer"
        ),
        "updates": _inc(
            "karpenter_device_resident_updates_total", "kind", "updates"
        ),
    }
    for fn, dt, _warm in pending:
        if dt is not None:
            registry.observe(
                "karpenter_device_compile_seconds", dt, {"fn": fn}
            )
    # gauge family: set current consumers, unset vanished ones
    for consumer in exported.get("resident", {}):
        if consumer not in resident:
            registry.unset(
                "karpenter_device_resident_bytes", {"consumer": consumer}
            )
    for consumer, v in resident.items():
        registry.set(
            "karpenter_device_resident_bytes", float(v),
            {"consumer": consumer},
        )
    new["resident"] = resident
    warm_events = [
        {"fn": fn, "compile_s": 0.0}
        for fn, dt, warm in pending
        if warm
    ]
    return new, warm_events
