"""Columnar event tapes: scenario timelines as numpy column arrays.

The per-event generators in `sim/workload.py` cost O(events) Python —
fine at hundreds of pods, the bottleneck at a million.  A `ColumnarSpec`
builds its whole timeline up front as column arrays (arrival tick, shape
index, lifetime, chaos draws) in one seeded pass of numpy work, and an
`EventTape` materializes `SimEvent`s lazily per tick from array slices,
so per-tick cost is proportional to that tick's events only.

Parity contract — a tape must replay byte-identical to its per-event
twin on shared seeds.  Three rules make that hold:

1. **Counter RNG, not a stream RNG.**  Every draw is a pure function of
   ``(seed, stream, tick, idx)`` — splitmix64 over a weighted counter —
   computed bit-identically by the vectorized (`draws_u01`) and scalar
   (`draw_u01`) forms.  A sequential generator like `random.Random`
   cannot be vectorized without replaying its state machine; a counter
   RNG has no state to replay.
2. **Transcendentals stay scalar and per-tick.**  `math.exp`/`math.sin`
   (Poisson CDF walk, diurnal rate curve) may differ from their numpy
   kernels in the last ulp, so anything non-elementwise-exact is
   computed once per TICK with `math.*` on both sides — O(ticks) Python
   is noise next to O(events).  Per-EVENT work uses only IEEE-exact
   elementwise ops (+, *, /, floor, shifts), which numpy and CPython
   evaluate identically.
3. **State-dependent choices store draws, not outcomes.**  Events that
   depend on live cluster state (which instance a storm interrupts)
   keep their uniforms in the tape and rank-select over the runner's
   sorted `SimView` at materialization time — the twin runs the exact
   same selection code on the exact same draws.

`EventTape.digest()` (sha256 over spec parameters + raw column bytes)
is on the determinism-analyzer root list (analysis/allowlists.py): no
wall-clock or unseeded randomness may be reachable from it.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.sim.workload import SimEvent, Workload, _pod_event

# ---------------------------------------------------------------- counter rng
_MASK = (1 << 64) - 1
_W_SEED = 0x9E3779B97F4A7C15  # golden-ratio weights keep the counter
_W_STREAM = 0xBF58476D1CE4E5B9  # coordinates from aliasing each other
_W_TICK = 0x94D049BB133111EB
_W_IDX = 0xD6E8FEB86659FD93


def mix64(x: int) -> int:
    """splitmix64 finalizer (scalar form) over a 64-bit counter."""
    x &= _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


def draw_u01(seed: int, stream: int, tick: int, idx: int) -> float:
    """One uniform in [0, 1): pure function of the 4-part counter."""
    x = (seed * _W_SEED + stream * _W_STREAM + tick * _W_TICK + idx * _W_IDX) & _MASK
    return (mix64(x) >> 11) * 2.0**-53


def draws_u01(seed: int, stream: int, ticks, idxs) -> np.ndarray:
    """Vectorized `draw_u01`: same bits for the same counters."""
    t = np.asarray(ticks, dtype=np.uint64)
    i = np.asarray(idxs, dtype=np.uint64)
    x = np.uint64((seed * _W_SEED + stream * _W_STREAM) & _MASK)
    x = x + t * np.uint64(_W_TICK) + i * np.uint64(_W_IDX)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x >> np.uint64(11)).astype(np.float64) * 2.0**-53


def poisson_icdf(lam: float, u: float) -> int:
    """Poisson draw by inverse CDF from ONE uniform.

    Both the tape builder and the per-event twins call this exact
    function with the exact same ``u``, so counts agree bit-for-bit.
    The walk is capped: once the CDF stops advancing in float64 the
    residual mass is unreachable anyway.
    """
    if lam <= 0.0:
        return 0
    p = math.exp(-lam)
    cdf = p
    k = 0
    while u >= cdf:
        k += 1
        p *= lam / k
        new = cdf + p
        if new == cdf:  # float64 exhausted the tail
            return k
        cdf = new
    return k


def _choice_index(u: float, n: int) -> int:
    """Uniform index in [0, n): identical in both planes."""
    return min(int(u * n), n - 1)


# intra-spec stream offsets (each spec owns _SPEC_STREAMS consecutive streams)
_SPEC_STREAMS = 8
_S_COUNT = 0  # per-tick Poisson count
_S_SHAPE = 1  # per-event cpu-shape choice
_S_LIFE = 2  # per-event lifetime
_S_DRAW = 3  # per-event state-dependent selection draw


class ColumnarSpec:
    """One vectorized event family inside an `EventTape`.

    ``bind`` fixes (seed, stream, ticks) and triggers the one-shot
    column build; `tick_events` slices that tick's events out;
    `twin` returns the per-event oracle generator bound to the SAME
    (seed, stream, ticks) so parity is testable per family.
    """

    def __init__(self) -> None:
        self.seed = 0
        self.stream = 0
        self.ticks = 0

    def bind(self, seed: int, stream: int, ticks: int) -> None:
        self.seed, self.stream, self.ticks = int(seed), int(stream), int(ticks)
        self.build()

    def build(self) -> None:
        pass

    def params(self) -> dict:
        raise NotImplementedError

    def columns(self) -> Dict[str, np.ndarray]:
        return {}

    def total_events(self) -> int:
        return 0

    def tick_events(self, tick: int, view) -> List[SimEvent]:
        raise NotImplementedError

    def twin(self) -> Workload:
        raise NotImplementedError


class _ArrivalsBase(ColumnarSpec):
    """Poisson pod arrivals with a per-tick rate curve and optional
    bounded lifetimes (pods delete themselves ``lifetime`` ticks after
    arrival — the churn that keeps a long run's live set flat)."""

    def __init__(
        self,
        cpus: Sequence[float] = (0.5, 1.0, 2.0),
        mem_gib: float = 1.0,
        prefix: str = "cl",
        lifetime: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.cpus = tuple(cpus)
        self.mem_gib = mem_gib
        self.prefix = prefix
        if lifetime is not None:
            lo, hi = lifetime
            if lo < 1 or hi < lo:
                raise ValueError(f"lifetime must satisfy 1 <= lo <= hi: {lifetime}")
        self.lifetime = lifetime

    def _rate(self, tick: int) -> float:
        raise NotImplementedError

    def build(self) -> None:
        # per-tick Poisson counts: scalar exp/CDF walk (rule 2), one
        # uniform each from the count stream
        counts = np.array(
            [
                poisson_icdf(
                    self._rate(t), draw_u01(self.seed, self.stream + _S_COUNT, t, 0)
                )
                for t in range(self.ticks)
            ],
            dtype=np.int64,
        )
        starts = np.zeros(self.ticks + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        self._starts = starts
        self.arrival = np.repeat(np.arange(self.ticks, dtype=np.int64), counts)
        self.ordinal = np.arange(self.arrival.size, dtype=np.int64) - starts[self.arrival]
        u_shape = draws_u01(
            self.seed, self.stream + _S_SHAPE, self.arrival, self.ordinal
        )
        n = len(self.cpus)
        self.shape_idx = np.minimum(
            (u_shape * n).astype(np.int64), np.int64(n - 1)
        )
        if self.lifetime is not None:
            lo, hi = self.lifetime
            u_life = draws_u01(
                self.seed, self.stream + _S_LIFE, self.arrival, self.ordinal
            )
            life = lo + np.minimum(
                (u_life * (hi - lo + 1)).astype(np.int64), np.int64(hi - lo)
            )
            del_tick = self.arrival + life
            keep = np.flatnonzero(del_tick < self.ticks)
            order = np.argsort(del_tick[keep], kind="stable")
            self._del_src = keep[order]
            del_sorted = del_tick[keep][order]
            self._del_starts = np.searchsorted(
                del_sorted, np.arange(self.ticks + 1, dtype=np.int64)
            )
        else:
            self._del_src = np.zeros(0, dtype=np.int64)
            self._del_starts = np.zeros(self.ticks + 1, dtype=np.int64)

    def columns(self) -> Dict[str, np.ndarray]:
        return {
            "arrival": self.arrival,
            "ordinal": self.ordinal,
            "shape_idx": self.shape_idx,
            "del_src": self._del_src,
        }

    def total_events(self) -> int:
        return int(self.arrival.size + self._del_src.size)

    def tick_events(self, tick: int, view) -> List[SimEvent]:
        evs: List[SimEvent] = []
        s, e = self._starts[tick], self._starts[tick + 1]
        for j in range(s, e):
            evs.append(
                _pod_event(
                    f"{self.prefix}-t{tick}-{self.ordinal[j]}",
                    self.cpus[self.shape_idx[j]],
                    self.mem_gib,
                )
            )
        ds, de = self._del_starts[tick], self._del_starts[tick + 1]
        for j in range(ds, de):
            src = self._del_src[j]
            evs.append(
                SimEvent(
                    "pod_delete",
                    {
                        "key": f"default/{self.prefix}"
                        f"-t{self.arrival[src]}-{self.ordinal[src]}"
                    },
                )
            )
        return evs

    def twin(self) -> Workload:
        return _ArrivalsTwin(self)


class _ArrivalsTwin(Workload):
    """Per-event oracle for `_ArrivalsBase` specs: same counters, same
    scalar arithmetic, one event object at a time.  Stateful (it tracks
    its own delete schedule), so build a fresh one per run."""

    def __init__(self, spec: _ArrivalsBase):
        self._s = spec
        self._deletes: Dict[int, List[str]] = {}

    def events(self, tick, rng, view):
        s = self._s
        evs: List[SimEvent] = []
        count = poisson_icdf(
            s._rate(tick), draw_u01(s.seed, s.stream + _S_COUNT, tick, 0)
        )
        for i in range(count):
            u_shape = draw_u01(s.seed, s.stream + _S_SHAPE, tick, i)
            name = f"{s.prefix}-t{tick}-{i}"
            evs.append(
                _pod_event(name, s.cpus[_choice_index(u_shape, len(s.cpus))], s.mem_gib)
            )
            if s.lifetime is not None:
                lo, hi = s.lifetime
                u_life = draw_u01(s.seed, s.stream + _S_LIFE, tick, i)
                due = tick + lo + _choice_index(u_life, hi - lo + 1)
                if due < s.ticks:
                    self._deletes.setdefault(due, []).append(f"default/{name}")
        for key in self._deletes.pop(tick, []):
            evs.append(SimEvent("pod_delete", {"key": key}))
        return evs


class CSteady(_ArrivalsBase):
    """Stationary Poisson arrivals (columnar twin of workload.Steady)."""

    def __init__(self, rate: float = 0.5, **kw):
        super().__init__(**kw)
        self.rate = rate

    def _rate(self, tick: int) -> float:
        return self.rate

    def params(self) -> dict:
        return {
            "rate": self.rate,
            "cpus": list(self.cpus),
            "mem_gib": self.mem_gib,
            "prefix": self.prefix,
            "lifetime": list(self.lifetime) if self.lifetime else None,
        }


class CDiurnal(_ArrivalsBase):
    """Sine day/night arrivals: rate(t) = mean*(1 + A*sin(2πt/T)),
    clamped at zero.  The sin is per-tick scalar `math.sin` (rule 2)."""

    def __init__(
        self,
        mean: float = 0.6,
        amplitude: float = 0.8,
        period_ticks: int = 100,
        **kw,
    ):
        super().__init__(**kw)
        self.mean = mean
        self.amplitude = amplitude
        self.period_ticks = period_ticks

    def _rate(self, tick: int) -> float:
        rate = self.mean * (
            1.0
            + self.amplitude * math.sin(2 * math.pi * tick / self.period_ticks)
        )
        return max(rate, 0.0)

    def params(self) -> dict:
        return {
            "mean": self.mean,
            "amplitude": self.amplitude,
            "period_ticks": self.period_ticks,
            "cpus": list(self.cpus),
            "mem_gib": self.mem_gib,
            "prefix": self.prefix,
            "lifetime": list(self.lifetime) if self.lifetime else None,
        }


def _storm_select(ids: List[str], us: Sequence[float]) -> List[SimEvent]:
    """Rank-select interruption targets from the SORTED claimed-id list
    using stored uniforms — rule 3's shared selection code.  Pop-from-
    copy so one tick never interrupts the same instance twice."""
    pool = list(ids)
    evs: List[SimEvent] = []
    for u in us:
        if not pool:
            break
        evs.append(
            SimEvent(
                "spot_interruption", {"id": pool.pop(_choice_index(u, len(pool)))}
            )
        )
    return evs


class CInterruptionStorm(ColumnarSpec):
    """Capacity-reclaim storm: `per_tick` stored draws per storm tick,
    resolved against the live claimed set at materialization."""

    def __init__(self, start: int, duration: int, per_tick: int = 2):
        super().__init__()
        self.start = start
        self.duration = duration
        self.per_tick = per_tick

    def build(self) -> None:
        rows = np.repeat(
            np.arange(self.start, self.start + self.duration, dtype=np.int64),
            self.per_tick,
        )
        cols = np.tile(
            np.arange(self.per_tick, dtype=np.int64), self.duration
        )
        self._u = draws_u01(self.seed, self.stream + _S_DRAW, rows, cols).reshape(
            self.duration, self.per_tick
        )

    def params(self) -> dict:
        return {
            "start": self.start,
            "duration": self.duration,
            "per_tick": self.per_tick,
        }

    def columns(self) -> Dict[str, np.ndarray]:
        return {"u": self._u}

    def total_events(self) -> int:
        return int(self._u.size)

    def tick_events(self, tick: int, view) -> List[SimEvent]:
        if not (self.start <= tick < self.start + self.duration):
            return []
        return _storm_select(
            view.claimed_instance_ids(), self._u[tick - self.start]
        )

    def twin(self) -> Workload:
        return _StormTwin(self)


class _StormTwin(Workload):
    def __init__(self, spec: CInterruptionStorm):
        self._s = spec

    def events(self, tick, rng, view):
        s = self._s
        if not (s.start <= tick < s.start + s.duration):
            return []
        us = [
            draw_u01(s.seed, s.stream + _S_DRAW, tick, j)
            for j in range(s.per_tick)
        ]
        return _storm_select(view.claimed_instance_ids(), us)


class CPodBurst(ColumnarSpec):
    """A deterministic wave of identical pods — `total` pods landing
    `per_tick` per tick from `start`, optionally labeled and carrying
    pod-(anti-)affinity terms.  The scale-anchor and gang primitive."""

    def __init__(
        self,
        total: int,
        per_tick: int,
        start: int = 0,
        cpu: float = 0.5,
        mem_gib: float = 1.0,
        prefix: str = "burst",
        labels: Optional[Dict[str, str]] = None,
        affinity: Optional[List[dict]] = None,
    ):
        super().__init__()
        self.total = total
        self.per_tick = per_tick
        self.start = start
        self.cpu = cpu
        self.mem_gib = mem_gib
        self.prefix = prefix
        self.labels = dict(labels) if labels else None
        self.affinity = [dict(t) for t in affinity] if affinity else None

    def build(self) -> None:
        idx = np.arange(self.total, dtype=np.int64)
        self.arrival = self.start + idx // self.per_tick
        starts = np.searchsorted(
            self.arrival, np.arange(self.ticks + 1, dtype=np.int64)
        )
        self._starts = starts

    def params(self) -> dict:
        return {
            "total": self.total,
            "per_tick": self.per_tick,
            "start": self.start,
            "cpu": self.cpu,
            "mem_gib": self.mem_gib,
            "prefix": self.prefix,
            "labels": self.labels,
            "affinity": self.affinity,
        }

    def columns(self) -> Dict[str, np.ndarray]:
        return {"arrival": self.arrival}

    def total_events(self) -> int:
        return int(self.total)

    def _event(self, j: int) -> SimEvent:
        data = {
            "name": f"{self.prefix}-{j}",
            "cpu": self.cpu,
            "mem_gib": self.mem_gib,
        }
        if self.labels:
            data["labels"] = dict(self.labels)
        if self.affinity:
            data["affinity"] = [dict(t) for t in self.affinity]
        return SimEvent("pod_create", data)

    def tick_events(self, tick: int, view) -> List[SimEvent]:
        return [
            self._event(j) for j in range(self._starts[tick], self._starts[tick + 1])
        ]

    def twin(self) -> Workload:
        return _BurstTwin(self)


class _BurstTwin(Workload):
    def __init__(self, spec: CPodBurst):
        self._s = spec

    def events(self, tick, rng, view):
        s = self._s
        if tick < s.start:
            return []
        first = (tick - s.start) * s.per_tick
        last = min(first + s.per_tick, s.total)
        return [s._event(j) for j in range(first, last)]


class CScript(ColumnarSpec):
    """Exact events at exact ticks — chaos windows, AZ events, price
    shocks, catalog rolls — inside a tape so corpus scenarios are fully
    tape-driven.  No columns: the steps ARE the data (they enter the
    digest through `params`)."""

    def __init__(self, steps: Dict[int, List[Tuple[str, dict]]]):
        super().__init__()
        self.steps = {
            int(t): [(k, dict(d)) for k, d in evs] for t, evs in steps.items()
        }

    def params(self) -> dict:
        return {
            "steps": {
                str(t): [[k, d] for k, d in evs]
                for t, evs in sorted(self.steps.items())
            }
        }

    def total_events(self) -> int:
        return sum(len(evs) for evs in self.steps.values())

    def tick_events(self, tick: int, view) -> List[SimEvent]:
        return [SimEvent(k, dict(d)) for k, d in self.steps.get(tick, [])]

    def twin(self) -> Workload:
        return _ScriptTwin(self)


class _ScriptTwin(Workload):
    def __init__(self, spec: CScript):
        self._s = spec

    def events(self, tick, rng, view):
        return [SimEvent(k, dict(d)) for k, d in self._s.steps.get(tick, [])]


# -------------------------------------------------------------------- tape
class EventTape:
    """A bound set of columnar specs: the whole scenario timeline, built
    once, materialized lazily per tick."""

    def __init__(self, seed: int, ticks: int, specs: Sequence[ColumnarSpec]):
        self.seed = int(seed)
        self.ticks = int(ticks)
        self.specs = list(specs)
        for i, spec in enumerate(self.specs):
            spec.bind(self.seed, i * _SPEC_STREAMS, self.ticks)

    def materialize(self, tick: int, view) -> List[SimEvent]:
        evs: List[SimEvent] = []
        for spec in self.specs:
            evs.extend(spec.tick_events(tick, view))
        return evs

    def total_events(self) -> int:
        return sum(s.total_events() for s in self.specs)

    def twins(self) -> List[Workload]:
        """Per-event oracle generators bound to the same counters — a
        scenario running these produces a byte-identical trace."""
        return [s.twin() for s in self.specs]

    def digest(self) -> str:
        """sha256 over spec parameters + raw column bytes: two tapes
        with equal digests materialize equal event streams (up to the
        live-state inputs of rank-selected events, which the trace
        itself pins)."""
        h = hashlib.sha256()
        h.update(
            json.dumps(
                {"seed": self.seed, "ticks": self.ticks}, sort_keys=True
            ).encode()
        )
        for spec in self.specs:
            h.update(
                json.dumps(
                    {"spec": type(spec).__name__, "params": spec.params()},
                    sort_keys=True,
                ).encode()
            )
            cols = spec.columns()
            for name in sorted(cols):
                arr = np.ascontiguousarray(cols[name])
                h.update(name.encode())
                h.update(str(arr.dtype).encode())
                h.update(str(arr.shape).encode())
                h.update(arr.tobytes())
        return h.hexdigest()


class TapeWorkload(Workload):
    """Adapter: lets `ScenarioRunner` consume a tape through the plain
    `Workload` interface (the runner's rng is deliberately unused — all
    tape randomness is counter-derived)."""

    def __init__(self, tape: EventTape):
        self.tape = tape

    def events(self, tick, rng, view):
        return self.tape.materialize(tick, view)
