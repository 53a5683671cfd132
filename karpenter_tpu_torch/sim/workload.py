"""Workload generators: seeded arrival processes for the cluster simulator.

A generator turns (tick, rng, view) into a list of `SimEvent`s — the
declarative things that happen TO the cluster: pods arriving/leaving,
instances dying out-of-band, spot interruptions, scripted chaos phases
(reusing `cloud.chaos`), AZ blackouts, and mid-run pool/catalog
mutations.  Generators never touch the Environment directly; the runner
applies events, which keeps generation and application separable — a
recorded trace replays by re-applying the events with no generator in
the loop.

Determinism contract: all randomness comes from the single `rng` the
runner passes in, consumed in fixed generator order, and every event is
self-contained plain JSON (names included — nothing defers to global
name counters at apply time).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class SimEvent:
    """One injected occurrence.  ``data`` must be plain JSON (the trace
    writes it verbatim; replay re-applies it verbatim)."""

    kind: str
    data: dict = field(default_factory=dict)


# the event kinds the runner knows how to apply (sim/runner.py)
EVENT_KINDS = (
    "pod_create",
    "pod_delete",
    "instance_kill",
    "spot_interruption",
    "chaos",
    "az_down",
    "az_up",
    "image_roll",
    "image_deprecate",
    "price_shock",
    "pool_update",
)


def poisson(rng: random.Random, lam: float) -> int:
    """Knuth's Poisson sampler — small lambdas only (arrival rates per
    tick), which is all the generators use."""
    if lam <= 0.0:
        return 0
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


class Workload:
    """Base generator.  ``view`` is the runner's SimView (sorted, read-only
    glimpses of live sim pods / instances / claims)."""

    def events(self, tick: int, rng: random.Random, view) -> List[SimEvent]:
        raise NotImplementedError


def _pod_event(name: str, cpu: float, mem_gib: float) -> SimEvent:
    return SimEvent(
        "pod_create", {"name": name, "cpu": cpu, "mem_gib": mem_gib}
    )


@dataclass
class Steady(Workload):
    """Stationary Poisson arrivals."""

    rate: float = 0.5  # mean pods per tick
    cpus: Sequence[float] = (0.5, 1.0, 2.0)
    mem_gib: float = 1.0
    prefix: str = "st"

    def events(self, tick, rng, view):
        return [
            _pod_event(
                f"{self.prefix}-t{tick}-{i}", rng.choice(list(self.cpus)),
                self.mem_gib,
            )
            for i in range(poisson(rng, self.rate))
        ]


@dataclass
class Diurnal(Workload):
    """Sine-modulated load: rate(t) = mean * (1 + amplitude*sin(2pi t/T)),
    clamped at zero — the day/night curve a user-facing service sees."""

    mean: float = 0.6
    amplitude: float = 0.8
    period_ticks: int = 100
    cpus: Sequence[float] = (0.5, 1.0, 2.0)
    mem_gib: float = 1.0
    prefix: str = "di"

    def events(self, tick, rng, view):
        rate = self.mean * (
            1.0 + self.amplitude * math.sin(2 * math.pi * tick / self.period_ticks)
        )
        return [
            _pod_event(
                f"{self.prefix}-t{tick}-{i}", rng.choice(list(self.cpus)),
                self.mem_gib,
            )
            for i in range(poisson(rng, max(rate, 0.0)))
        ]


@dataclass
class BatchWaves(Workload):
    """A wave of identical batch jobs every `every` ticks."""

    every: int = 25
    size: int = 10
    cpu: float = 1.0
    mem_gib: float = 1.0
    prefix: str = "bw"

    def events(self, tick, rng, view):
        if tick % self.every:
            return []
        return [
            _pod_event(f"{self.prefix}-t{tick}-{i}", self.cpu, self.mem_gib)
            for i in range(self.size)
        ]


@dataclass
class FlashCrowd(Workload):
    """Bursty flash crowds: with probability `prob` per tick, a burst of
    uniform(min_size, max_size) pods lands at once."""

    prob: float = 0.04
    min_size: int = 8
    max_size: int = 20
    cpu: float = 0.5
    mem_gib: float = 1.0
    prefix: str = "fc"

    def events(self, tick, rng, view):
        if rng.random() >= self.prob:
            return []
        n = rng.randint(self.min_size, self.max_size)
        return [
            _pod_event(f"{self.prefix}-t{tick}-{i}", self.cpu, self.mem_gib)
            for i in range(n)
        ]


@dataclass
class Churn(Workload):
    """Random deletion of live sim pods (deployments scaling down)."""

    rate: float = 0.05  # mean deletions per tick

    def events(self, tick, rng, view):
        live = view.live_pod_keys()
        n = min(poisson(rng, self.rate), len(live))
        return [
            SimEvent("pod_delete", {"key": key})
            for key in (rng.sample(live, n) if n else [])
        ]


@dataclass
class ScaleDown(Workload):
    """Mass scale-down: at each listed tick, a `fraction` of the live sim
    pods is deleted AT ONCE — a deployment rollback, a batch job
    completing, a tenant leaving.  The instantaneous drop is what leaves
    several nodes simultaneously reclaimable, i.e. the workload shape
    multi-node consolidation (the removal-mask population search) exists
    for; gradual `Churn` never outruns the one-action-per-pass single
    scan."""

    ticks: Sequence[int] = ()
    fraction: float = 0.6

    def events(self, tick, rng, view):
        if tick not in self.ticks:
            return []
        live = view.live_pod_keys()
        n = min(len(live), int(len(live) * self.fraction))
        return [
            SimEvent("pod_delete", {"key": key})
            for key in (rng.sample(live, n) if n else [])
        ]


@dataclass
class InstanceKiller(Workload):
    """Out-of-band instance terminations (hardware failure / operator
    fat-finger): the controller only finds out by observing the cloud."""

    rate: float = 0.03

    def events(self, tick, rng, view):
        running = view.running_instance_ids()
        if not running or rng.random() >= self.rate:
            return []
        return [SimEvent("instance_kill", {"id": rng.choice(running)})]


@dataclass
class SpotInterrupter(Workload):
    """Background spot interruptions at a low steady rate."""

    rate: float = 0.03

    def events(self, tick, rng, view):
        claimed = view.claimed_instance_ids()
        if not claimed or rng.random() >= self.rate:
            return []
        return [SimEvent("spot_interruption", {"id": rng.choice(claimed)})]


@dataclass
class InterruptionStorm(Workload):
    """A capacity-reclaim storm: for `duration` ticks starting at `start`,
    up to `per_tick` claimed instances get interruption notices per tick —
    the shape of a real spot pool drying up."""

    start: int
    duration: int
    per_tick: int = 2

    def events(self, tick, rng, view):
        if not (self.start <= tick < self.start + self.duration):
            return []
        claimed = view.claimed_instance_ids()
        n = min(self.per_tick, len(claimed))
        return [
            SimEvent("spot_interruption", {"id": iid})
            for iid in (rng.sample(claimed, n) if n else [])
        ]


@dataclass
class Script(Workload):
    """Scripted phases: exact events at exact ticks — chaos schedules
    (API storms, blackouts), AZ events, catalog rolls, pool mutations.

    ``steps`` maps tick -> [(kind, data), ...].  Chaos data is
    {"op": <ChaosEngine method>, "kw": {...}}; window ops (add_blackout,
    add_throttle_burst) take ``duration`` only — the runner resolves
    ``start`` to the simulated now at apply time, so the trace carries no
    absolute timestamps."""

    steps: Dict[int, List[Tuple[str, dict]]] = field(default_factory=dict)

    def events(self, tick, rng, view):
        return [SimEvent(kind, dict(data)) for kind, data in self.steps.get(tick, [])]


@dataclass
class SoakChurn(Workload):
    """The mixed create/delete/kill/interrupt churn of the original chaos
    soak (tests/test_chaos.py `_soak`): per tick one draw r ~ U(0,1) picks
    create (<0.4), delete (<0.5), out-of-band kill (<0.55), or spot
    interruption (<0.6) — preserved so the migrated soak exercises the
    same distribution it always did."""

    cpus: Sequence[float] = (0.5, 1.0, 2.0)
    mem_gib: float = 1.0
    prefix: str = "soak"

    def events(self, tick, rng, view):
        r = rng.random()
        if r < 0.4:
            return [
                _pod_event(
                    f"{self.prefix}-t{tick}", rng.choice(list(self.cpus)),
                    self.mem_gib,
                )
            ]
        if r < 0.5:
            live = view.live_pod_keys()
            if live:
                return [SimEvent("pod_delete", {"key": live[-1]})]
        elif r < 0.55:
            running = view.running_instance_ids()
            if running:
                return [SimEvent("instance_kill", {"id": rng.choice(running)})]
        elif r < 0.6:
            claimed = view.claimed_instance_ids()
            if claimed:
                return [SimEvent("spot_interruption", {"id": rng.choice(claimed)})]
        return []
