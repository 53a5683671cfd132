"""Deterministic scenario runner: the real Operator, time-compressed.

`ScenarioRunner` drives the full controller stack — every controller,
the real FakeCloud + ChaosEngine, the injected FakeClock — through a
declarative `Scenario`: per tick it injects the scenario's events,
advances the clock one tick, runs the kubelet + `reconcile_once`, then
evaluates the cluster invariants (sim/invariants.py) and appends a state
digest to the trace (sim/trace.py).  After the scripted ticks a drain
phase outlasts the recovery windows (ICE mask TTL, GC grace) and the
strict final invariants run.

Determinism contract (the trace must be byte-identical for equal seeds):

- one seeded RNG drives all generators, consumed in fixed order; the
  chaos engine is reseeded from the same seed,
- the provisioner launches serially (`launch_concurrency = 1`) and the
  interruption controller drains its batch in order (`workers = 1`) —
  thread scheduling must never order the cloud-call stream,
- auto-name counters rewind (`reset_name_sequences`) so pod-N /
  nodeclaim-N names reproduce,
- generated events are self-contained JSON, so `replay()` re-executes a
  recorded tape with no generator (or RNG) in the loop,
- nothing wall-clock enters the trace or the SLO report (host-side
  profiling stays in the separate, explicitly non-deterministic
  `--profile` section).

The port's runner takes one argument the reference's does not: the
``device`` the operator runs on (`testing.Environment`'s; None is the
card, and asking for it without one raises).  The trace does not depend
on it: a run on the card and one on the CPU write the same bytes.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import Pod, Resources, Settings
from karpenter_tpu_torch.api.objects import PodAffinityTerm, reset_name_sequences
from karpenter_tpu_torch.obs.device import OBSERVATORY, DeviceScope
from karpenter_tpu_torch.cloud.fake.backend import (
    CloudAPIError,
    FakeImage,
    MachineShape,
    generate_catalog,
)
from karpenter_tpu_torch.obs.slo import SLORule
from karpenter_tpu_torch.sim.invariants import InvariantChecker
from karpenter_tpu_torch.sim.report import build_report
from karpenter_tpu_torch.sim.trace import TraceWriter, read_tape
from karpenter_tpu_torch.sim.workload import (
    BatchWaves,
    Churn,
    Diurnal,
    FlashCrowd,
    InstanceKiller,
    InterruptionStorm,
    ScaleDown,
    Script,
    SimEvent,
    SoakChurn,
    SpotInterrupter,
    Steady,
    Workload,
)
from karpenter_tpu_torch.testing import Environment

# resilience knobs sized for simulated seconds (mirrors the chaos suite's
# FAST profile): backoffs ride the fake clock, so production-scale values
# would only stretch simulated time, not prove anything extra
SIM_SETTINGS = dict(
    cluster_name="sim",
    interruption_queue_name="sim-q",
    cloud_max_retries=2,
    cloud_retry_budget_per_tick=20,
    cloud_backoff_base=0.005,
    cloud_backoff_max=0.02,
    cloud_circuit_failure_threshold=4,
    cloud_circuit_reset_timeout=5.0,
    controller_backoff_base=0.5,
    controller_backoff_max=4.0,
)

SOAK_CONTROLLERS = (
    "nodeclass", "provisioner", "lifecycle", "interruption", "disruption",
    "termination", "link", "garbagecollection", "tagging", "metrics_state",
    "consistency",
)

# event kinds whose application counts as "disruptive weather" for the
# scheduling-deadline / leak-window invariants
_DISRUPTIVE = frozenset(
    {"chaos", "instance_kill", "spot_interruption", "az_down", "az_up"}
)


@dataclass
class Scenario:
    """Declarative run description: who arrives, what breaks, when."""

    name: str
    workloads: List[Workload] = field(default_factory=list)
    settings: Dict[str, object] = field(default_factory=dict)
    shapes: Optional[List[MachineShape]] = None
    tick_s: float = 1.0
    # _soak-style variable tick durations; None = fixed tick_s
    tick_jitter: Optional[Sequence[float]] = None
    drain_rounds: int = 8
    drain_step_s: float = 35.0
    settle_rounds: int = 30
    settle_step_s: float = 2.0
    schedule_deadline_s: float = 420.0
    # scenario-declared SLO rules (obs/slo.py), evaluated by the REAL
    # operator engine once per tick.  The runner replaces the operator's
    # production defaults with exactly this list: sim rules must read
    # only deterministic signals (pending-pod age, circuit state, ...),
    # never host wall time, so breach/recovery ledger lines replay
    # byte-identically.  Empty = the engine idles.
    slo_rules: List[SLORule] = field(default_factory=list)
    description: str = ""
    # columnar traffic plane (load/generators.py): (seed, ticks) ->
    # EventTape, built by the RUNNER (tapes are seed-bound, scenarios
    # are not) and appended to `workloads` as a TapeWorkload.  Replay
    # mode skips the build — recorded events need no generator.
    tape_factory: Optional[Callable[[int, int], object]] = None
    # time-to-settle budget: the last simulated moment with pending pods
    # must come within this many simulated seconds of t0 (the scale
    # anchors' acceptance criterion); breach -> "settle-budget" violation
    settle_budget_s: Optional[float] = None
    # check invariants on the vectorized plane (load/invariants.py) —
    # byte-identical violations/traces, array-ops cost
    vector_invariants: bool = False


class SimView:
    """Read-only, deterministically-ordered glimpses generators may use."""

    def __init__(self, runner: "ScenarioRunner"):
        self._r = runner

    def live_pod_keys(self) -> List[str]:
        kube = self._r.env.kube
        return sorted(k for k in self._r.sim_pods if k in kube.pods)

    def running_instance_ids(self) -> List[str]:
        return sorted(
            i.id
            for i in self._r.env.cloud.instances.values()
            if i.state == "running"
        )

    def claimed_instance_ids(self) -> List[str]:
        return sorted(
            c.provider_id
            for c in self._r.env.kube.node_claims.values()
            if c.provider_id and c.deleted_at is None
        )


class ScenarioRunner:
    def __init__(
        self,
        scenario: Scenario,
        seed: int,
        ticks: int,
        trace: Optional[TraceWriter] = None,
        tape: Optional[Dict[int, Tuple[float, List[Tuple[str, dict]]]]] = None,
        device=None,
    ):
        self.scenario = scenario
        self.seed = seed
        self.ticks = ticks
        self.trace = trace
        self.tape = tape  # replay mode when set: generators stay unused
        reset_name_sequences()
        self.env = Environment(
            shapes=scenario.shapes,
            settings=Settings(**{**SIM_SETTINGS, **scenario.settings}),
            device=device,
        )
        op = self.env.operator
        # determinism knobs (see module docstring)
        op.provisioner.launch_concurrency = 1
        if op.interruption is not None:
            op.interruption.workers = 1
        # the pipelined reconcile MUST degrade to the sequential
        # schedule here (enforced, not configured: a scenario's settings
        # cannot turn it back on) — speculative dispatch/advance stages
        # read wall-clock overlap and would put schedule-dependent
        # metric/ledger noise into a byte-compared trace.  The twin-run
        # test proves pipelining on/off takes identical ACTIONS, so the
        # sequential trace speaks for both schedules.
        op.pipeline.enabled = False
        # the sim evaluates the SCENARIO's SLO rules (deterministic
        # signals only) instead of the production defaults — tick
        # durations are host wall time, and the anomaly detector judges
        # wall-time series, so both would contaminate the byte-compared
        # ledger surface
        op.slo.replace_rules(scenario.slo_rules)
        op.detector.enabled = False
        # device observatory scope: per-run compile/transfer/resident
        # accounting for the report's `device` section.  Scoped counters
        # are DETERMINISTIC (distinct launch signatures a scope has seen,
        # not process history: a second run in the same process counts
        # the same), so the
        # section is part of the byte-compared report surface.  The
        # inert placeholder is swapped for a REGISTERED scope inside
        # run()'s try/finally — registering here would leak a
        # permanently active scope if construction fails or the runner
        # is never run.
        self.device_scope = DeviceScope()
        self.env.cloud.chaos.reseed(seed + 1)
        self.rng = random.Random(seed)
        self.view = SimView(self)
        self._workloads: List[Workload] = list(scenario.workloads)
        if scenario.tape_factory is not None and tape is None:
            from karpenter_tpu_torch.load.generators import TapeWorkload

            self._workloads.append(
                TapeWorkload(scenario.tape_factory(seed, ticks))
            )
        if scenario.vector_invariants:
            from karpenter_tpu_torch.load.invariants import VectorInvariantChecker

            self.checker: InvariantChecker = VectorInvariantChecker(
                self.env, deadline_s=scenario.schedule_deadline_s
            )
        else:
            self.checker = InvariantChecker(
                self.env, deadline_s=scenario.schedule_deadline_s
            )
        self.checker.attach(op)
        self.env.default_node_class()
        self.env.default_node_pool()
        if trace is not None:
            self.env.cloud.recorder.taps.append(trace.api)
        # run accounting
        self.sim_pods: set = set()  # keys of pods the sim created
        self.event_counts: Dict[str, int] = {}
        self.pods_created = 0
        self.pods_deleted = 0
        self.peak_pending = 0
        self.cost_by_ct: Dict[str, float] = {}
        # cluster event ledger accounting (obs/events.py): the operator's
        # decision records, drained once per tick into the trace and the
        # report's `cluster_events` section — deterministic, so the led
        # lines are part of the byte-comparable surface
        self._led_seq = 0
        self.cluster_event_counts: Dict[str, int] = {}
        self.disruptions_by_reason: Dict[str, int] = {}
        self.t0 = self.env.clock.now()
        self._sched = self.t0
        # fleet-level accounting (report's `fleet` section): a streaming
        # sketch over EVERY time-to-schedule observation (the registry
        # histogram's exact window saturates at 1024), bound-pod seconds
        # for cost-per-pod-hour, and the settle clock
        from karpenter_tpu_torch.load.sketch import QuantileSketch

        self.tts_sketch = QuantileSketch()
        self.env.registry.attach_sketch(
            "karpenter_pods_time_to_schedule_seconds", self.tts_sketch
        )
        self.pod_seconds = 0.0
        self.time_to_settle_s = 0.0
        self._last_pending_at = self.t0

    # ------------------------------------------------------------- events
    def apply_event(self, ev: SimEvent) -> None:
        env, kube, cloud = self.env, self.env.kube, self.env.cloud
        k, d = ev.kind, ev.data
        self.event_counts[k] = self.event_counts.get(k, 0) + 1
        env.registry.inc("karpenter_sim_events_injected_total", {"kind": k})
        if k == "pod_create":
            # optional labels + pod-(anti-)affinity terms (plain-JSON
            # encoded so recorded traces stay self-contained): the gang
            # and scale-anchor events in load/corpus.py use these
            affinity = [
                PodAffinityTerm(
                    topology_key=t["topology_key"],
                    label_selector=tuple(
                        sorted(
                            (str(lk), str(lv))
                            for lk, lv in t.get("match_labels", {}).items()
                        )
                    ),
                    anti=bool(t.get("anti", False)),
                )
                for t in d.get("affinity", [])
            ]
            pod = Pod(
                name=d["name"],
                labels=dict(d.get("labels", {})),
                requests=Resources(
                    cpu=d["cpu"], memory=int(d["mem_gib"] * 2**30)
                ),
                pod_affinity=affinity,
            )
            kube.put_pod(pod)
            self.sim_pods.add(pod.key())
            self.checker.note_pod(pod.key())
            self.pods_created += 1
        elif k == "pod_delete":
            if d["key"] in kube.pods:
                kube.delete_pod(d["key"])
                self.pods_deleted += 1
        elif k == "instance_kill":
            try:  # the raw API is chaos-subjected too, like a real console
                cloud.terminate_instances([d["id"]])
            except CloudAPIError:
                pass
            self.checker.note_disruption()
        elif k == "spot_interruption":
            cloud.send_message(
                {"kind": "spot_interruption", "instance_id": d["id"]}
            )
            self.checker.note_disruption()
        elif k == "chaos":
            self._apply_chaos(d["op"], dict(d.get("kw", {})))
        elif k == "az_down":
            cloud.mark_zone_insufficient(d["zone"])
            doomed = [
                i.id
                for i in cloud.instances.values()
                if i.zone == d["zone"] and i.state == "running"
            ]
            try:
                cloud.terminate_instances(doomed)
            except CloudAPIError:
                pass
            self.checker.note_disruption()
        elif k == "az_up":
            cloud.clear_zone_insufficient(d["zone"])
            self.checker.note_disruption()
        elif k == "image_roll":
            # catalog roll: a newer image generation appears; resolved AMIs
            # change and existing nodes start reporting image drift
            cloud.add_image(
                FakeImage(
                    id=d["id"],
                    family=d.get("family", "standard"),
                    arch=d.get("arch", "amd64"),
                    created_at=env.clock.now(),
                    name=d["id"],
                )
            )
            env.images.invalidate()
        elif k == "image_deprecate":
            # rolling catalog deprecation: the SSM-style latest-image
            # lookup skips deprecated images, so resolved AMIs move and
            # nodes on the old image start reporting drift
            im = cloud.images.get(d["id"])
            if im is not None:
                im.deprecated = True
                env.images.invalidate()
        elif k == "price_shock":
            # spot market repricing: scale the spot override for the
            # matching (type, zone) cells by `factor` (empty selector =
            # every type / every zone).  The pricing provider picks the
            # change up on its next deterministic refresh.
            type_sel = d.get("instance_type", "")
            zone_sel = d.get("zone", "")
            factor = float(d["factor"])
            for t in sorted(cloud.shapes):
                if type_sel and t != type_sel:
                    continue
                for z in cloud.zones:
                    if zone_sel and z != zone_sel:
                        continue
                    cloud.spot_prices[(t, z)] = round(
                        cloud.spot_price(t, z) * factor, 9
                    )
        elif k == "pool_update":
            pool = kube.node_pools.get(d["pool"])
            if pool is None:
                return
            if "labels" in d:
                pool.labels = {**pool.labels, **d["labels"]}
            if "budgets" in d:
                pool.disruption.budgets = list(d["budgets"])
            kube.put_node_pool(pool)
        else:
            raise ValueError(f"unknown sim event kind: {k}")

    def _apply_chaos(self, op_name: str, kw: dict) -> None:
        chaos = self.env.cloud.chaos
        now = self.env.clock.now()
        until = now
        if op_name in ("add_blackout", "add_throttle_burst"):
            # windows are recorded as durations; start resolves to the
            # simulated now, so the trace carries no absolute times
            duration = kw.pop("duration")
            until = now + duration
            getattr(chaos, op_name)(now, duration, **kw)
        elif op_name in (
            "set_error_rate", "set_latency", "set_partial_fleet",
            "reseed", "clear",
        ):
            getattr(chaos, op_name)(**kw)
        else:
            raise ValueError(f"unknown chaos op: {op_name}")
        self.checker.note_disruption(until)

    # -------------------------------------------------------------- ticking
    def _tick(self, tick: int, dt: float, phase: str,
              events: Sequence[SimEvent]) -> None:
        env = self.env
        # harness phase split (wall clock, perf_counter): feeds ONLY the
        # non-deterministic --profile section and the bench line — the
        # byte-compared trace/report never read these histograms
        t_apply0 = time.perf_counter()
        if self.trace is not None:
            self.trace.tick_start(tick, dt, phase)
        for ev in events:
            if self.trace is not None:
                self.trace.event(tick, ev.kind, ev.data)
            self.apply_event(ev)
        t_rec0 = time.perf_counter()
        self._sched += dt
        env.clock.advance_to(self._sched)
        env.kubelet.step()
        env.operator.reconcile_once()  # any raise here fails the run
        env.kubelet.step()
        for led in env.operator.ledger.drain(self._led_seq):
            self._led_seq = led.seq
            self.cluster_event_counts[led.type] = (
                self.cluster_event_counts.get(led.type, 0) + 1
            )
            if led.type == "NodeDisrupted":
                reason = led.attrs.get("reason", "")
                self.disruptions_by_reason[reason] = (
                    self.disruptions_by_reason.get(reason, 0) + 1
                )
            if self.trace is not None:
                self.trace.ledger(tick, led)
        t_inv0 = time.perf_counter()
        self.checker.check_tick(tick)
        t_inv1 = time.perf_counter()
        env.registry.observe(
            "karpenter_sim_phase_seconds", t_rec0 - t_apply0,
            {"phase": "apply"},
        )
        env.registry.observe(
            "karpenter_sim_phase_seconds", t_inv0 - t_rec0,
            {"phase": "reconcile"},
        )
        env.registry.observe(
            "karpenter_sim_phase_seconds", t_inv1 - t_inv0,
            {"phase": "invariants"},
        )
        env.registry.inc("karpenter_sim_ticks_total", {"phase": phase})
        pending = len(env.kube.pending_pods())
        self.peak_pending = max(self.peak_pending, pending)
        env.registry.set("karpenter_sim_pending_pods", float(pending))
        if pending:
            self._last_pending_at = env.clock.now()
        # bound pods x simulated seconds (sim pods are either Pending or
        # bound-Running, so the difference IS the bound count)
        self.pod_seconds += (len(env.kube.pods) - pending) * dt
        for inst in env.cloud.instances.values():
            if inst.state != "running":
                continue
            price = (
                env.pricing.spot_price(inst.instance_type, inst.zone)
                if inst.capacity_type == "spot"
                else env.pricing.on_demand_price(inst.instance_type)
            )
            self.cost_by_ct[inst.capacity_type] = (
                self.cost_by_ct.get(inst.capacity_type, 0.0)
                + (price or 0.0) * dt / 3600.0
            )
        if self.trace is not None:
            self.trace.digest(tick, env)

    def run(self) -> dict:
        """Execute the scenario (or the replay tape) end to end; returns
        the deterministic SLO report.  The trace is closed even when a
        tick raises — a crashing run's trace is exactly the artifact a
        reproduction needs."""
        self.device_scope = OBSERVATORY.begin_scope()
        try:
            return self._run()
        finally:
            OBSERVATORY.end_scope(self.device_scope)
            if self.trace is not None:
                self.trace.close()

    def _run(self) -> dict:
        scn = self.scenario
        if self.trace is not None:
            self.trace.meta(scn.name, self.seed, self.ticks, scn.tick_s)
        for tick in range(self.ticks):
            t_gen0 = time.perf_counter()
            if self.tape is not None:
                dt, recorded = self.tape.get(tick, (scn.tick_s, []))
                events = [SimEvent(k, d) for k, d in recorded]
            else:
                events = [
                    ev
                    for w in self._workloads
                    for ev in w.events(tick, self.rng, self.view)
                ]
                dt = (
                    self.rng.choice(list(scn.tick_jitter))
                    if scn.tick_jitter
                    else scn.tick_s
                )
            self.env.registry.observe(
                "karpenter_sim_phase_seconds",
                time.perf_counter() - t_gen0,
                {"phase": "generate"},
            )
            self._tick(tick, dt, "run", events)
        # drain: outlast the recovery windows (ICE TTL 180s, GC grace 30s)
        tick = self.ticks
        for _ in range(scn.drain_rounds):
            self._tick(tick, scn.drain_step_s, "drain", [])
            tick += 1
        # settle: finish scheduling whatever the tail created, and let
        # late disruption actions converge — a consolidation on the last
        # drain tick may evict pods that re-pend, so exit only after two
        # consecutive pending-free ticks; the final checks must never
        # race an in-flight eviction the controllers would absorb next
        # tick anyway
        quiet = 0
        for _ in range(scn.settle_rounds):
            self._tick(tick, scn.settle_step_s, "settle", [])
            tick += 1
            if self.env.kube.pending_pods():
                quiet = 0
            else:
                quiet += 1
                if quiet >= 2:
                    break
        self.checker.check_final(self._controller_names())
        # time-to-settle: the last simulated moment with pending pods,
        # relative to t0 — a function of the simulated clock only, so
        # it belongs to the byte-compared fleet section (and, for the
        # scale anchors, to the settle-budget invariant)
        self.time_to_settle_s = round(self._last_pending_at - self.t0, 6)
        self.env.registry.set(
            "karpenter_sim_time_to_settle_seconds", self.time_to_settle_s
        )
        if (
            scn.settle_budget_s is not None
            and self.time_to_settle_s > scn.settle_budget_s
        ):
            self.checker._fail(
                "settle-budget",
                f"pending pods last seen at +{self.time_to_settle_s:.0f}s "
                f"(budget {scn.settle_budget_s:.0f}s)",
            )
        report = build_report(self)
        if self.trace is not None:
            self.trace.report(report)
        return report

    def _controller_names(self) -> List[str]:
        names = [n for n in SOAK_CONTROLLERS]
        if self.env.operator.interruption is None:
            names.remove("interruption")
        return names


# --------------------------------------------------------------------- DSL
ScenarioFactory = Callable[[int], Scenario]
SCENARIOS: Dict[str, ScenarioFactory] = {}


def scenario(name: str, description: str = ""):
    def deco(fn: ScenarioFactory) -> ScenarioFactory:
        def build(ticks: int) -> Scenario:
            s = fn(ticks)
            s.name = name
            if description and not s.description:
                s.description = description
            return s

        SCENARIOS[name] = build
        return build

    return deco


@scenario("steady", "stationary arrivals + light churn, no faults")
def _steady(ticks: int) -> Scenario:
    return Scenario(
        "steady", workloads=[Steady(rate=0.5), Churn(rate=0.05)]
    )


@scenario("diurnal", "sine day/night load + churn")
def _diurnal(ticks: int) -> Scenario:
    return Scenario(
        "diurnal",
        workloads=[
            Diurnal(mean=0.6, amplitude=0.8, period_ticks=max(50, ticks // 2)),
            Churn(rate=0.08),
        ],
    )


@scenario("batch-waves", "periodic batch-job waves")
def _batch_waves(ticks: int) -> Scenario:
    return Scenario(
        "batch-waves",
        workloads=[BatchWaves(every=25, size=10), Churn(rate=0.03)],
    )


@scenario("flash-crowd", "quiet baseline with sudden bursts")
def _flash_crowd(ticks: int) -> Scenario:
    return Scenario(
        "flash-crowd",
        workloads=[
            Steady(rate=0.2),
            FlashCrowd(prob=0.05, min_size=8, max_size=16),
            Churn(rate=0.05),
        ],
    )


@scenario("interruption-storm", "a spot pool dries up mid-run")
def _interruption_storm(ticks: int) -> Scenario:
    start = max(5, ticks // 4)
    return Scenario(
        "interruption-storm",
        workloads=[
            Steady(rate=0.5),
            Churn(rate=0.05),
            InterruptionStorm(
                start=start, duration=max(5, ticks // 5), per_tick=2
            ),
        ],
    )


@scenario(
    "api-storm+catalog-roll",
    "sustained API faults while the image catalog rolls and budgets tighten",
)
def _api_storm_catalog_roll(ticks: int) -> Scenario:
    t1 = max(5, ticks // 5)
    mid = max(t1 + 5, ticks // 2)
    clear = max(mid + 5, (3 * ticks) // 4)
    return Scenario(
        "api-storm+catalog-roll",
        workloads=[
            Steady(rate=0.5),
            Churn(rate=0.05),
            Script(
                {
                    t1: [
                        ("chaos", {"op": "set_error_rate",
                                   "kw": {"api": "*", "rate": 0.08,
                                          "code": "InternalError"}}),
                        ("chaos", {"op": "add_throttle_burst",
                                   "kw": {"duration": 8.0}}),
                    ],
                    t1 + 10: [
                        ("chaos", {"op": "add_blackout",
                                   "kw": {"duration": 6.0}}),
                    ],
                    mid: [
                        ("image_roll", {"id": "image-standard-amd64-v2",
                                        "family": "standard",
                                        "arch": "amd64"}),
                        ("pool_update", {"pool": "default",
                                         "budgets": ["2"]}),
                    ],
                    clear: [("chaos", {"op": "clear"})],
                }
            ),
        ],
        slo_rules=[
            SLORule(
                name="cloud-circuit-open", signal="circuits_open",
                threshold=0.0, op=">", budget=0.1,
                fast_window_s=10.0, slow_window_s=30.0,
                description="cloud circuit breakers open under the storm",
            ),
            SLORule(
                name="pending-pod-age", signal="pending_pod_age_max",
                threshold=60.0, op=">", budget=0.1,
                fast_window_s=20.0, slow_window_s=60.0,
                description="pods must nominate within a simulated minute",
            ),
        ],
    )


@scenario(
    "diurnal+interruption-storm",
    "day/night load with a capacity-reclaim storm at peak",
)
def _diurnal_interruption(ticks: int) -> Scenario:
    period = max(50, ticks // 2)
    storm_start = max(5, period // 4)  # around the first peak
    return Scenario(
        "diurnal+interruption-storm",
        workloads=[
            Diurnal(mean=0.6, amplitude=0.8, period_ticks=period),
            Churn(rate=0.05),
            InterruptionStorm(
                start=storm_start, duration=max(8, ticks // 6), per_tick=2
            ),
            Script(
                {
                    storm_start: [
                        ("chaos", {"op": "set_partial_fleet",
                                   "kw": {"rate": 0.1}}),
                    ],
                    storm_start + max(8, ticks // 6): [
                        ("chaos", {"op": "set_partial_fleet",
                                   "kw": {"rate": 0.0}}),
                    ],
                }
            ),
        ],
    )


@scenario(
    "resident-churn",
    "steady pod churn + node add/remove + one mid-run catalog roll: the "
    "device-resident delta path's acceptance scenario — warm ticks must "
    "apply as scatter deltas (solver.resident hits), the roll must force "
    "exactly the rebuild fallback, and record/replay must stay "
    "byte-identical with the resident path on",
)
def _resident_churn(ticks: int) -> Scenario:
    mid = max(5, ticks // 2)
    return Scenario(
        "resident-churn",
        workloads=[
            # enough arrivals that most ticks carry a pod delta, enough
            # deletions that classes empty out and compact, and enough
            # out-of-band kills that live-node columns come and go
            Steady(rate=0.9),
            Churn(rate=0.35),
            InstanceKiller(rate=0.06),
            Script(
                {
                    mid: [
                        # catalog roll: the image provider invalidates,
                        # the instance-type lists are new objects, and
                        # the resident catalog key misses — the one
                        # sanctioned full-tensorize fallback mid-run
                        ("image_roll", {"id": "image-standard-amd64-v2",
                                        "family": "standard",
                                        "arch": "amd64"}),
                    ],
                }
            ),
        ],
    )


@scenario(
    "single-pod-trickle",
    "one pod at a time against warm resident capacity — the admission "
    "fast path's home turf: a low steady trickle keeps nearly every "
    "arrival a lone fresh pod, light churn keeps headroom open on live "
    "nodes, and the fast path must nominate most of them in one admit "
    "dispatch (fastpath outcome=nominated > 0, mismatch counter 0) "
    "while record/replay stays byte-identical with the fast path live",
)
def _single_pod_trickle(ticks: int) -> Scenario:
    return Scenario(
        "single-pod-trickle",
        workloads=[
            # sparse enough that simultaneous arrivals are rare (the
            # lone-fresh-pod shape), dense enough that the fast path
            # gets real traffic over a 60-tick run
            Steady(rate=0.35),
            Churn(rate=0.1),
        ],
    )


@scenario(
    "consolidation-storm",
    "over-provisioned fleet on small shapes + a deep diurnal trough + "
    "background spot interruptions: flash crowds spin up many small "
    "nodes, heavy churn then empties them out, and the trough leaves a "
    "fleet the population search must consolidate hard — the "
    "device-resident consolidation-search acceptance scenario "
    "(record/replay byte-identical with the seeded search on, "
    "consolidation.search report section populated, verdict mismatches "
    "zero)",
)
def _consolidation_storm(ticks: int) -> Scenario:
    period = max(40, (2 * ticks) // 3)
    return Scenario(
        "consolidation-storm",
        # small shapes so the fleet is many small nodes — the candidate
        # universes the removal-mask population actually searches over
        shapes=generate_catalog(generations=(1, 2), cpus=(4, 8)),
        workloads=[
            # over-provision: bursts open nodes the trough won't need
            FlashCrowd(prob=0.18, min_size=12, max_size=20),
            # day/night curve with a deep trough (rate clamps to ~0)
            Diurnal(mean=1.0, amplitude=0.95, period_ticks=period),
            # mass scale-downs: an INSTANT drop strands several nodes at
            # once — the multi-node subsets the population search is for
            # (gradual churn never outruns the single-node scan)
            ScaleDown(
                ticks=(ticks // 4, ticks // 2, (3 * ticks) // 4),
                fraction=0.7,
            ),
            Churn(rate=0.4),
            SpotInterrupter(rate=0.04),
        ],
    )


@scenario(
    "slo-burn",
    "a short blackout opens circuit breakers: deterministic SLO "
    "burn-rate breach, then recovery — the diagnosis layer's acceptance "
    "scenario in miniature",
)
def _slo_burn(ticks: int) -> Scenario:
    t1 = max(3, ticks // 6)
    return Scenario(
        "slo-burn",
        workloads=[
            Steady(rate=0.3),
            Script(
                {
                    t1: [("chaos", {"op": "add_blackout",
                                    "kw": {"duration": 8.0}})],
                }
            ),
        ],
        slo_rules=[
            SLORule(
                name="cloud-circuit-open", signal="circuits_open",
                threshold=0.0, op=">", budget=0.1,
                fast_window_s=10.0, slow_window_s=30.0,
                description="the blackout opens breakers; closing them "
                "recovers the rule",
            ),
            SLORule(
                name="pending-pod-age", signal="pending_pod_age_max",
                threshold=60.0, op=">", budget=0.1,
                fast_window_s=20.0, slow_window_s=60.0,
                description="pods must nominate within a simulated minute",
            ),
        ],
    )


def chaos_soak_scenario(faulty_ticks: int) -> Scenario:
    """The chaos suite's `_soak` as a Scenario: the same mixed fault
    schedule (sustained error rate, injected latency, partial fleet,
    throttle burst, full + scoped blackouts), the same workload churn
    distribution, the same variable tick cadence — faults clear at
    `faulty_ticks`."""
    return Scenario(
        "chaos-soak",
        workloads=[
            SoakChurn(),
            Script(
                {
                    0: [
                        ("chaos", {"op": "set_error_rate",
                                   "kw": {"api": "*", "rate": 0.05,
                                          "code": "InternalError"}}),
                        ("chaos", {"op": "set_latency",
                                   "kw": {"api": "CreateFleet",
                                          "seconds": 0.002}}),
                        ("chaos", {"op": "set_partial_fleet",
                                   "kw": {"rate": 0.15}}),
                    ],
                    9: [("chaos", {"op": "add_throttle_burst",
                                   "kw": {"duration": 8.0}})],
                    26: [("chaos", {"op": "add_blackout",
                                    "kw": {"duration": 6.0}})],
                    43: [("chaos", {"op": "add_blackout",
                                    "kw": {"duration": 8.0,
                                           "apis": ["DescribeSubnets",
                                                    "DescribeImages"]}})],
                    faulty_ticks: [("chaos", {"op": "clear"})],
                }
            ),
        ],
        tick_jitter=(0.5, 1.0, 2.0),
        settle_rounds=40,
        # the acceptance scenario for the diagnosis layer: the blackout
        # opens circuit breakers -> burn-rate breach; the post-clear
        # recovery closes them -> SLORecovered.  Both land in the ledger
        # (and so in the byte-compared `led` trace lines) with the
        # breaching tick's trace ID.
        slo_rules=[
            SLORule(
                name="cloud-circuit-open", signal="circuits_open",
                threshold=0.0, op=">", budget=0.1,
                fast_window_s=10.0, slow_window_s=30.0,
                description="cloud circuit breakers open under chaos",
            ),
        ],
    )


SCENARIOS["chaos-soak"] = lambda ticks: chaos_soak_scenario(
    faulty_ticks=(3 * ticks) // 4
)


# -------------------------------------------------------------------- entry
def _register_corpus() -> None:
    """Pull in the load-harness corpus (registers its scenarios via the
    @scenario decorator).  Imported lazily from the entry points — not
    at module import — to keep `sim -> load -> sim` acyclic."""
    import karpenter_tpu_torch.load.corpus  # noqa: F401


def run_scenario(
    name: str,
    seed: int,
    ticks: int,
    trace: Optional[TraceWriter] = None,
    device=None,
) -> Tuple[ScenarioRunner, dict]:
    """Run scenario ``name`` on ``device`` (None: the card)."""
    _register_corpus()
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        )
    runner = ScenarioRunner(
        SCENARIOS[name](ticks), seed, ticks, trace=trace, device=device
    )
    return runner, runner.run()


def replay(
    trace_path: str, trace: Optional[TraceWriter] = None, device=None
) -> Tuple[ScenarioRunner, dict, Optional[dict]]:
    """Re-execute a recorded trace: rebuild the scenario's environment
    from the registry (settings/shapes are code, not data), then apply the
    recorded tick durations and events instead of generating, on
    ``device`` (None: the card).  Returns (runner, recomputed report, the
    report recorded in the trace)."""
    _register_corpus()
    meta, tape, recorded_slo = read_tape(trace_path)
    factory = SCENARIOS.get(meta["scenario"])
    if factory is None:
        raise KeyError(
            f"trace needs scenario {meta['scenario']!r}, which this build "
            "does not define"
        )
    runner = ScenarioRunner(
        factory(meta["ticks"]),
        meta["seed"],
        meta["ticks"],
        trace=trace,
        tape=tape,
        device=device,
    )
    return runner, runner.run(), recorded_slo
