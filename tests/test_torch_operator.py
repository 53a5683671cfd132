"""The port's operator, tick for tick against the JAX package's.

Each scenario builds the JAX package's ``karpenter_tpu.testing.Environment``
(on the CPU, as tier-1 runs it) and the port's ``Environment(device="cpu")``
over the same shapes and zones, with the admission fast path at its default
(on), then feeds both the same seeded arrivals (numpy
``default_rng(seed)``).  After EVERY ``env.step`` the two must agree on:
the NodeClaims, the Nodes, each pod's binding and nomination, every fake
cloud API call in order, the event ledger's stream, the compile-cache,
resident, admission fast-path and disruption counters in the registry, the
disruption side (instances launched and terminated, claims marked and
replaced, ``NodeDisrupted`` and ``VerdictFallback`` events), and the
device observatory's resident updates by kind, its set of transfer sites
and its ``resident_seed`` bytes.

Both operators run every controller, disruption included
(``LEFT_OUT_CONTROLLERS`` is empty).  Most scenarios keep the pipelined
schedule off and give their NodePools a ``consolidate_after`` that
outlasts the run, so they drive provisioning alone: after the last tick
the reference's disruption controller reconciles once more on the final
cluster and must take no action.  The consolidating scenario lowers
``consolidate_after`` and deletes pods so that nodes go part-empty, and
runs with the pipelined schedule on and off.

Both operators run the diagnosis layer (the SLO engine, the anomaly
detector, the flight recorder).  `testing.operator_state` leaves out its
events that judge wall-clock latencies or process compile history
(``AnomalyDetected``, ``DeviceRecompile``, and the ``SLOBreach`` /
``SLORecovered`` of the tick-duration rule), so the breaches and
recoveries of the five other rules are held equal, in order.

Transfer bytes are held equal at ``resident_seed`` only.  The other sites
differ in bytes by design: the port uploads a delta's payload as three
packed arrays (``resident_delta``) where the reference hands the scatter
step its index and payload arrays one by one, and a cold pack uploads its
per-solve arguments as they are (``pack_kernel_buffered``) where the
reference packs them into one buffer.  Both cache a cold pack's catalog
columns on the device and upload them once a catalog at
``pack_constants``.
"""

import importlib

import numpy as np
import pytest

from karpenter_tpu_torch.testing import operator_state

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
LEFT_OUT_CONTROLLERS = ()
TICK_S = 2.0
SMALL_SHAPES = dict(generations=(1, 2), cpus=(1, 2, 4, 8, 16, 32))
# config 2's catalog (bench.py's heterogeneous problem)
CONFIG2_SHAPES = dict(
    generations=(1, 2, 3),
    cpus=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192),
)
SIZES = ((0.25, "512Mi"), (0.5, "1Gi"), (1, "2Gi"), (2, "4Gi"), (0.75, "3Gi"))


class Side:
    """One package's operator environment and its accounting."""

    def __init__(self, pkg: str, shapes_kw: dict, pools: tuple,
                 consolidate_after: float = 1e6, pipelined: bool = False, **settings_kw):
        self.pkg = pkg
        a = self.api = importlib.import_module(f"{pkg}.api")
        objects = importlib.import_module(f"{pkg}.api.objects")
        testing = importlib.import_module(f"{pkg}.testing")
        backend = importlib.import_module(f"{pkg}.cloud.fake.backend")
        self.backend = backend
        self.obs = importlib.import_module(f"{pkg}.obs.device").OBSERVATORY
        objects.reset_name_sequences()
        settings = a.Settings(
            cluster_name="test", enable_pipelined_reconcile=pipelined, **settings_kw
        )
        kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
        self.env = env = testing.Environment(
            shapes=backend.generate_catalog(**shapes_kw), settings=settings, **kw
        )
        env.default_node_class()
        for name, tainted in pools:
            env.default_node_pool(
                name=name,
                disruption=objects.Disruption(consolidate_after=consolidate_after),
                taints=[a.Taint(key="dedicated", value="batch", effect="NoSchedule")]
                if tainted else [],
            )
        # launches one at a time, in claim order (the simulator's
        # determinism knob): concurrent creates would hand out instance ids
        # in thread order
        env.operator.provisioner.launch_concurrency = 1
        self.scope = self.obs.begin_scope()

    def close(self):
        self.obs.end_scope(self.scope)

    # ---------------------------------------------------------------- drive
    def pod(self, spec):
        a = self.api
        cpu, mem, selector, tolerate = spec
        p = a.Pod(requests=a.Resources(cpu=cpu, memory=mem), node_selector=dict(selector))
        if tolerate:
            p.tolerations = [a.Toleration(key="dedicated", value="batch", effect="NoSchedule")]
        return p

    def add(self, specs):
        for spec in specs:
            self.env.kube.put_pod(self.pod(spec))

    def delete_bound(self, rng, n: int):
        bound = sorted(k for k, p in self.env.kube.pods.items() if p.node_name)
        for i in sorted(rng.choice(len(bound), size=min(n, len(bound)), replace=False)):
            self.env.kube.delete_pod(bound[i])

    # ---------------------------------------------------------------- read
    def state(self) -> dict:
        st = operator_state(self.env)
        sc = self.scope
        st["resident_updates"] = dict(sc.resident_updates)
        st["transfer_sites"] = sorted(sc.transfer_bytes)
        st["resident_seed_bytes"] = sc.transfer_bytes.get("resident_seed", 0)
        return st


def _twin(shapes_kw, pools=(("default", False),), **kw):
    sides = [Side(pkg, shapes_kw, pools, **kw) for pkg in PACKAGES]
    # the port's operator runs the reference's controllers, in its order
    ref, port = ([(s.name, bool(s.dispatch), bool(s.advance))
                  for s in sd.env.operator.pipeline.specs] for sd in sides)
    assert [s for s in ref if s[0] not in LEFT_OUT_CONTROLLERS] == port
    return sides


def _step_and_compare(sides, tick: int) -> dict:
    states = []
    for sd in sides:
        sd.env.step(TICK_S)
        states.append(sd.state())
    ref, port = states
    for key in ref:
        assert ref[key] == port[key], (tick, key, ref[key], port[key])
    return ref


def _finish(sides, consolidating: bool = False) -> dict:
    for sd in sides:
        errs = sd.env.registry.counters.get("karpenter_controller_reconcile_errors_total", {})
        assert not errs, (sd.pkg, errs)
        sd.close()
    if consolidating:
        return sides[1].scope
    ref_env = sides[0].env
    # the reference's disruption controller, run on the final cluster,
    # takes no action
    claims = sorted(ref_env.kube.node_claims)
    before = len(ref_env.operator.ledger.recent(limit=1 << 30))
    ref_env.operator.disruption.reconcile()
    reg = ref_env.registry
    assert not reg.counters.get("karpenter_deprovisioning_actions")
    assert not any(
        ev.type in ("NodeDisrupted", "VerdictFallback")
        for ev in ref_env.operator.ledger.recent(limit=1 << 30)[before:]
    )
    assert sorted(ref_env.kube.node_claims) == claims
    assert all(c.deleted_at is None for c in ref_env.kube.node_claims.values())
    return sides[1].scope


def _spec(rng, selectors=({},), tolerate_share=0.0):
    cpu, mem = SIZES[int(rng.integers(len(SIZES)))]
    selector = selectors[int(rng.integers(len(selectors)))]
    tolerate = bool(rng.random() < tolerate_share)
    if tolerate:
        selector = {"karpenter.sh/nodepool": "dedicated"}
    return (cpu, mem, selector, tolerate)


def test_steady_single_pool_arrivals():
    """Seeded arrivals of a few pods a tick into one pool: claims launch,
    nodes register, pods bind, and later arrivals land on live nodes."""
    rng = np.random.default_rng(11)
    plan = [[_spec(rng) for _ in range(int(rng.integers(0, 14)))] for _ in range(14)]
    plan += [[] for _ in range(4)]  # the last arrivals launch and bind
    sides = _twin(SMALL_SHAPES)
    for tick, specs in enumerate(plan):
        for sd in sides:
            sd.add(specs)
        st = _step_and_compare(sides, tick)
    scope = _finish(sides)
    assert st["claims"] and scope.resident_updates.get("seed", 0) >= 2
    assert all(p[1] for p in st["pods"]), "every pod bound"


def test_config2_shape_mix_scaled():
    """Config 2's pod mix (near-continuous sizes, selector variety, 30 % on
    the tainted dedicated pool) over its three-generation catalog, cut to
    about 200 pods arriving in waves."""
    from karpenter_tpu_torch import testing as T

    _, _, pods = T.heterogeneous_problem(scale=0.02)
    specs = [
        (p.requests.cpu, f"{int(round(p.requests.memory / 2**20))}Mi",
         tuple(sorted(p.node_selector.items())), bool(p.tolerations))
        for p in pods
    ]
    rng = np.random.default_rng(5)
    order = rng.permutation(len(specs))
    waves = np.array_split(order, 5)
    sides = _twin(CONFIG2_SHAPES, pools=(("general", False), ("dedicated", True)))
    for tick in range(12):
        wave = waves[tick] if tick < len(waves) else []
        for sd in sides:
            sd.add([(s[0], s[1], dict(s[2]), s[3]) for s in (specs[i] for i in wave)])
        st = _step_and_compare(sides, tick)
    _finish(sides)
    pools_used = {c[1] for c in st["claims"]}
    assert pools_used == {"general", "dedicated"}, pools_used
    assert all(p[1] for p in st["pods"]), "every pod bound"


def test_churn_on_bound_nodes_takes_the_delta_path():
    """Pods deleted and replaced on bound nodes while a block of pods that
    fit nowhere stays pending: each batch is mostly the previous one, so the
    resident tensors absorb the tick as a delta (the replaced pods' rows,
    the freed usage in the live nodes' columns).  Churn comes every other
    tick, so the batch window closes in between."""
    rng = np.random.default_rng(23)
    first = [_spec(rng) for _ in range(48)]
    # an architecture no instance type offers: pending for the whole run
    stuck = [(0.5, "1Gi", {"kubernetes.io/arch": "s390x"}, False)] * 24
    churn = [[_spec(rng) for _ in range(6)] if i % 2 == 0 else [] for i in range(14)]
    sides = _twin(SMALL_SHAPES)
    for sd in sides:
        sd.add(first + stuck)
    tick = 0
    for tick in range(4):
        _step_and_compare(sides, tick)
    rngs = [np.random.default_rng(99) for _ in sides]
    for i, specs in enumerate(churn):
        for sd, r in zip(sides, rngs):
            if specs:
                sd.delete_bound(r, 4)
                sd.add(specs)
        st = _step_and_compare(sides, tick + 1 + i)
    scope = _finish(sides)
    assert scope.resident_updates.get("donated", 0) >= 3, scope.resident_updates
    assert sum(1 for p in st["pods"] if not p[1]) == len(stuck)


def test_insufficient_capacity_on_one_launch():
    """An InsufficientCapacity error injected into one CreateFleet: the
    claim fails, the offering lands in the unavailable-offerings cache, and
    the pods relaunch onto other offerings next batch."""
    rng = np.random.default_rng(31)
    plan = [[_spec(rng) for _ in range(int(rng.integers(4, 12)))] for _ in range(3)]
    plan += [[] for _ in range(9)]
    sides = _twin(SMALL_SHAPES)
    for sd in sides:
        err = sd.backend.InsufficientCapacityError(("std1.large", "zone-a", "spot"))
        sd.env.cloud.recorder.set_next_error("CreateFleet", err)
    for tick, specs in enumerate(plan):
        for sd in sides:
            sd.add(specs)
        st = _step_and_compare(sides, tick)
    _finish(sides)
    ref_env = sides[0].env
    assert ref_env.registry.counter(
        "karpenter_nodeclaims_launch_failed", {"reason": "insufficient_capacity"}
    ) == sides[1].env.registry.counter(
        "karpenter_nodeclaims_launch_failed", {"reason": "insufficient_capacity"}
    ) == 1
    assert all(p[1] for p in st["pods"]), "every pod bound"


def _fastpath(st: dict, outcome: str) -> float:
    return dict(st["counters"]["karpenter_admission_fastpath_total"]).get(
        (("outcome", outcome),), 0.0)


def test_single_pod_trickle_through_the_fast_path():
    """A seed batch, then one fresh pod a tick (the shape of the reference's
    ``single-pod-trickle``): most arrivals are nominated onto live nodes by
    the fast path, a pod too large for any live node falls back to the
    batched solve, and the mismatch counter stays 0."""
    rng = np.random.default_rng(41)
    seed = [(2.5, "2Gi", {}, False)] * 12
    trickle = [[_spec(rng)] for _ in range(10)] + [[(20, "8Gi", {}, False)]]
    trickle += [[_spec(rng)] for _ in range(4)] + [[] for _ in range(4)]
    sides = _twin(SMALL_SHAPES, provision_fastpath_bypass=True)
    for sd in sides:
        sd.add(seed)
    for tick in range(3):
        st = _step_and_compare(sides, tick)
    for i, specs in enumerate(trickle):
        for sd in sides:
            sd.add(specs)
        st = _step_and_compare(sides, 3 + i)
    _finish(sides)
    assert _fastpath(st, "nominated") >= 8, st["counters"]
    assert _fastpath(st, "fallback") >= 1
    assert not st["counters"]["karpenter_admission_fastpath_mismatch_total"]
    assert all(p[1] for p in st["pods"]), "every pod bound"


def test_interruption_queue_drains_interrupted_nodes():
    """An interruption queue receives a spot interruption and a rebalance
    recommendation for two live nodes: both operators register their
    interruption controller, drain and replace the two nodes alike, and
    put the spot offering in the unavailable-offerings cache."""
    rng = np.random.default_rng(53)
    specs = [_spec(rng) for _ in range(20)] + [(2, "4Gi", {}, False)] * 40  # 3+ nodes
    sides = _twin(SMALL_SHAPES, interruption_queue_name="q")
    for sd in sides:
        assert sd.env.operator.interruption is not None
        sd.add(specs)
    tick = 0
    for tick in range(4):
        st = _step_and_compare(sides, tick)
    claims = sorted(c[0] for c in st["claims"])
    assert len(claims) >= 2
    hit = []
    for sd in sides:
        spot, rebalance = (sd.env.kube.node_claims[name] for name in claims[:2])
        sd.env.cloud.send_message({"kind": "spot_interruption", "instance_id": spot.provider_id})
        sd.env.cloud.send_message({"kind": "rebalance_recommendation",
                                   "instance_id": rebalance.provider_id})
        hit.append((spot.capacity_type, spot.instance_type_name, spot.zone))
    for i in range(8):
        st = _step_and_compare(sides, tick + 1 + i)
    _finish(sides)
    assert not {c[0] for c in st["claims"]} & set(claims[:2])
    assert all(p[1] for p in st["pods"]), "every pod bound"
    for sd, (_ct, itype, zone) in zip(sides, hit):
        reg = sd.env.registry
        for kind in ("spot_interruption", "rebalance_recommendation"):
            assert reg.counter("karpenter_interruption_received_messages",
                               {"message_type": kind}) == 1, (sd.pkg, kind)
        assert sd.env.unavailable.is_unavailable("spot", itype, zone), sd.pkg


@pytest.mark.parametrize("pipelined", [False, True])
def test_consolidation_of_part_empty_nodes(pipelined):
    """Pools that consolidate: seeded pods of mixed sizes fill a few nodes
    of both pools, then a seeded 60 % of them is deleted and the pools'
    ``consolidate_after`` lets the nodes go after 4 s.  Both operators
    consolidate alike tick for tick (multi-node deletes, replacements,
    the evicted pods' rebinding), with the pipelined schedule on and off;
    the port's batched verdicts answer, and no verdict mismatches."""
    rng = np.random.default_rng(61)
    specs = [_spec(rng, selectors=({}, {"kubernetes.io/arch": "amd64"}), tolerate_share=0.3)
             for _ in range(70)]
    sides = _twin(SMALL_SHAPES, pools=(("general", False), ("dedicated", True)),
                  consolidate_after=4.0, pipelined=pipelined)
    for sd in sides:
        sd.add(specs)
    tick = 0
    for tick in range(3):
        st = _step_and_compare(sides, tick)
    claims0 = len(st["claims"])
    rngs = [np.random.default_rng(67) for _ in sides]
    for sd, r in zip(sides, rngs):
        sd.delete_bound(r, 42)
    for i in range(16):
        st = _step_and_compare(sides, tick + 1 + i)
    scope = _finish(sides, consolidating=True)
    actions = dict(st["counters"]["karpenter_deprovisioning_actions"])
    assert sum(actions.values()) >= 1, st["counters"]
    assert len([c for c in st["claims"] if c[7] is None]) < claims0
    evals = dict(st["counters"]["karpenter_consolidation_evals_total"])
    assert evals.get((("path", "batched"),), 0) > 0, evals
    assert not st["counters"]["karpenter_consolidation_verdict_mismatch_total"]
    assert all(p[1] for p in st["pods"]), "every pod bound"
    assert scope.dispatches.get("population_verdicts", 0) > 0, dict(scope.dispatches)
    spec = sides[1].env.registry.counters.get("karpenter_pipeline_speculation_total", {})
    assert bool(spec) is pipelined, spec


def test_fast_path_on_and_off_place_alike():
    """The port's operator runs the admission fast path (the default
    Settings ask for it; it was refused before the path was ported): the
    same seed batch and single-pod trickle with the fast path on and off
    end with every pod on the same node, with nominations on the fast
    path and no mismatch."""
    from karpenter_tpu_torch.api import Pod, Resources, Settings
    from karpenter_tpu_torch.api.objects import reset_name_sequences
    from karpenter_tpu_torch.testing import Environment

    def run(on: bool):
        reset_name_sequences()
        env = Environment(settings=Settings(cluster_name="test", enable_admission_fastpath=on,
                                            provision_fastpath_bypass=on), device="cpu")
        env.default_node_class()
        env.default_node_pool()
        for i in range(12):
            env.kube.put_pod(Pod(name=f"seed-{i:02d}", requests=Resources(cpu=2.5, memory="2Gi")))
        env.settle()
        for i in range(6):
            env.kube.put_pod(Pod(name=f"trickle-{i}", requests=Resources(cpu=0.1, memory="64Mi")))
            env.step(TICK_S)
        env.settle()
        assert not env.kube.pending_pods()
        return env, {k: p.node_name for k, p in sorted(env.kube.pods.items())}

    fast, placed_fast = run(True)
    slow, placed_slow = run(False)
    assert placed_fast == placed_slow
    assert fast.registry.counter("karpenter_admission_fastpath_total", {"outcome": "nominated"}) > 0
    assert fast.registry.counter("karpenter_admission_fastpath_mismatch_total") == 0
    assert not slow.registry.counters.get("karpenter_admission_fastpath_total")
    assert Environment(device="cpu").operator.settings.enable_admission_fastpath


@pytest.mark.parametrize("setting", [
    dict(enable_profiling=True, profile_dir="prof"),
    dict(enable_lock_sanitizer=True, lock_watchdog_stall_s=5.0),
], ids=["setting0-A8", "setting2-A3e"])  # the ids before flight_dir was ported
def test_operator_refuses_an_unported_setting(setting):
    """A setting whose path the port did not run was an error naming the
    ROADMAP item that brings it.  Every such item is ported now (the span
    dump and the device trace under ``profile_dir``, A8a; the lock
    watchdog, A3e), so each setting is accepted and the operator arms its
    path: the process tracer with its ``profile_dir``, and the watchdog
    once the sanitizer is enabled."""
    from karpenter_tpu_torch.analysis import sanitizer
    from karpenter_tpu_torch.api import Settings
    from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, generate_catalog
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.state.kube import KubeStore
    from karpenter_tpu_torch.utils.clock import FakeClock
    from karpenter_tpu_torch.utils.trace import TRACER

    cloud = FakeCloud(FakeClock(), shapes=generate_catalog(**SMALL_SHAPES)).with_default_topology()
    settings = Settings(cluster_name="test", **setting)
    if settings.enable_profiling:
        try:
            op = Operator(cloud, KubeStore(), settings=settings, device="cpu")
            assert op.tracer is TRACER and TRACER.enabled
            assert TRACER.profile_dir == "prof"
        finally:
            TRACER.enabled = False
            TRACER.profile_dir = ""
            TRACER.reset()
        return
    sanitizer.enable("refusal")
    try:
        op = Operator(cloud, KubeStore(), settings=settings, device="cpu")
    finally:
        sanitizer.disable()
    assert op.watchdog is not None and op.watchdog.stall_s == 5.0


def test_operator_runs_on_the_card_unless_asked():
    """The operator's device is the card by default; without one, asking
    for it raises instead of falling back to the CPU."""
    import torch

    from karpenter_tpu_torch.testing import Environment

    if torch.cuda.is_available():
        assert Environment().operator.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Environment()
    env = Environment(device="cpu")
    assert env.operator.device.type == "cpu"
    assert env.operator.provisioner.scheduler.device.type == "cpu"


def test_entry_point_prints_a_line_a_tick():
    """``python -m karpenter_tpu_torch --ticks 3 --device cpu`` exits 0 and
    prints one JSON line a tick: the tick's ms, its solves by kind and the
    device observatory's tick section."""
    import json
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", "--ticks", "3", "--interval", "0.6",
         "--device", "cpu", "--pods", "40"],
        cwd=repo, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [line["tick"] for line in lines] == [1, 2, 3]
    for line in lines:
        assert line["ms"] > 0 and set(line["device"]) == {
            "compiles", "warm_recompiles", "dispatches", "transfer_bytes",
            "resident_bytes", "resident_delta_bytes"}
    solves = [line for line in lines if line["solves"]]
    assert solves and solves[0]["solves"] == {"cold": 1}
    assert solves[0]["kernel"] == "reference" and solves[0]["claims"] >= 1
    assert solves[0]["device_detail"]["dispatches"] == {"ffd_pack": 1}
