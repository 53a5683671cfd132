"""The slice as a whole against the JAX package: two replicas failing over.

`testing.HAHarness` (one `StoreServer`, two `RemoteKubeStore` clients, two
operators with `LeaderElector`s over one fake cloud and clock) runs the
failover drive (`testing.ha_drive`: the pods bound under replica A, churn
rounds, A's crash and B's take-over after the lease expires, B's graceful
release and A's second term) on the port, its operators on the CPU, and on
the JAX package (`RefHarness`: the same harness over the JAX package's
classes).  Both hold the drive's invariants (`testing.ha_checks`: every
launch from the round's leader, no claim launched twice, B launches
nothing for the pods A placed; then the consistency checker finds no
violation), and the two drives give the same launch
list (round, replica, claim), the same NodeClaims, bindings and
`operator_state` of each replica, and the same canonical store state on
the server.  The pods are seeded, config 2's shapes at a small count over
a small catalog.
"""

import random

from karpenter_tpu_torch import testing as T

N_PODS, CHURN_PODS, SEED = 96, 8, 5
SHAPES = dict(generations=(1, 2), cpus=(1, 2, 4, 8, 16, 32))


class RefHarness(T.HAHarness):
    """The harness over the JAX package's classes."""

    @staticmethod
    def parts():
        from types import SimpleNamespace

        from karpenter_tpu.api import NodeClass, NodePool, Pod, Settings
        from karpenter_tpu.api.objects import reset_name_sequences
        from karpenter_tpu.api import labels as L
        from karpenter_tpu.api.objects import SelectorTerm, tolerates_all
        from karpenter_tpu.cloud.fake.backend import FakeCloud, generate_catalog
        from karpenter_tpu.controllers.consistency import CHECK_PERIOD
        from karpenter_tpu.metrics.registry import Registry
        from karpenter_tpu.service.store_server import StoreServer
        from karpenter_tpu.state.kube import Node
        from karpenter_tpu.state.remote import RemoteKubeStore
        from karpenter_tpu.state.wire import STORE_KINDS, canonical
        from karpenter_tpu.utils.clock import FakeClock
        from karpenter_tpu.utils.leader import LEASE_DURATION_S, LeaderElector

        return SimpleNamespace(
            StoreServer=StoreServer, RemoteKubeStore=RemoteKubeStore,
            LeaderElector=LeaderElector, LEASE_DURATION_S=LEASE_DURATION_S,
            FakeCloud=FakeCloud, FakeClock=FakeClock, generate_catalog=generate_catalog,
            Registry=Registry, Settings=Settings, Pod=Pod, Node=Node,
            NodeClass=NodeClass, NodePool=NodePool, SelectorTerm=SelectorTerm,
            labels=L, tolerates_all=tolerates_all,
            reset_name_sequences=reset_name_sequences,
            STORE_KINDS=STORE_KINDS, canonical=canonical, CHECK_PERIOD=CHECK_PERIOD,
        )

    def operator(self, kube, elector, registry):
        from karpenter_tpu.operator import Operator
        from karpenter_tpu.testing import FAST_BATCH_WINDOWS

        return Operator(self.cloud, kube, settings=self.settings, clock=self.clock,
                        registry=registry, batch_windows=FAST_BATCH_WINDOWS,
                        elector=elector)


def pods(pkg: str, n: int):
    """Config 2's pod shapes (`testing.heterogeneous_pods`), seeded, with
    ``pkg``'s classes."""
    import importlib

    api = importlib.import_module(f"{pkg}.api")
    L = importlib.import_module(f"{pkg}.api.labels")
    rng = random.Random(SEED)
    tol = api.Toleration(key="dedicated", value="batch", effect="NoSchedule")
    selectors = ({}, {L.LABEL_ARCH: "amd64"}, {L.LABEL_INSTANCE_CATEGORY: "compute"},
                 {L.LABEL_INSTANCE_CATEGORY: "memory"})
    out = []
    for _ in range(n):
        i = rng.randrange(320)
        cpu = round(0.05 * (1 + i % 80), 2)
        mem_gib = max(0.25, cpu * (1, 2, 4, 8)[(i // 80) % 4])
        req = api.Resources(cpu=cpu, memory=f"{int(mem_gib * 1024)}Mi")
        if rng.random() < 0.7:
            out.append(api.Pod(requests=req, node_selector=dict(rng.choice(selectors))))
        else:
            out.append(api.Pod(requests=req, tolerations=[tol],
                               node_selector={L.LABEL_NODEPOOL: "dedicated"}))
    return out


def drive(harness_cls, pkg: str, **kw):
    import importlib

    api = importlib.import_module(f"{pkg}.api")
    settings = api.Settings(cluster_name="ha", enable_admission_fastpath=False,
                            enable_pipelined_reconcile=False, feature_gate_drift=False)
    h = harness_cls(settings=settings, **kw)
    try:
        h.default_node_class()
        hold = lambda: api.Disruption(consolidate_after=1e9)
        h.node_pool("general", disruption=hold())
        h.node_pool("dedicated", disruption=hold(), taints=[
            api.Taint(key="dedicated", value="batch", effect="NoSchedule")])
        h.sync()
        marks = T.ha_drive(h, pods(pkg, N_PODS), churn_pods=CHURN_PODS, seed=SEED)
        T.ha_checks(h, marks)
        assert T.ha_consistency(h) == []
        return {
            "launches": list(h.launches),
            "ticks": [(t["round"], t["replica"], t["led"], t["kind"], t["nominated"])
                      for t in h.ticks],
            "claims": sorted(h.writer.node_claims),
            "bindings": sorted((k, p.node_name) for k, p in h.writer.pods.items()),
            "replicas": {name: T.operator_state(h.view(name)) for name in T.HA_REPLICAS},
            "store": h.store_state(),
        }
    finally:
        h.close()


def test_failover_drive_equals_the_jax_package():
    import importlib

    shapes = {pkg: importlib.import_module(f"{pkg}.cloud.fake.backend").generate_catalog(**SHAPES)
              for pkg in ("karpenter_tpu", "karpenter_tpu_torch")}
    ref = drive(RefHarness, "karpenter_tpu", shapes=shapes["karpenter_tpu"])
    port = drive(T.HAHarness, "karpenter_tpu_torch", shapes=shapes["karpenter_tpu_torch"],
                 device="cpu")
    # both replicas placed pods in their terms
    assert {r for _, r, led, _, nom in port["ticks"] if led and nom} == set(T.HA_REPLICAS)
    for key in ("launches", "ticks", "claims", "bindings", "store"):
        assert port[key] == ref[key], key
    for name in T.HA_REPLICAS:
        for key in ref["replicas"][name]:
            assert port["replicas"][name][key] == ref["replicas"][name][key], (name, key)


def test_entry_point_two_replicas_on_one_store(tmp_path):
    """``python -m karpenter_tpu_torch store-server`` and two replicas of
    ``python -m karpenter_tpu_torch --store-address ... --leader-elect`` on
    the CPU, the lock sanitizer on from the settings file: both replicas
    run their ticks and exit 0, each tick's line says whether its replica
    led, a replica leads, and each replica leaves its lock witness with no
    finding."""
    import json
    import pathlib
    import socket
    import subprocess
    import sys
    import time

    repo = pathlib.Path(__file__).resolve().parent.parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch", "store-server", "--port", str(port)],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                assert time.monotonic() < deadline, "the store server never listened"
                time.sleep(0.1)
        procs = []
        for name in ("a", "b"):
            settings = tmp_path / f"{name}.json"
            settings.write_text(json.dumps({
                "cluster_name": "ha", "enable_lock_sanitizer": True,
                "lock_watchdog_stall_s": 30.0, "flight_dir": str(tmp_path / name)}))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "karpenter_tpu_torch", "--device", "cpu", "--ticks", "4",
                 "--interval", "0.6", "--pods", "20", "--settings-file", str(settings),
                 "--store-address", f"127.0.0.1:{port}", "--leader-elect"],
                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        server.terminate()
        server.wait(timeout=30)
    led = 0
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        lines = [json.loads(line) for line in out.splitlines()]
        assert [line["tick"] for line in lines] == [1, 2, 3, 4]
        led += sum(line["leading"] for line in lines)
    assert led >= 1
    for name in ("a", "b"):
        witness = json.loads((tmp_path / name / "witness.json").read_text())
        assert witness["findings"] == [] and witness["locks"]
