"""The host controllers the port copied from the JAX package, run as the
JAX package's own tests run them, on both packages.

``tests/test_consistency.py``'s cases and ``tests/test_controllers.py::
TestInterruption``'s, each parametrised over the two packages: the same
steps through each package's ``testing.Environment`` (the port's operator
on the CPU) and the same assertions.  The consistency checker and the
interruption controller are copies (``controllers/consistency.py``,
``controllers/interruption.py``); these runs show that the port's operator
registers them and that they act on the port's store, cluster state and
fake cloud as they do on the reference's.
"""

import importlib
from types import SimpleNamespace

import pytest

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")


@pytest.fixture(params=PACKAGES)
def s(request) -> SimpleNamespace:
    """One package's names, its Environment on the CPU."""
    pkg = request.param
    api = importlib.import_module(f"{pkg}.api")
    testing = importlib.import_module(f"{pkg}.testing")
    ns = SimpleNamespace(pkg=pkg, Pod=api.Pod, Resources=api.Resources, Settings=api.Settings)
    ns.L = importlib.import_module(f"{pkg}.api.labels")
    ns.Node = importlib.import_module(f"{pkg}.state.kube").Node
    ns.CHECK_PERIOD = importlib.import_module(f"{pkg}.controllers.consistency").CHECK_PERIOD
    ns.NOMINATION_TTL = importlib.import_module(f"{pkg}.state.cluster").NOMINATION_TTL
    ns.CloudAPIError = importlib.import_module(f"{pkg}.cloud.fake.backend").CloudAPIError
    kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    ns.Environment = lambda **k: testing.Environment(**k, **kw)
    return ns


# ---------------------------------------------------------------- consistency
def _provision(s, env, n=2):
    env.default_node_class()
    env.default_node_pool()
    pods = [s.Pod(requests=s.Resources(cpu=1, memory="2Gi")) for _ in range(n)]
    for p in pods:
        env.kube.put_pod(p)
    env.settle()
    assert not env.kube.pending_pods()
    return pods


def _run_checker(s, env):
    env.clock.step(s.CHECK_PERIOD + 1)
    env.operator.consistency.reconcile()


def _violations(env, check):
    return [e for e in env.kube.events
            if e[1] == "ConsistencyViolation" and e[3].startswith(check)]


def test_consistency_healthy_cluster_is_quiet(s):
    env = s.Environment()
    _provision(s, env)
    _run_checker(s, env)
    assert not _violations(env, "")
    assert env.registry.counter("karpenter_consistency_errors", {"check": "claim-instance"}) == 0


def test_consistency_claim_without_instance(s):
    env = s.Environment()
    _provision(s, env)
    claim = next(iter(env.kube.node_claims.values()))
    del env.cloud.instances[claim.provider_id]
    _run_checker(s, env)
    assert _violations(env, "claim-instance")
    assert env.registry.counter("karpenter_consistency_errors", {"check": "claim-instance"}) >= 1


def test_consistency_node_without_claim(s):
    env = s.Environment()
    _provision(s, env)
    env.kube.put_node(s.Node(name="rogue", provider_id="i-rogue", labels={}, taints=[],
                             allocatable=s.Resources(cpu=4), ready=True))
    _run_checker(s, env)
    assert _violations(env, "node-claim")


def test_consistency_capacity_lie(s):
    env = s.Environment()
    _provision(s, env)
    claim = next(iter(env.kube.node_claims.values()))
    node = env.kube.node_by_provider_id(claim.provider_id)
    node.allocatable = node.allocatable + s.Resources(cpu=1000)
    _run_checker(s, env)
    assert _violations(env, "capacity")


def test_consistency_pod_bound_to_missing_node(s):
    env = s.Environment()
    pods = _provision(s, env)
    env.kube.pods[pods[0].key()].node_name = "never-existed"
    _run_checker(s, env)
    assert _violations(env, "pod-binding")


def test_consistency_stale_nomination(s):
    env = s.Environment()
    _provision(s, env)
    ghost = s.Pod(requests=s.Resources(cpu=1))
    env.kube.put_pod(ghost)
    env.clock.step(s.CHECK_PERIOD + 1)
    env.cluster.nominate(ghost.key(), "missing-node")
    env.operator.consistency.reconcile()
    assert _violations(env, "nomination")


def test_consistency_nomination_expires(s):
    env = s.Environment()
    _provision(s, env)
    ghost = s.Pod(requests=s.Resources(cpu=1))
    env.kube.put_pod(ghost)
    env.cluster.nominate(ghost.key(), "some-node")
    assert env.cluster.nominated_node(ghost.key()) == "some-node"
    env.clock.step(s.NOMINATION_TTL + 1)
    assert env.cluster.nominated_node(ghost.key()) is None


def test_consistency_rate_limited(s):
    env = s.Environment()
    _provision(s, env)
    env.operator.consistency.reconcile()
    before = env.cloud.recorder.count("DescribeInstances")
    env.operator.consistency.reconcile()  # within CHECK_PERIOD: no-op
    assert env.cloud.recorder.count("DescribeInstances") == before


# --------------------------------------------------------------- interruption
def _interruption_env(s, pods: int = 0):
    env = s.Environment(settings=s.Settings(cluster_name="test", interruption_queue_name="q"))
    env.default_node_pool()
    env.default_node_class()
    for _ in range(pods):
        env.kube.put_pod(s.Pod(requests=s.Resources(cpu=1, memory="1Gi")))
    if pods:
        env.settle()
    return env


def test_interruption_spot_drains_and_marks_ice(s):
    env = _interruption_env(s, 3)
    claim = next(iter(env.kube.node_claims.values()))
    env.cloud.send_message({"kind": "spot_interruption", "instance_id": claim.provider_id})
    env.step(2.0)  # receive + drain + terminate
    env.settle()
    assert claim.name not in env.kube.node_claims
    assert env.unavailable.is_unavailable(s.L.CAPACITY_TYPE_SPOT, claim.instance_type_name,
                                          claim.zone)
    assert not env.kube.pending_pods()  # pods rescheduled


def test_interruption_rebalance_recommendation_drains(s):
    env = _interruption_env(s, 2)
    claim = next(iter(env.kube.node_claims.values()))
    env.cloud.send_message({"kind": "rebalance_recommendation", "instance_id": claim.provider_id})
    env.step(2.0)
    env.settle()
    assert claim.name not in env.kube.node_claims


def test_interruption_unknown_message_dropped(s):
    env = _interruption_env(s)
    env.cloud.send_message({"kind": "mystery"})
    env.step(1.0)
    assert not env.cloud.queue  # consumed + deleted


def test_interruption_full_batch_drained_in_one_pass(s):
    env = _interruption_env(s, 2)
    claims = list(env.kube.node_claims.values())
    for _ in range(10):
        env.cloud.send_message({"kind": "rebalance_recommendation",
                                "instance_id": claims[0].provider_id})
    before = env.cloud.recorder.count("ReceiveMessage")
    env.operator.interruption.reconcile()
    assert not env.cloud.queue
    assert env.cloud.recorder.count("ReceiveMessage") == before + 1
    assert env.registry.counter(
        "karpenter_nodeclaims_disrupted",
        {"reason": "rebalance_recommendation", "nodepool": "default"}) == 1


def test_interruption_failed_message_isolated_and_redelivered(s):
    env = _interruption_env(s, 2)
    claim = next(iter(env.kube.node_claims.values()))
    ic = env.operator.interruption
    poisoned = claim.provider_id
    orig = ic.termination.mark_for_deletion
    calls = {"fail": True}

    def flaky(c, reason=""):
        if calls["fail"] and c.provider_id == poisoned:
            raise RuntimeError("api throttled")
        return orig(c, reason=reason)

    ic.termination.mark_for_deletion = flaky
    env.cloud.send_message({"kind": "mystery"})  # drops cleanly
    env.cloud.send_message({"kind": "scheduled_change", "instance_id": poisoned})
    ic.reconcile()
    assert [m.body["kind"] for m in env.cloud.queue] == ["scheduled_change"]
    assert env.registry.counter("karpenter_interruption_message_errors") == 1
    calls["fail"] = False
    ic.reconcile()  # in flight until the visibility timeout elapses
    assert len(env.cloud.queue) == 1
    env.clock.step(env.cloud.visibility_timeout + 1)
    ic.reconcile()  # redelivery succeeds
    assert not env.cloud.queue
    assert claim.deleted_at is not None


def test_interruption_undeleted_message_redelivered_then_processed_exactly_once(s):
    env = _interruption_env(s, 2)
    claim = next(iter(env.kube.node_claims.values()))
    ic = env.operator.interruption
    env.cloud.send_message({"kind": "scheduled_change", "instance_id": claim.provider_id})
    retries = env.operator.retrying.max_retries
    env.cloud.recorder.set_error_sequence(
        "DeleteMessage", [s.CloudAPIError("InternalError")] * (retries + 1))
    ic.reconcile()
    assert claim.deleted_at is not None  # handled but NOT deleted
    assert len(env.cloud.queue) == 1
    assert env.registry.counter("karpenter_interruption_message_errors") == 1
    assert env.registry.counter("karpenter_interruption_deleted_messages") == 0
    ic.reconcile()  # in flight: an immediate poll must not see it
    received = {"message_type": "scheduled_change"}
    assert env.registry.counter("karpenter_interruption_received_messages", received) == 1
    env.clock.step(env.cloud.visibility_timeout + 1)
    ic.reconcile()  # past invisible_until it reappears, is re-processed once
    assert not env.cloud.queue
    assert env.registry.counter("karpenter_interruption_deleted_messages") == 1
    assert env.registry.counter("karpenter_interruption_received_messages", received) == 2
    ic.reconcile()  # after deletion: gone for good
    assert env.registry.counter("karpenter_interruption_received_messages", received) == 2
    assert env.registry.counter("karpenter_interruption_deleted_messages") == 1
