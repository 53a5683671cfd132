"""The port's admission fast path against the JAX package's.

Two halves:

- the score.  The JAX package's ``admit_kernel`` (jitted XLA, run here on
  the CPU) and the port's plain version ``ops/packer.py: admit_reference``
  get the same numpy inputs and must return the same [K+2] int32 vector,
  bit for bit: random arrays from a seed, ``testing.wrap_arrays`` (four
  slots of a class that requests no axis wrap the int32 prefix),
  ``testing.admit_edge_arrays`` (the admission kernel's edges), and every
  class row of a warm resident state of either package;
- the path.  Each case of ``tests/test_fastpath.py``'s ``TestAdmit``,
  ``TestEligibilityBoundary``, ``TestTickTrustWindow``,
  ``TestSingletonBypass`` and its twin test runs on both packages (the
  port's scheduler and operator on the CPU), keeps that file's assertions,
  and returns what it saw: outcomes, reasons, placements, claims and the
  fast-path counters.  The two packages must return the same.

The reference's ``test_single_pod_trickle_byte_identical`` needs the
simulator (ROADMAP A3b) and its doctor test the diagnosis layer (A3c): they
come with those items.
"""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import packer as JP
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.ops import packer as P

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
ZONES = ("zone-a", "zone-b", "zone-c")


# ---------------------------------------------------------------- the score
def _scores(args, g: int):
    """``(JAX admit_kernel, port admit_reference)`` on the same numpy
    ``(req, cnt, feas, alloc, openable, used0, cfg0)``, as numpy."""
    ref = np.asarray(JP.admit_kernel(*(jnp.asarray(a) for a in args), np.int32(g)))
    port = P.admit_reference(*(torch.from_numpy(np.array(a)) for a in args), g).numpy()
    return ref, port


def _assert_scores_equal(args, classes):
    K = args[5].shape[0]
    for g in classes:
        ref, port = _scores(args, g)
        assert port.dtype == np.int32 and port.shape == (K + 2,)
        assert np.array_equal(ref, port), (g, ref, port)


def random_admit_arrays(seed: int, G: int, C: int, K: int, R: int, live: int):
    """Admission inputs from ``seed``: live slots 0 .. ``live`` - 1 on
    random configs (cfg0 -1 past them), random usage below the alloc rows,
    classes that request some axes (some none), counts up to a few
    hundred, and random feasibility and openable bits."""
    rng = np.random.default_rng(seed)
    req = rng.choice([0.0, 0.25, 0.5, 1.0, 1.5, 3.0, 0.1], size=(G, R)).astype(np.float32)
    req[0] = 0.0  # a class that requests no axis: 2^30 room a slot
    cnt = rng.integers(0, 400, G).astype(np.int32)
    feas = rng.random((G, C)) < 0.7
    alloc = rng.choice([2.0, 4.0, 8.0, 16.0, 32.0, 110.0], size=(C, R)).astype(np.float32)
    openable = rng.random(C) < 0.5
    cfg0 = np.full(K, -1, np.int32)
    cfg0[:live] = rng.integers(0, C, live)
    used0 = np.zeros((K, R), np.float32)
    frac = rng.random((live, R)).astype(np.float32)
    used0[:live] = (alloc[cfg0[:live]] * frac).astype(np.float32)
    return req, cnt, feas, alloc, openable, used0, cfg0


@pytest.mark.parametrize("seed,G,C,K,R,live", [
    (0, 8, 16, 32, 3, 20),
    (1, 16, 300, 256, 6, 200),
    (2, 4, 64, 1024, 5, 1000),
    (3, 3, 8, 16, 1, 0),
    (4, 10, 2048, 4096, 6, 2000),
])
def test_admit_matches_jax_on_random_arrays(seed, G, C, K, R, live):
    _assert_scores_equal(random_admit_arrays(seed, G, C, K, R, live), range(G))


@pytest.mark.parametrize("k_slots,at", [(16, 0), (256, 0), (4096, 4096 // 2 - 2)])
def test_admit_matches_jax_on_wrapping_sums(k_slots, at):
    """`testing.wrap_arrays`: its classes 0-7 request no axis, so each of
    the four prefilled slots has 2^30 room and the int32 prefix wraps."""
    (req, cnt, _maxper, _slot, feas, alloc, _price, openable,
     used0, cfg0, _npods0, _next0, _sig0) = T.wrap_arrays(k_slots, at=at)
    args = (req, cnt, feas, alloc, openable, used0, cfg0)
    ref, _ = _scores(args, 0)
    assert ref[-2] != cnt[0] and ref[at + 3] == 2**30  # the sum did wrap
    _assert_scores_equal(args, range(req.shape[0]))


@pytest.mark.parametrize("case", list(T.ADMIT_EDGE_CASES))
def test_admit_matches_jax_on_edge_arrays(case):
    """`testing.admit_edge_arrays`: the admission kernel's edges (the last
    config the only fit, none fits, the nudge, alloc == q, Cp 300, K 1000 /
    16,384 / 0, classes that request no axis, the last class, R 10, Cp
    20,000), every class bit for bit."""
    args = T.admit_edge_arrays(case)
    _assert_scores_equal(args, range(args[0].shape[0]))


def test_admit_edge_arrays_hit_their_edges():
    """Each edge case shows what it is for in the plain version's result."""
    def score(case, g):
        a = T.admit_edge_arrays(case)
        return P.admit_reference(*(torch.from_numpy(np.array(x)) for x in a), g).numpy()

    for g in range(6):
        assert score("none-fits", g)[-1] == 0 and score("last-config", g)[-1] == 1
        assert score("many-configs", g)[-1] == 1 and score("nudge", g)[-1] == 1
    req, cnt, feas, alloc, openable, used0, cfg0 = T.admit_edge_arrays("nudge")
    fit = (alloc[:, 0] == np.float32(2.9999)) & openable
    assert fit.any() and np.floor(alloc[fit, 0] / req[0, 0]).max() == 0  # the nudge alone
    a = T.admit_edge_arrays("last-config")
    ok = a[2] & a[4][None, :] & (a[3][None, :, 0] >= a[0][:, None, 0])
    assert ok[:, :-1].sum() == 0 and ok[:, -1].all()
    assert score("last-class", 5)[-2] == 150 and score("last-class", 0)[-2] == 0
    wrapped = score("no-axis", 2)  # count 2^31 - 1 over slots of 2^30 room
    assert wrapped[:-2].max() == 2**30 and wrapped[-2] != 2**31 - 1  # the prefix wrapped
    assert T.admit_edge_arrays("unaligned")[3].shape[0] % 8 != 0
    assert T.admit_edge_arrays("k-0")[5].shape == (0, 3)


def test_admit_dispatch_picks_the_plain_version_for_cpu_tensors():
    """The dispatcher `admit_kernel` runs `admit_reference` for CPU
    tensors and launches nothing; the kernel's wrapper takes card tensors
    only."""
    from karpenter_tpu_torch.ops import fused_packer

    args = tuple(torch.from_numpy(np.array(a)) for a in random_admit_arrays(4, 6, 40, 64, 3, 50))
    fused_packer.reset_launches()
    for g in range(6):
        assert torch.equal(P.admit_kernel(*args, g), P.admit_reference(*args, g))
    assert fused_packer.LAUNCHES["admit_kernel"] == 0
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fused_packer.admit(*args, 0)


# ------------------------------------------------------------ the two sides
def _side(pkg: str) -> SimpleNamespace:
    api = importlib.import_module(f"{pkg}.api")
    objects = importlib.import_module(f"{pkg}.api.objects")
    testing = importlib.import_module(f"{pkg}.testing")
    s = SimpleNamespace(pkg=pkg)
    s.Pod, s.Resources, s.Settings = api.Pod, api.Resources, api.Settings
    s.L = importlib.import_module(f"{pkg}.api.labels")
    s.PodAffinityTerm = objects.PodAffinityTerm
    s.reset = objects.reset_name_sequences
    s.StateNode = importlib.import_module(f"{pkg}.state.cluster").StateNode
    s.fastpath = importlib.import_module(f"{pkg}.scheduling.fastpath")
    if pkg == "karpenter_tpu":
        from karpenter_tpu.scheduling import TensorScheduler

        s.Environment = testing.Environment
        s.Scheduler = TensorScheduler
    else:
        from karpenter_tpu_torch.scheduling import TorchScheduler

        s.Environment = lambda **kw: testing.Environment(device="cpu", **kw)
        s.Scheduler = lambda *a, **kw: TorchScheduler(*a, device="cpu", **kw)
    s.SIZE = s.Resources(cpu=0.25, memory="512Mi")
    return s


def _live_node(s, pool_name: str, i: int, pods=(), used=None):
    return s.StateNode(
        name=f"live-{i}",
        provider_id=f"fake://live-{i}",
        labels={s.L.LABEL_ZONE: ZONES[i % len(ZONES)], s.L.LABEL_NODEPOOL: pool_name},
        taints=[],
        allocatable=s.Resources(cpu=64, memory="256Gi", pods=110),
        pods=list(pods),
        used=used if used is not None else s.Resources(),
    )


def _warm_scheduler(s, n_nodes: int = 4, seed_pods: int = 4, sizes=None):
    """`tests/test_fastpath.py`'s resident-warm scheduler over live
    headroom, on side ``s`` (``sizes``: the seed pods' requests in turn)."""
    env = s.Environment()
    pool = env.default_node_pool()
    nc = env.default_node_class()
    types = env.instance_types.list(pool, nc)
    existing = [_live_node(s, pool.name, i) for i in range(n_nodes)]
    ts = s.Scheduler([pool], {pool.name: types}, existing=existing)
    sizes = sizes or [s.SIZE]
    ts.solve([s.Pod(name=f"seed-{i}", requests=sizes[i % len(sizes)])
              for i in range(seed_pods)])
    assert ts._resident.states, "seed solve must warm the resident plane"
    return ts


def _seen(res) -> tuple:
    return (res.outcome, res.reason, sorted(res.placements.items()))


def _fallback(s, res, reason) -> tuple:
    assert res.outcome == "fallback", (res.outcome, res.reason)
    assert res.reason == reason
    assert res.placements == {}
    return _seen(res)


def _carrier(s):
    return s.Pod(name="bound-carrier", requests=s.SIZE,
                 pod_affinity=[s.PodAffinityTerm(topology_key="kubernetes.io/hostname")])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_admit_matches_jax_on_every_class_of_a_warm_state(pkg):
    """Every class row (the padding rows too) of a warm resident state of
    ``pkg``'s scheduler, over live nodes with some usage: the JAX kernel and
    the port's plain version on the state's own tensors."""
    s = _side(pkg)
    R = s.Resources
    sizes = [R(cpu=0.25, memory="512Mi"), R(cpu=1, memory="2Gi"), R(cpu=3, memory="1Gi"),
             R(cpu=0.5, memory="8Gi")]
    ts = _warm_scheduler(s, n_nodes=6, seed_pods=8, sizes=sizes)
    st = ts._resident.states[0]
    host = (lambda t: t.numpy()) if pkg == "karpenter_tpu_torch" else np.asarray
    args = tuple(host(t) for t in (st.d_req, st.d_cnt, st.d_feas, st.d_alloc,
                                   st.d_openable, st.d_used0, st.d_cfg0))
    assert len(st.slot_of) == len(sizes)
    _assert_scores_equal(args, range(args[0].shape[0]))


# --------------------------------------------------- the reference's cases
def admit_single_fresh_pod(s):
    ts = _warm_scheduler(s)
    pod = s.Pod(name="arrival-1", requests=s.SIZE)
    res = s.fastpath.try_admit(ts, [pod])
    assert res.outcome == "nominated", (res.outcome, res.reason)
    assert set(res.placements) == {pod.key()}
    assert res.placements[pod.key()].startswith("live-")
    return _seen(res)


def admit_full_solve_agrees(s):
    ts = _warm_scheduler(s)
    pod = s.Pod(name="arrival-2", requests=s.SIZE)
    res = s.fastpath.try_admit(ts, [pod])
    assert res.outcome == "nominated", (res.outcome, res.reason)
    result = ts.solve([pod])
    assert not result.new_nodes
    assert result.existing_placements[pod.key()] == res.placements[pod.key()]
    return _seen(res), sorted(result.existing_placements.items())


def admit_tiny_burst(s):
    ts = _warm_scheduler(s)
    pods = [s.Pod(name=f"burst-{i}", requests=s.SIZE)
            for i in range(s.fastpath.FASTPATH_MAX_BURST)]
    res = s.fastpath.try_admit(ts, pods)
    assert res.outcome == "nominated", (res.outcome, res.reason)
    assert set(res.placements) == {p.key() for p in pods}
    result = ts.solve(pods)
    assert not result.new_nodes
    assert result.existing_placements == res.placements
    return _seen(res)


def boundary_burst_too_large(s):
    ts = _warm_scheduler(s)
    pods = [s.Pod(name=f"big-{i}", requests=s.SIZE)
            for i in range(s.fastpath.FASTPATH_MAX_BURST + 1)]
    return _fallback(s, s.fastpath.try_admit(ts, pods), s.fastpath.REASON_BURST_TOO_LARGE)


def boundary_mixed_class_burst(s):
    ts = _warm_scheduler(s)
    pods = [s.Pod(name="mix-a", requests=s.SIZE),
            s.Pod(name="mix-b", requests=s.Resources(cpu=2, memory="4Gi"))]
    return _fallback(s, s.fastpath.try_admit(ts, pods), s.fastpath.REASON_MIXED_BURST)


def boundary_constrained_pod_shape(s):
    ts = _warm_scheduler(s)
    pod = s.Pod(name="affine", requests=s.SIZE,
                pod_affinity=[s.PodAffinityTerm(topology_key="kubernetes.io/hostname")])
    return _fallback(s, s.fastpath.try_admit(ts, [pod]), s.fastpath.REASON_POD_SHAPE)


def boundary_affinity_carrier(s):
    ts = _warm_scheduler(s)
    ts.existing.append(_live_node(s, "default", 99, pods=[_carrier(s)]))
    res = s.fastpath.try_admit(ts, [s.Pod(name="a-3", requests=s.SIZE)])
    return _fallback(s, res, s.fastpath.REASON_AFFINITY_CARRIER)


def boundary_catalog_roll(s):
    ts = _warm_scheduler(s)
    # a pool mutation bumps the epoch half of the catalog key
    ts.pools[0].__dict__["_mut"] = ts.pools[0].__dict__.get("_mut", 0) + 1
    res = s.fastpath.try_admit(ts, [s.Pod(name="a-4", requests=s.SIZE)])
    return _fallback(s, res, s.fastpath.REASON_CATALOG_ROLL)


def boundary_resident_cold(s):
    env = s.Environment()
    pool = env.default_node_pool()
    nc = env.default_node_class()
    types = env.instance_types.list(pool, nc)
    ts = s.Scheduler([pool], {pool.name: types}, existing=[_live_node(s, pool.name, 0)])
    res = s.fastpath.try_admit(ts, [s.Pod(name="a-5", requests=s.SIZE)])
    return _fallback(s, res, s.fastpath.REASON_RESIDENT_COLD)


def boundary_needs_new_node(s):
    ts = _warm_scheduler(s)
    res = s.fastpath.try_admit(
        ts, [s.Pod(name="huge", requests=s.Resources(cpu=65, memory="1Gi"))])
    assert res.outcome == "fallback", res.outcome
    assert res.reason in (s.fastpath.REASON_NEEDS_NEW_NODE, s.fastpath.REASON_RESIDENT_MISS)
    assert res.placements == {}
    return _seen(res)


def boundary_fuzz_never_mis_nominates(s):
    ts = _warm_scheduler(s)
    R = s.Resources
    cases = [
        [s.Pod(name="f-0", requests=s.SIZE)],
        [s.Pod(name="f-1", requests=s.SIZE), s.Pod(name="f-2", requests=R(cpu=1, memory="1Gi"))],
        [s.Pod(name="f-3", requests=s.SIZE,
               pod_affinity=[s.PodAffinityTerm(topology_key="zone")])],
        [s.Pod(name=f"f-4-{i}", requests=s.SIZE) for i in range(12)],
        [s.Pod(name="f-5", requests=R(cpu=4096))],
        [s.Pod(name="f-6", requests=R(cpu=0.25, memory="512Mi"))],
    ]
    seen = []
    for pods in cases:
        res = s.fastpath.try_admit(ts, pods)
        assert res.outcome != "mismatch", res.reason
        seen.append(_seen(res))
        if res.outcome != "nominated":
            assert res.placements == {}
            continue
        result = ts.solve(pods)
        assert result.existing_placements == res.placements
    return seen


def window_no_window_detects_inplace_carrier(s):
    ts = _warm_scheduler(s)
    ts.existing[0].pods.append(_carrier(s))
    res = s.fastpath.try_admit(ts, [s.Pod(name="tw-1", requests=s.SIZE)])
    return _fallback(s, res, s.fastpath.REASON_AFFINITY_CARRIER)


def window_trusts_cached_invariants(s):
    ts = _warm_scheduler(s)
    ts._resident.note_sync(ts)
    ts.existing[0].pods.append(_carrier(s))
    res = s.fastpath.try_admit(ts, [s.Pod(name="tw-2", requests=s.SIZE)])
    assert res.outcome == "nominated", (res.outcome, res.reason)
    ts._resident.note_sync(ts)
    res2 = s.fastpath.try_admit(ts, [s.Pod(name="tw-3", requests=s.SIZE)])
    return _seen(res), _fallback(s, res2, s.fastpath.REASON_AFFINITY_CARRIER)


def window_witness_invalidates_on_node_set_change(s):
    ts = _warm_scheduler(s)
    ts._resident.note_sync(ts)
    ts.existing.append(_live_node(s, "default", 99, pods=[_carrier(s)]))
    res = s.fastpath.try_admit(ts, [s.Pod(name="tw-4", requests=s.SIZE)])
    return _fallback(s, res, s.fastpath.REASON_AFFINITY_CARRIER)


def window_admissions_match_windowless(s):
    ts_a, ts_b = _warm_scheduler(s), _warm_scheduler(s)
    ts_a._resident.note_sync(ts_a)
    seen = []
    for i in range(4):
        ra = s.fastpath.try_admit(ts_a, [s.Pod(name=f"tw-p{i}", requests=s.SIZE)])
        rb = s.fastpath.try_admit(ts_b, [s.Pod(name=f"tw-p{i}", requests=s.SIZE)])
        assert ra.outcome == rb.outcome == "nominated"
        assert list(ra.placements.values()) == list(rb.placements.values())
        seen.append(_seen(ra))
    return seen


def _bypass_env(s, bypass: bool):
    env = s.Environment(settings=s.Settings(cluster_name="test", enable_admission_fastpath=False,
                                            provision_fastpath_bypass=bypass))
    env.default_node_class()
    env.default_node_pool()
    return env


def bypass_lone_pod_skips_the_batch_window(s):
    env = _bypass_env(s, bypass=True)
    env.kube.put_pod(s.Pod(name="lone", requests=s.SIZE))
    env.step(0.1)  # far inside the idle window
    assert env.kube.node_claims
    return sorted(c.instance_type_name for c in env.kube.node_claims.values())


def bypass_off_waits_for_idle(s):
    env = _bypass_env(s, bypass=False)
    env.kube.put_pod(s.Pod(name="lone", requests=s.SIZE))
    env.step(0.1)
    assert not env.kube.node_claims
    env.step(1.1)  # idle elapsed -> the batched solve runs
    assert env.kube.node_claims
    return sorted(c.instance_type_name for c in env.kube.node_claims.values())


def bypass_only_fires_for_singletons(s):
    env = _bypass_env(s, bypass=True)
    for i in range(2):
        env.kube.put_pod(s.Pod(name=f"pair-{i}", requests=s.SIZE))
    env.step(0.1)
    assert not env.kube.node_claims  # two pods: the window coalesces
    return len(env.kube.node_claims)


def _run_cluster(s, fastpath_on: bool):
    """The reference's twin drive: a seed batch, then a single-pod
    trickle.  Returns (env, pod -> node)."""
    s.reset()
    env = s.Environment(settings=s.Settings(cluster_name="test",
                                            enable_admission_fastpath=fastpath_on,
                                            provision_fastpath_bypass=fastpath_on))
    env.default_node_class()
    env.default_node_pool()
    for i in range(12):
        env.kube.put_pod(s.Pod(name=f"seed-{i:02d}", requests=s.Resources(cpu=2.5, memory="2Gi")))
    env.settle()
    assert not env.kube.pending_pods()
    for i in range(6):
        env.kube.put_pod(s.Pod(name=f"trickle-{i}", requests=s.Resources(cpu=0.1, memory="64Mi")))
        env.step(2.0)
    env.settle()
    assert not env.kube.pending_pods()
    return env, {k: p.node_name for k, p in sorted(env.kube.pods.items())}


def _fastpath_counters(reg) -> dict:
    return {name: sorted(reg.counters.get(name, {}).items()) for name in (
        "karpenter_admission_fastpath_total",
        "karpenter_admission_fastpath_fallback_total",
        "karpenter_admission_fastpath_mismatch_total")}


def twin_fast_on_off_identical_eventual_placements(s):
    env_fast, placed_fast = _run_cluster(s, fastpath_on=True)
    env_slow, placed_slow = _run_cluster(s, fastpath_on=False)
    assert placed_fast == placed_slow
    reg = env_fast.registry
    assert reg.counter("karpenter_admission_fastpath_total", {"outcome": "nominated"}) > 0
    assert reg.counter("karpenter_admission_fastpath_mismatch_total") == 0
    assert reg.histogram("karpenter_admission_latency_seconds", {"path": "fast"})
    slow_reg = env_slow.registry
    for outcome in ("nominated", "fallback", "mismatch"):
        assert slow_reg.counter("karpenter_admission_fastpath_total", {"outcome": outcome}) == 0
    assert not slow_reg.histogram("karpenter_admission_latency_seconds", {"path": "fast"})
    assert slow_reg.histogram("karpenter_admission_latency_seconds", {"path": "batch"})
    return placed_fast, _fastpath_counters(reg), _fastpath_counters(slow_reg)


CASES = {f.__name__: f for f in (
    admit_single_fresh_pod, admit_full_solve_agrees, admit_tiny_burst,
    boundary_burst_too_large, boundary_mixed_class_burst, boundary_constrained_pod_shape,
    boundary_affinity_carrier, boundary_catalog_roll, boundary_resident_cold,
    boundary_needs_new_node, boundary_fuzz_never_mis_nominates,
    window_no_window_detects_inplace_carrier, window_trusts_cached_invariants,
    window_witness_invalidates_on_node_set_change, window_admissions_match_windowless,
    bypass_lone_pod_skips_the_batch_window, bypass_off_waits_for_idle,
    bypass_only_fires_for_singletons, twin_fast_on_off_identical_eventual_placements,
)}


@pytest.mark.parametrize("case", list(CASES))
def test_fastpath_case_alike(case):
    ref, port = (CASES[case](_side(pkg)) for pkg in PACKAGES)
    assert port == ref
