"""The port's pipelined reconcile against the JAX package's: the twins of
the disruption-facing tests of ``tests/test_pipeline.py``.

Under ``enable_pipelined_reconcile`` the port's operator brackets the tick
with the disruption controller's speculative stages, as the reference's
does: ``reconcile_dispatch`` enqueues the next pass's round-0 population
scoring at the tick's end, ``reconcile_advance`` joins it at the next
tick's start, and the pass adopts it only on a fingerprint match.  Each
test runs the reference test's seeded scenario through both packages (the
JAX package on the CPU, the port with ``device="cpu"``) and holds the
operator states (`torch_twins.state`), the speculation's outcomes and the
search's proposals and pick equal; the port's side then meets the
reference test's own assertions.  The reference's simulator tests
(``test_sim_runner_forces_pipeline_off``,
``test_diurnal_interruption_storm_byte_identical``) wait for the port of
the simulator (ROADMAP A3b).
"""

import random

import pytest

from torch_twins import PACKAGES, Twin, assert_equal_states, fx, ranked_candidates, state, tick_digest, twins


def _spec_counts(env) -> dict:
    got = env.registry.counters.get("karpenter_pipeline_speculation_total", {})
    return {dict(k)["outcome"]: v for k, v in got.items()}


def _mismatches(env) -> float:
    return env.registry.counter("karpenter_consolidation_verdict_mismatch_total")


def _scale_down(t: Twin, pipelined: bool):
    """``test_pipelined_vs_sequential_twin_actions``' drive on one package."""
    env = t.build_env(7, 110, enable_pipelined_reconcile=pipelined)
    dc = env.operator.disruption
    dc.search_rounds = 2
    dc.search_population = 16
    rng = random.Random(99)
    keys = sorted(env.kube.pods.keys())
    for key in rng.sample(keys, len(keys) * 3 // 5):
        env.kube.delete_pod(key)
    digests, states = [], []
    for _ in range(12):
        env.clock.step(65)
        env.step(2.0)
        digests.append(tick_digest(env, dc))
        states.append(state(env))
    return env, digests, states


def test_pipelined_vs_sequential_twin_actions():
    """The port's pipelined operator takes the JAX package's pipelined
    actions tick for tick, with the same whole state and the same
    speculation outcomes, and the port's sequential operator takes the
    same actions; the pipelined port adopts speculations, the sequential
    one never speculates, and no verdict mismatches."""
    ref, _ref_digests, ref_states = _scale_down(Twin(PACKAGES[0]), True)
    port = Twin(PACKAGES[1])
    env, digests, states = _scale_down(port, True)
    assert_equal_states(ref_states, states)
    assert _spec_counts(env) == _spec_counts(ref)
    assert _spec_counts(env).get("adopted", 0) > 0, _spec_counts(env)
    seq, seq_digests, _ = _scale_down(port, False)
    assert seq_digests == digests
    assert not _spec_counts(seq)
    assert _mismatches(env) == _mismatches(seq) == 0


def _quiet(t: Twin):
    env = t.build_env(3, 30)
    assert env.operator.pipeline.enabled  # the production default
    states = []
    for _ in range(10):
        env.clock.step(10)
        env.step(1.0)
        states.append(state(env))
    hists = env.registry.histograms.get("karpenter_reconcile_overlap_seconds", {})
    return _spec_counts(env), sum(h.count for h in hists.values()), states


def test_quiet_cluster_adopts_every_tick():
    """A quiet cluster: in both packages the speculation dispatched at each
    tick's end is adopted at the next tick's slot, with equal counts, and
    the overlap histogram records one sample an adoption."""
    (ref_counts, ref_overlaps, ref_states), (counts, overlaps, states) = (
        _quiet(t) for t in twins())
    assert_equal_states(ref_states, states)
    assert counts == ref_counts and overlaps == ref_overlaps
    assert counts.get("adopted", 0) >= 8, counts
    assert overlaps == counts["adopted"]


def _discard(t: Twin):
    env = t.build_env(4, 40)
    env.clock.step(10)
    env.step(1.0)
    in_flight = env.operator.disruption._speculation is not None
    bound = [p for p in env.kube.pods.values() if p.node_name]
    env.kube.delete_pod(bound[0].key())
    env.clock.step(10)
    env.step(1.0)
    return in_flight, _spec_counts(env), _mismatches(env), state(env)


def test_state_change_discards_speculation():
    """A pod deleted between dispatch and join: in both packages the
    speculation is discarded as stale and the pass recomputes, with equal
    outcomes and states and no mismatch."""
    ref, port = (_discard(t) for t in twins())
    assert ref[:3] == port[:3]
    assert_equal_states([ref[3]], [port[3]])
    in_flight, counts, mismatches, _st = port
    assert in_flight and counts.get("stale", 0) >= 1 and mismatches == 0


def _sequential(t: Twin):
    env = t.build_env(5, 30, enable_pipelined_reconcile=False)
    states = []
    for _ in range(5):
        env.clock.step(10)
        env.step(1.0)
        states.append(state(env))
    return _spec_counts(env), env.operator.disruption._speculation is None, states


def test_sequential_mode_never_speculates():
    """With the pipelined schedule off neither package speculates, and the
    two operators agree tick for tick."""
    ref, port = (_sequential(t) for t in twins())
    assert_equal_states(ref[2], port[2])
    assert port[:2] == ref[:2] == ({}, True)


def test_search_plan_admits_warm_masks():
    """Warm keys ride round 0 after the structured seeds in both packages;
    out-of-range and too-small keys are dropped."""
    got = []
    for t in twins():
        plan = t.popsearch.SearchPlan(
            n=4, prices=[1.0] * 4, spot=[False] * 4, population=64, rounds=1,
            seed=1, warm=[(1, 3), (0, 9), (2,)],
        )
        keys = plan.propose()
        assert (1, 3) in keys and plan.warm == [(1, 3)], t.pkg
        got.append(keys)
    assert got[0] == got[1]


def _plan(plan) -> tuple:
    best = plan.best()
    return (
        sorted(plan.seen),
        sorted((k, v[0], fx(v[1])) for k, v in plan.results.items()),
        None if best is None else (best.indices, fx(best.price)),
        plan.survivors(),
    )


def _warm_start(t: Twin):
    env = t.build_env(6, 90)
    dc = env.operator.disruption
    dc.search_rounds = 2
    dc.search_population = 16
    rng = random.Random(17)
    keys = sorted(env.kube.pods.keys())
    for key in rng.sample(keys, len(keys) // 2):
        env.kube.delete_pod(key)
    cands = ranked_candidates(dc)
    inv = dc._pool_inventory()
    dc._warm_store = None
    dc._search_seq = 0
    ev = t.disruption._RemovalEvaluator
    cold = dc._search_multi(cands, ev(dc, cands, inv))
    ufp, survivors = dc._warm_store
    same_fp = ufp == dc._universe_fingerprint(cands)
    warm_masks = dc._warm_masks(cands)
    warm = dc._search_multi(cands, ev(dc, cands, inv))
    dc._warm_store = (("bogus",), survivors)
    gated = dc._warm_masks(cands)
    return len(cands), _plan(cold), _plan(warm), survivors, same_fp, warm_masks, gated, cold, warm


def test_warm_start_parity_and_fingerprint_gate():
    """The cross-pass warm start in both packages: the cold and the
    warm-started pass propose, score and pick alike, the warm pass proposes
    the cold pass's survivors, every winner meets the acceptability rules,
    and a changed universe fingerprint yields no warm masks."""
    ref, port = (_warm_start(t) for t in twins())
    assert ref[:7] == port[:7]
    n, _cold, _warm, survivors, same_fp, warm_masks, gated, cold, warm = port
    assert n >= 2 and same_fp and warm_masks == survivors and gated == []
    if survivors:
        assert all(k in warm.seen for k in survivors)
    for plan in (cold, warm):
        best = plan.best()
        if best is not None:
            fits, price = plan.results[best.indices]
            assert plan.acceptable(best.indices, fits, price)
            assert cold.acceptable(best.indices, fits, price)


@pytest.mark.parametrize("enabled", [True, False])
def test_operator_declares_the_disruption_stages(enabled):
    """The port's operator registers disruption between the event
    controllers and termination, as the reference's does, with its
    dispatch and advance hooks on its stage; the schedule follows
    ``enable_pipelined_reconcile``."""
    orders = []
    for t in twins():
        env = t.env(settings=t.api.Settings(cluster_name="t", interruption_queue_name="q",
                                            enable_pipelined_reconcile=enabled))
        pipe = env.operator.pipeline
        orders.append([s.name for s in pipe.specs])
        assert pipe.enabled is enabled
        staged = [s.name for s in pipe.specs if s.dispatch or s.advance]
        assert staged == ["disruption"], (t.pkg, staged)
        dc = env.operator.disruption
        (spec,) = [s for s in pipe.specs if s.name == "disruption"]
        assert spec.controller is dc
        assert spec.dispatch == dc.reconcile_dispatch and spec.advance == dc.reconcile_advance
    assert orders[0] == orders[1]
    assert orders[1].index("interruption") + 1 == orders[1].index("disruption")
    assert orders[1].index("disruption") + 1 == orders[1].index("termination")
