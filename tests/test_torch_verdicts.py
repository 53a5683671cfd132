"""The consolidation verdicts of the port against the JAX package, on the CPU.

One seeded live cluster (nodes holding bound pods, every node a removal
candidate) is built in both packages through ``tests/torch_specs.py``: three
seeds of 20-36 nodes (2 and 4 vCPU, each holding 1-6 pods), plus a
snapshot whose bound pods have two sizes of one
FFD sort key, so each subset's class order follows the first occurrence of
its classes.  For each snapshot and objective:

- the raw [B, 6] verdict rows: the inputs JAX's ``run_removal_verdicts`` and
  ``dispatch_population_verdicts`` received from ``TensorScheduler`` are fed
  to the port's ``run_removal_verdicts`` / ``run_population_verdicts`` on the
  CPU (the plain versions), and the rows must be bit-equal (float32 bit
  patterns); the port's solver must have built the same inputs;
- the decoded ``RemovalVerdict`` lists of ``evaluate_removals`` (singles,
  prefixes, drop-ones) and ``evaluate_population`` (a seeded population over
  the first ten candidates) must be equal;
- a mask scored by the population path equals the same subset scored per
  element.

The guards (an empty universe, each ``removal_search_guard`` reason, a
``pop_reason``) must resolve without any launch.  Tolerance: none.
"""

import random

import numpy as np
import pytest
import torch

import torch_specs as S
from karpenter_tpu.ops import packer as JP
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.ops import packer as P
from karpenter_tpu_torch.scheduling import solver as port_solver

# snapshot -> (seed, nodes, mixed sizes)
SNAPSHOTS = {
    "seed0": (0, 24, False),
    "seed1": (1, 36, False),
    "seed2": (2, 20, False),
    "mixed": (3, 28, True),
}
OBJECTIVES = ("nodes", "cost")
POP_UNIVERSE = 10  # the population's capped universe prefix


def _host(a):
    """A captured JAX or torch argument as numpy (scalars as ints)."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a = np.asarray(a)
    return int(a) if a.ndim == 0 else a


def _subsets(cands):
    n = len(cands)
    keys = [(i,) for i in range(n)]
    keys += [tuple(range(k)) for k in range(2, min(n, 14) + 1)]
    keys += [tuple(j for j in range(12) if j != i) for i in range(12)]
    return keys


def _population_keys(seed):
    rng = random.Random(seed)
    keys = [(i,) for i in range(POP_UNIVERSE)]
    full = tuple(range(POP_UNIVERSE))
    keys += [full[:i] + full[i + 1:] for i in range(POP_UNIVERSE)] + [full]
    keys += [tuple(sorted(rng.sample(range(POP_UNIVERSE), rng.randint(2, POP_UNIVERSE))))
             for _ in range(30)]
    return list(dict.fromkeys(keys))


def _masks(keys, width):
    m = np.zeros((len(keys), width), bool)
    for r, k in enumerate(keys):
        m[r, list(k)] = True
    return m


class _Capture:
    """Records the arguments and the rows of each verdict dispatch."""

    def __init__(self):
        self.removal, self.population = [], []

    def removal_hook(self, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            self.removal.append((tuple(_host_args(a) for a in args), kw, np.asarray(out)))
            return out
        return run

    def population_hooks(self, dispatch, fetch):
        def run_dispatch(*args, **kw):
            self.population.append([tuple(_host_args(a) for a in args), kw, None])
            return dispatch(*args, **kw)

        def run_fetch(out, name):
            rows = fetch(out, name)
            if name.startswith("population"):  # the removal path fetches too
                self.population[-1][2] = np.asarray(rows)
            return rows
        return run_dispatch, run_fetch


def _host_args(a):
    return tuple(_host(x) for x in a) if isinstance(a, tuple) else _host(a)


_RUNS = {}


def _run(snapshot, objective):
    """Both packages' solvers over one snapshot, driven through the same
    calls, with every verdict dispatch captured (computed once a module)."""
    key = (snapshot, objective)
    if key in _RUNS:
        return _RUNS[key]
    seed, nodes, mixed = SNAPSHOTS[snapshot]
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg in ("karpenter_tpu", "karpenter_tpu_torch"):
            s = S.side(pkg)
            pools, inv, existing, cands = S.consolidation(s, seed, nodes, mixed)
            sched = s.scheduler(pools, inv, existing=existing, objective=objective)
            cap = _Capture()
            if pkg == "karpenter_tpu":
                mp.setattr(JP, "run_removal_verdicts", cap.removal_hook(JP.run_removal_verdicts))
                d, f = cap.population_hooks(JP.dispatch_population_verdicts,
                                            JP.fetch_verdict_rows)
                mp.setattr(JP, "dispatch_population_verdicts", d)
                mp.setattr(JP, "fetch_verdict_rows", f)
            else:
                mp.setattr(port_solver, "run_removal_verdicts",
                           cap.removal_hook(port_solver.run_removal_verdicts))
                d, f = cap.population_hooks(port_solver.dispatch_population_verdicts,
                                            port_solver.fetch_verdict_rows)
                mp.setattr(port_solver, "dispatch_population_verdicts", d)
                mp.setattr(port_solver, "fetch_verdict_rows", f)
            keys = _subsets(cands)
            removals = sched.evaluate_removals([[cands[i] for i in k] for k in keys], cands)
            universe = cands[:POP_UNIVERSE]
            pkeys = _population_keys(seed)
            population = sched.evaluate_population(_masks(pkeys, POP_UNIVERSE), universe)
            out[pkg] = dict(
                sched=sched, cands=cands, existing=existing, keys=keys, pkeys=pkeys,
                removals=[tuple(v) for v in removals],
                population=[tuple(v) for v in population], cap=cap,
            )
    finally:
        mp.undo()
    _RUNS[key] = out
    return out


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_clusters_agree_and_match_the_port_builder():
    """The spec builds the same cluster in both packages, and the port's
    own builder (testing.consolidation_cluster) builds it too."""
    for snapshot, (seed, nodes, mixed) in SNAPSHOTS.items():
        jx = S.consolidation(S.side("karpenter_tpu"), seed, nodes, mixed)
        pt = S.consolidation(S.side("karpenter_tpu_torch"), seed, nodes, mixed)
        assert S.node_content(jx[2]) == S.node_content(pt[2]), snapshot
        assert [c.node_name for c in jx[3]] == [c.node_name for c in pt[3]]
        types = S.consolidation_types(pt[1])
        existing, cands = T.consolidation_cluster(
            seed, nodes, types, per_node=(2, 6),
            sizes=S.consolidation_sizes(S.side("karpenter_tpu_torch"), mixed))
        assert S.node_content(existing) == S.node_content(pt[2]), snapshot
        assert [c.node_name for c in cands] == [c.node_name for c in pt[3]]


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("snapshot", list(SNAPSHOTS))
def test_removal_rows_bit_equal(snapshot, objective):
    """The port's plain removal verdicts on the inputs JAX's
    run_removal_verdicts received give its rows bit for bit; the port's
    solver built the same inputs and got the same rows."""
    run = _run(snapshot, objective)
    (jargs, jkw, jrows), = run["karpenter_tpu"]["cap"].removal
    (pargs, pkw, prows), = run["karpenter_tpu_torch"]["cap"].removal
    padded = P.to_device(jargs[0], torch.device("cpu"))
    rows = P.run_removal_verdicts(padded, *jargs[1:], **jkw)
    np.testing.assert_array_equal(_bits(rows), _bits(jrows))
    assert pkw == jkw
    for got, want in zip(pargs[0] + pargs[1:], jargs[0] + jargs[1:]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_bits(prows), _bits(jrows))
    # the population below keeps at least one multi-node subset per pass
    assert jrows.shape[1] == P.RV_WIDTH


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("snapshot", list(SNAPSHOTS))
def test_population_rows_bit_equal(snapshot, objective):
    run = _run(snapshot, objective)
    (jargs, jkw, jrows), = run["karpenter_tpu"]["cap"].population
    (pargs, pkw, prows), = run["karpenter_tpu_torch"]["cap"].population
    padded = P.to_device(jargs[0], torch.device("cpu"))
    rows = P.run_population_verdicts(padded, *jargs[1:], **jkw)
    np.testing.assert_array_equal(_bits(rows), _bits(jrows))
    assert pkw == jkw
    for got, want in zip(pargs[0] + pargs[1:], jargs[0] + jargs[1:]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_bits(prows), _bits(jrows))


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("snapshot", list(SNAPSHOTS))
def test_decoded_verdicts_equal(snapshot, objective):
    run = _run(snapshot, objective)
    jx, pt = run["karpenter_tpu"], run["karpenter_tpu_torch"]
    assert pt["removals"] == jx["removals"]
    assert pt["population"] == jx["population"]
    assert pt["sched"].last_removal_batch == jx["sched"].last_removal_batch
    # the snapshot decides more than one kind of answer
    assert len({v[:2] for v in pt["removals"]}) >= 2


@pytest.mark.parametrize("snapshot", list(SNAPSHOTS))
def test_population_equals_per_element(snapshot):
    """A mask scored by the population path decodes to the same verdict as
    the same subset scored per element, over the same universe."""
    run = _run(snapshot, "nodes")["karpenter_tpu_torch"]
    sched, cands = run["sched"], run["cands"]
    universe = cands[:POP_UNIVERSE]
    per_element = sched.evaluate_removals(
        [[universe[i] for i in k] for k in run["pkeys"]], universe)
    assert [tuple(v) for v in per_element] == run["population"]


def _refuse(mp):
    """Make every verdict launch of the port raise."""
    def boom(*a, **k):
        raise AssertionError("a verdict launch ran")
    mp.setattr(port_solver, "run_removal_verdicts", boom)
    mp.setattr(port_solver, "dispatch_population_verdicts", boom)


def _both(mutate=None, seed=0, nodes=12):
    """Both packages' schedulers over one small snapshot; ``mutate(s,
    existing, cands)`` edits each side's snapshot first."""
    out = []
    for pkg in ("karpenter_tpu", "karpenter_tpu_torch"):
        s = S.side(pkg)
        pools, inv, existing, cands = S.consolidation(s, seed, nodes)
        if mutate is not None:
            cands = mutate(s, existing, cands)
        out.append((s.scheduler(pools, inv, existing=existing), existing, cands))
    return out


def _pod_edit(edit):
    def mutate(s, existing, cands):
        edit(s, cands[0].pods[0])
        return cands
    return mutate


def _live_carrier(s, existing, cands):
    name = cands[0].node_name
    sn = next(n for n in existing if n.name == name)
    sn.pods = sn.pods + [s.Pod(
        name="carrier", labels={"app": "a"}, requests=s.Resources(cpu=0.1),
        node_name=name, phase="Running",
        pod_affinity=[s.PodAffinityTerm(topology_key=s.L.LABEL_HOSTNAME,
                                         label_selector=(("app", "a"),), anti=True)],
    )]
    return cands


GUARDS = {
    "constraint-shape": _pod_edit(lambda s, p: setattr(p, "topology_spread", [
        s.TopologySpreadConstraint(max_skew=1, topology_key=s.L.LABEL_ZONE,
                                   label_selector=(("app", "x"),))])),
    "volume-claims": _pod_edit(lambda s, p: setattr(p, "volume_claims", ["claim-0"])),
    "live-carrier-on-candidate": _live_carrier,
}


@pytest.mark.parametrize("reason", list(GUARDS))
def test_guards_resolve_without_a_launch(reason, monkeypatch):
    (jsched, jex, jc), (psched, pex, pc) = _both(GUARDS[reason])
    assert psched.removal_search_guard(pc, pex) == reason
    assert jsched.removal_search_guard(jc, jex) == reason
    _refuse(monkeypatch)
    subsets = [[c] for c in pc[:4]]
    got = psched.evaluate_removals(subsets, pc)
    want = jsched.evaluate_removals([[c] for c in jc[:4]], jc)
    assert [tuple(v) for v in got] == [tuple(v) for v in want]
    assert all(v.needs_host and v.reason == reason for v in got)
    masks = _masks([(0, 1), (2,)], 3)
    got = psched.evaluate_population(masks, pc[:3])
    assert [tuple(v) for v in got] == [tuple(v) for v in jsched.evaluate_population(masks, jc[:3])]
    assert all(v.reason == reason for v in got) and psched.last_removal_batch == 0


def test_empty_universe_resolves_without_a_launch(monkeypatch):
    (jsched, _, _), (psched, _, _) = _both()
    _refuse(monkeypatch)
    got = psched.evaluate_removals([[], []], ())
    assert [tuple(v) for v in got] == [tuple(v) for v in jsched.evaluate_removals([[], []], ())]
    assert got == [port_solver.RemovalVerdict(True, 0.0)] * 2
    pend = psched.dispatch_population(np.zeros((3, 0), bool), ())
    assert pend.ready is not None and pend.out is None
    assert psched.fetch_population(pend) == [port_solver.RemovalVerdict(True, 0.0)] * 3
    assert psched.last_removal_batch == 0


def test_pop_reason_resolves_without_a_launch(monkeypatch):
    """A base whose population tensors were refused (here marked by hand,
    as `_build_population_tensors` marks a composite-key overflow) answers
    every mask needs_host with its reason and launches nothing."""
    _, (psched, _, pc) = _both()
    base = psched._removal_base(tuple(pc))
    base.pop_reason = "occ-composite-overflow"
    _refuse(monkeypatch)
    got = psched.evaluate_population(_masks([(0, 1), (1,)], len(pc)), pc)
    assert got == [port_solver.RemovalVerdict(False, 0.0, True, "occ-composite-overflow")] * 2
    assert psched.last_removal_batch == 0


def test_subset_outside_the_universe_needs_the_host():
    """A pod the base never compiled sends its element to the host, and
    only that element."""
    (jsched, _, jc), (psched, _, pc) = _both()
    s = S.side("karpenter_tpu_torch")
    stray = s.RemovalCandidate("node-x", (s.Pod(name="stray", requests=s.Resources(cpu=1)),))
    js = S.side("karpenter_tpu")
    jstray = js.RemovalCandidate("node-x", (js.Pod(name="stray", requests=js.Resources(cpu=1)),))
    got = psched.evaluate_removals([[pc[0]], [stray], [pc[1]]], pc)
    want = jsched.evaluate_removals([[jc[0]], [jstray], [jc[1]]], jc)
    assert [tuple(v) for v in got] == [tuple(v) for v in want]
    assert got[1].needs_host and not got[0].needs_host
