"""The port's compile cache against the JAX package's, case by case.

Twins of tests/test_compile_cache.py's `TestCompileCache`: each case runs
on a cluster built in both packages (tests/torch_specs.py), with
`TensorScheduler` on the JAX CPU platform and `TorchScheduler(device="cpu")`.
The invalidation contract under test:

- a warm second solve of an IDENTICAL pending set hits the cache;
- a new pending set, a catalog epoch roll (a new type-list object), an
  in-place pool mutation, an in-place pod mutation (no stale feasibility
  rows), a live-node usage change and a live-node taint change each
  produce a fresh compile;
- `update()` with rolled inputs clears the cache;
- content-identical StateNode wrappers hit;
- the cache holds at most `_COMPILE_CACHE_CAP` entries.

Each case asserts the contract on both sides, and the hit and miss
counters (and the decoded results) of the two sides must be equal after
every solve of the case.
"""

import pytest

import torch_specs
from karpenter_tpu.api import labels as jax_labels
from karpenter_tpu_torch.api import labels as L

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"


class _Case:
    """One side's pool, inventory and a record of every solve."""

    def __init__(self, pkg: str):
        self.s = s = torch_specs.side(pkg)
        s.reset()
        self.pool = s.pool("default")
        self.types = s.catalog([self.pool], {})[self.pool.name]
        self.labels = jax_labels if pkg == JAX else L
        self.record = []

    def sched(self, existing=()):
        return self.s.scheduler([self.pool], {self.pool.name: self.types},
                                existing=list(existing))

    def pods(self, n=20, cpu=1):
        return [self.s.Pod(requests=self.s.Resources(cpu=cpu, memory="1Gi"))
                for _ in range(n)]

    def solve(self, ts, pods):
        result = ts.solve(pods)
        self.record.append((ts.compile_cache_hits, ts.compile_cache_misses,
                            torch_specs.canonical(result, self.labels)))
        return result

    def live_node(self, name, pods=(), used=None):
        s = self.s
        return s.StateNode(
            name=name,
            provider_id=f"fake://{name}",
            labels={s.L.LABEL_ZONE: "zone-a", s.L.LABEL_NODEPOOL: self.pool.name},
            taints=[],
            allocatable=s.Resources(cpu=16, memory="64Gi", pods=110),
            pods=list(pods),
            used=used if used is not None else s.Resources(),
        )


def _placed(result):
    return sum(len(vn.pods) for vn in result.new_nodes) + len(result.existing_placements)


def warm_identical_solve_hits(c: _Case):
    pods = c.pods()
    ts = c.sched()
    r1 = c.solve(ts, pods)
    assert (ts.compile_cache_hits, ts.compile_cache_misses) == (0, 1)
    r2 = c.solve(ts, pods)
    assert (ts.compile_cache_hits, ts.compile_cache_misses) == (1, 1)
    assert _placed(r1) == _placed(r2) == len(pods)
    assert len(r1.new_nodes) == len(r2.new_nodes)


def different_batch_misses(c: _Case):
    ts = c.sched()
    c.solve(ts, c.pods())
    c.solve(ts, c.pods())  # NEW pod objects: a different pending set
    assert (ts.compile_cache_hits, ts.compile_cache_misses) == (0, 2)


def catalog_epoch_roll_invalidates(c: _Case):
    pods = c.pods()
    ts = c.sched()
    c.solve(ts, pods)
    ts.instance_types = {c.pool.name: list(c.types)}  # a NEW list object
    c.solve(ts, pods)
    assert (ts.compile_cache_hits, ts.compile_cache_misses) == (0, 2)


def pool_mutation_invalidates(c: _Case):
    pods = c.pods()
    ts = c.sched()
    c.solve(ts, pods)
    c.pool.weight = c.pool.weight  # in-place reassignment bumps the epoch
    c.solve(ts, pods)
    assert (ts.compile_cache_hits, ts.compile_cache_misses) == (0, 2)


def pod_mutation_invalidates_no_stale_rows(c: _Case):
    pods = c.pods(n=5)
    ts = c.sched()
    r1 = c.solve(ts, pods)
    assert not r1.unschedulable
    # an impossible node selector (a defined key, impossible value): a
    # stale cached feasibility row would keep placing the pod
    pods[0].node_selector = {c.s.L.LABEL_ZONE: "zone-nowhere"}
    r2 = c.solve(ts, pods)
    assert ts.compile_cache_misses == 2
    assert pods[0].key() in r2.unschedulable
    assert _placed(r2) == len(pods) - 1


def update_clears_cache(c: _Case):
    ts = c.sched()
    c.solve(ts, c.pods())
    assert ts._compile_cache
    ts.update([c.pool], {c.pool.name: list(c.types)})
    assert not ts._compile_cache


def existing_node_change_invalidates(c: _Case):
    pods = c.pods(n=6)
    sn = c.live_node("live-1")
    ts = c.sched(existing=[sn])
    r1 = c.solve(ts, pods)
    assert len(r1.existing_placements) == len(pods)
    sn.used = sn.used + c.s.Resources(cpu=15)  # a pod binds
    r2 = c.solve(ts, pods)
    assert ts.compile_cache_misses == 2
    assert len(r2.existing_placements) < len(pods)


def live_taint_change_invalidates(c: _Case):
    pods = c.pods(n=4)
    sn = c.live_node("live-t")
    ts = c.sched(existing=[sn])
    r1 = c.solve(ts, pods)
    assert len(r1.existing_placements) == len(pods)
    sn.taints = [c.s.Taint(key="k", value="v", effect="NoSchedule")]
    r2 = c.solve(ts, pods)
    assert ts.compile_cache_misses == 2
    assert not r2.existing_placements  # intolerable node: all new nodes


def snapshot_rebuild_same_content_hits(c: _Case):
    pods = c.pods(n=6)
    bound = c.s.Pod(labels={"a": "b"}, requests=c.s.Resources(cpu=1))

    def wrapper():  # same BOUND pod objects, fresh wrapper
        return c.live_node("live-s", pods=[bound], used=c.s.Resources(cpu=1))

    ts = c.sched(existing=[wrapper()])
    r1 = c.solve(ts, pods)
    ts.existing = [wrapper()]  # next tick: fresh snapshot, same content
    r2 = c.solve(ts, pods)
    assert (ts.compile_cache_hits, ts.compile_cache_misses) == (1, 1)
    assert r1.existing_placements == r2.existing_placements


def cache_bounded(c: _Case):
    ts = c.sched()
    assert ts._COMPILE_CACHE_CAP == 8
    for _ in range(ts._COMPILE_CACHE_CAP + 4):
        c.solve(ts, c.pods(n=2))
    assert len(ts._compile_cache) == ts._COMPILE_CACHE_CAP


CASES = {f.__name__: f for f in (
    warm_identical_solve_hits,
    different_batch_misses,
    catalog_epoch_roll_invalidates,
    pool_mutation_invalidates,
    pod_mutation_invalidates_no_stale_rows,
    update_clears_cache,
    existing_node_change_invalidates,
    live_taint_change_invalidates,
    snapshot_rebuild_same_content_hits,
    cache_bounded,
)}


@pytest.mark.parametrize("case", list(CASES))
def test_compile_cache_twin(case):
    records = {}
    for pkg in (JAX, PORT):
        c = _Case(pkg)
        CASES[case](c)
        records[pkg] = c.record
    assert records[PORT] == records[JAX]
