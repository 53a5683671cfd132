"""The port's warm tick against the JAX package's, step by step.

The CPU twin of tests/test_resident_fuzz.py.  One seeded mutation stream
(pod arrive / delete / in-place mutate, node add / remove / label flip /
usage change, and two catalog rolls) is applied to two copies of one
cluster, built in the JAX package and in karpenter_tpu_torch
(tests/torch_specs.py), and each copy is solved after every step by its
long-lived scheduler: `TensorScheduler` on the JAX CPU platform and
`TorchScheduler(device="cpu")`, whose resident tensors then live on the CPU
and pack through the plain version.

After every step, with no tolerance (float32 compared bit for bit):
  1. the warm-tick counters agree (resident hit / rebuild / delta rows,
     compile-cache hits and misses);
  2. the port's padded host mirrors equal the JAX state's, and its snapshot
     equals a from-scratch compile of the port;
  3. the port's device tensors equal its mirrors;
  4. the padded regions hold their canonical pad values (a scratch-slot
     leak would poison a LATER gather, so it is pinned directly);
  5. the decoded result equals the JAX solve's.
"""

import random

import numpy as np
import pytest

import torch_specs
from karpenter_tpu.api import labels as jax_labels
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.ops.tensorize import partition_groups

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
ZONES = ("zone-a", "zone-b", "zone-c")
TYPES = 24  # the trimmed inventory of the JAX fuzz
MIRRORS = ("req", "cnt", "feas", "alloc", "price", "openable", "used0", "npods0")
TENSORS = (
    "req", "cnt", "maxper", "slot", "feas", "alloc", "price",
    "openable", "used0", "cfg0", "npods0",
)
COUNTERS = (
    "last_path", "last_resident", "last_delta_rows", "resident_hits",
    "resident_rebuilds", "compile_cache_hits", "compile_cache_misses",
)


def _sizes(s):
    R = s.Resources
    return (
        R(cpu=0.25, memory="256Mi"),
        R(cpu=0.5, memory="512Mi"),
        R(cpu=1, memory="1Gi"),
        R(cpu=2, memory="2Gi"),
        R(cpu=2, memory="8Gi"),
        R(cpu=4, memory="4Gi"),
    )


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(a, b, what) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


class _Side:
    """One package's copy of the cluster and its long-lived scheduler."""

    def __init__(self, pkg: str):
        self.s = s = torch_specs.side(pkg)
        s.reset()
        self.sizes = _sizes(s)
        self.pool = s.pool("default")
        self.types = s.catalog([self.pool], {})[self.pool.name][:TYPES]
        self.inventory = {self.pool.name: self.types}
        self.pods: list = []
        self.live: list = []
        self.ts = s.scheduler([self.pool], self.inventory)

    def pod(self, size: int, zone=None):
        p = self.s.Pod(requests=self.sizes[size])
        if zone is not None:
            p.node_selector = {self.s.L.LABEL_ZONE: zone}
        return p

    def node(self, name: str, zone: str):
        L_ = self.s.L
        return self.s.StateNode(
            name=name,
            provider_id=f"fake://{name}",
            labels={L_.LABEL_ZONE: zone, L_.LABEL_NODEPOOL: self.pool.name},
            taints=[],
            allocatable=self.s.Resources(cpu=16, memory="64Gi", pods=110),
            pods=[],
            used=self.s.Resources(),
        )

    def solve(self):
        self.ts.update([self.pool], self.inventory, existing=list(self.live))
        return self.ts.solve(list(self.pods))


class _TwinFuzz:
    """The JAX fuzz's stream, every random choice made once and applied to
    both sides (pods are created in pairs, so both packages' name
    sequences stay in step)."""

    OPS = (
        ("arrive", 5),
        ("delete", 2),
        ("mutate_pod", 2),
        ("add_node", 3),
        ("remove_node", 1),
        ("mutate_node_labels", 1),
        ("mutate_node_usage", 2),
    )

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.jax, self.port = _Side(JAX), _Side(PORT)
        self.sides = (self.jax, self.port)
        self.n_node = 0
        self.checked = 0
        self.skipped = 0

    # ------------------------------------------------------------- ops
    def op_arrive(self):
        for _ in range(self.rng.randint(1, 5)):
            size = self.rng.randrange(6)
            zone = self.rng.choice(ZONES) if self.rng.random() < 0.25 else None
            for sd in self.sides:
                sd.pods.append(sd.pod(size, zone))

    def op_delete(self):
        for _ in range(min(self.rng.randint(1, 3), len(self.port.pods))):
            i = self.rng.randrange(len(self.port.pods))
            for sd in self.sides:
                sd.pods.pop(i)

    def op_mutate_pod(self):
        if not self.port.pods:
            return
        i, size = self.rng.randrange(len(self.port.pods)), self.rng.randrange(6)
        for sd in self.sides:
            sd.pods[i].requests = sd.sizes[size]  # bumps _mut, moves class

    def op_add_node(self):
        self.n_node += 1
        zone = self.rng.choice(ZONES)
        for sd in self.sides:
            sd.live.append(sd.node(f"fz-{self.n_node}", zone))

    def op_remove_node(self):
        if self.port.live:
            i = self.rng.randrange(len(self.port.live))
            for sd in self.sides:
                sd.live.pop(i)

    def op_mutate_node_labels(self):
        if not self.port.live:
            return
        i, zone = self.rng.randrange(len(self.port.live)), self.rng.choice(ZONES)
        for sd in self.sides:
            sd.live[i].labels[sd.s.L.LABEL_ZONE] = zone

    def op_mutate_node_usage(self):
        if not self.port.live:
            return
        i = self.rng.randrange(len(self.port.live))
        unbind = bool(self.port.live[i].pods) and self.rng.random() < 0.4
        size = None if unbind else self.rng.randrange(6)
        for sd in self.sides:
            sn = sd.live[i]
            if unbind:
                bp = sn.pods.pop()
                sn.used = (sn.used - bp.requests).clamp_nonnegative()
            else:
                bp = sd.s.Pod(requests=sd.sizes[size])
                sn.pods.append(bp)
                sn.used = sn.used + bp.requests

    def op_catalog_roll(self):
        # a new type-list object == a provider refresh: every identity-keyed
        # cache must miss and rebuild
        for sd in self.sides:
            sd.types = list(sd.types)
            sd.inventory = {sd.pool.name: sd.types}

    def step(self, roll: bool = False):
        if roll:
            self.op_catalog_roll()
        else:
            names = [n for n, w in self.OPS for _ in range(w)]
            for _ in range(self.rng.randint(1, 3)):
                getattr(self, f"op_{self.rng.choice(names)}")()
        # keep the batch inside one padded-bucket neighbourhood
        while len(self.port.pods) > 48:
            i = self.rng.randrange(len(self.port.pods))
            for sd in self.sides:
                sd.pods.pop(i)
        if not self.port.pods:
            self.op_arrive()
        ref, got = self.jax.solve(), self.port.solve()
        self.check(ref, got)

    # ---------------------------------------------------------- checks
    def _scratch(self):
        """A from-scratch compile of the port's cluster."""
        sd = self.port
        fresh = sd.s.scheduler([sd.pool], dict(sd.inventory))
        fresh.update([sd.pool], sd.inventory, existing=list(sd.live))
        sup, unsup, _why = partition_groups(sd.pods, existing=fresh.existing, pools=fresh.pools)
        assert not unsup, "fuzz batches must stay resident-expressible"
        return fresh._compile_tensor([p for _, members in sup for p in members], sup)

    def check(self, ref, got):
        jts, pts = self.jax.ts, self.port.ts
        # 1) counters
        assert [getattr(pts, k) for k in COUNTERS] == [getattr(jts, k) for k in COUNTERS]
        # 5) decoded result
        assert torch_specs.canonical(got, L) == torch_specs.canonical(ref, jax_labels)
        if not pts.last_resident:
            # a compile-cache hit re-serving a snapshot whose state has
            # since moved on: counted, the stream floor keeps it rare
            self.skipped += 1
            return
        self.checked += 1
        check_state(pts._resident.states[-1], self.port.pods, self._scratch(),
                    jts._resident.states[-1])


def _host(t) -> np.ndarray:
    return t.host() if hasattr(t, "host") else t.cpu().numpy()


def check_state(st, pods, scratch, ref_state=None) -> None:
    """Checks 2-4 on the state that served the solve (refresh moves it to
    the MRU end, rebuild appends it)."""
    assert set(st.pod_entry) == set(map(id, pods))
    # 2) mirrors equal the JAX state's ...
    if ref_state is not None:
        assert (st.Gp, st.Cp, st.Kp, st.R, st.fe) == (
            ref_state.Gp, ref_state.Cp, ref_state.Kp, ref_state.R, ref_state.fe)
        for name in MIRRORS:
            _equal(getattr(st, f"h_{name}"), getattr(ref_state, f"h_{name}"), name)
    # ... and the snapshot equals a from-scratch compile
    prob = st.problem()
    assert prob.axes == scratch.axes
    for name in TENSORS:
        _equal(getattr(prob, name), getattr(scratch, name), name)
    assert [sorted(map(id, cm.pods)) for cm in prob.classes] == [
        sorted(map(id, cm.pods)) for cm in scratch.classes]
    row = lambda c: (c.zone, c.capacity_type, c.price,
                     c.existing.name if c.existing is not None else None)
    assert list(map(row, prob.configs)) == list(map(row, scratch.configs))
    # 3) device tensors equal the mirrors (a state on a mesh: each buffer
    #    read back whole from its shards)
    for name in MIRRORS:
        _equal(_host(getattr(st, f"d_{name}")), getattr(st, f"h_{name}"), f"d_{name}")
    E = len(st.live)
    cfg0 = np.full(st.Kp, -1, np.int32)
    cfg0[:E] = np.arange(st.fe, st.fe + E)
    _equal(_host(st.d_cfg0), cfg0, "d_cfg0")
    # 4) pad hygiene
    G, C = len(st.cls), st.fe + E
    assert not st.h_feas[G:, :].any() and not st.h_feas[:, C:].any()
    assert (st.h_req[G:] == 0).all() and (st.h_cnt[G:] == 0).all()
    assert np.isinf(st.h_price[C:]).all()
    assert (st.h_alloc[C:] == 0).all()
    assert (st.h_used0[E:] == 0).all() and (st.h_npods0[E:] == 0).all()


@pytest.mark.parametrize("seed", [7, 23])
def test_twin_stream(seed):
    from karpenter_tpu.obs.device import OBSERVATORY as JAX_OBS
    from karpenter_tpu_torch.obs.device import OBSERVATORY as PORT_OBS

    steps, rolls = 25, (9, 17)
    scopes = (JAX_OBS.begin_scope(), PORT_OBS.begin_scope())
    try:
        fz = _TwinFuzz(seed)
        for i in range(steps):
            fz.step(roll=i in rolls)
    finally:
        JAX_OBS.end_scope(scopes[0])
        PORT_OBS.end_scope(scopes[1])
    ts = fz.port.ts
    # the stream exercised the warm path AND the rebuild (the cold start
    # and the catalog rolls at least): test_resident_fuzz.py's floors
    assert fz.checked >= steps - max(2, steps // 8), (fz.checked, fz.skipped)
    assert ts.resident_rebuilds >= 1 + len(rolls), (ts.resident_hits, ts.resident_rebuilds)
    assert ts.resident_hits > ts.resident_rebuilds, (ts.resident_hits, ts.resident_rebuilds)
    # the device observatory counted the same updates on both sides
    assert scopes[1].resident_updates.get("donated", 0) > 0
    assert scopes[1].resident_updates == scopes[0].resident_updates


# ---------------------------------------------------------------------------
# TestResidentCoherence's four cases, each run on both sides
# ---------------------------------------------------------------------------


def _carrier_node(sd: _Side, name="anti-1"):
    """A CORDONED node whose bound pod carries an everything-matching
    anti-affinity term: invisible to the live filter, but partition_groups
    still repels every batch class it selects."""
    s = sd.s
    carrier = s.Pod(
        labels={"app": "repel"},
        requests=s.Resources(cpu=0.5),
        pod_affinity=[
            s.PodAffinityTerm(topology_key=s.L.LABEL_ZONE, label_selector=(), anti=True)
        ],
    )
    return s.StateNode(
        name=name,
        provider_id=f"fake://{name}",
        labels={s.L.LABEL_ZONE: ZONES[0], s.L.LABEL_NODEPOOL: sd.pool.name},
        taints=[],
        allocatable=s.Resources(cpu=16, memory="64Gi", pods=110),
        pods=[carrier],
        used=s.Resources(cpu=0.5),
        node=s.Node(name=name, cordoned=True),
    )


def _fresh_solve(sd: _Side, existing, pods):
    ref = sd.s.scheduler([sd.pool], dict(sd.inventory))
    ref.update([sd.pool], sd.inventory, existing=list(existing))
    return ref.solve(list(pods))


def _placement_key(result):
    return (
        sorted((len(n.pods), n.feasible_types[0].name) for n in result.new_nodes),
        sorted(result.unschedulable),
    )


def _cache_hit_after_delta(sd: _Side) -> list:
    """Reverting to an earlier batch re-serves the earlier cache entry,
    which must be unchanged: the delta may not mutate ClassMeta objects the
    cached problem shares."""
    ts = sd.ts
    a, b = sd.pod(2), sd.pod(2)  # one class
    ts.solve([a])
    assert ts.last_path == "tensor"
    ts.solve([a, b])
    assert ts.last_resident  # the arrival rode the delta path
    res = ts.solve([a])  # revert: same object + epoch -> cache hit
    assert ts.compile_cache_hits >= 1
    assert not res.unschedulable  # no phantom b from the entry
    assert [id(p) for n in res.new_nodes for p in n.pods] == [id(a)]
    return [res]


def _equal_count_swap(sd: _Side) -> list:
    """b -> c inside one class keeps every tensor (zero delta rows), but
    decode must assign the CURRENT pod objects."""
    ts = sd.ts
    a, b, c = (sd.pod(1) for _ in range(3))
    ts.solve([a, b])
    res = ts.solve([a, c])
    assert ts.last_resident and ts.last_delta_rows == 0
    assert not res.unschedulable
    assert {id(p) for n in res.new_nodes for p in n.pods} == {id(a), id(c)}
    return [res]


def _cordoned_carrier_blocks_seed(sd: _Side) -> list:
    """With an anti-affinity carrier on a cordoned node the batch is
    oracle-routed and the resident layer stays out entirely."""
    ts = sd.ts
    ts.update([sd.pool], sd.inventory, existing=[_carrier_node(sd)])
    pods = [sd.pod(0) for _ in range(6)]
    res1, res2 = ts.solve(list(pods)), ts.solve(list(pods))
    assert ts.resident_hits == 0 and not ts.last_resident
    ref = _fresh_solve(sd, [_carrier_node(sd)], pods)
    assert _placement_key(res1) == _placement_key(ref) == _placement_key(res2)
    return [res1, res2]


def _carrier_arrival_falls_back(sd: _Side) -> list:
    """A carrier appearing on a NON-live node mid-stream forces the warm
    path back to the full compile."""
    ts = sd.ts
    pods = [sd.pod(0) for _ in range(6)]
    ts.solve(list(pods))
    pods.append(sd.pod(0))
    ts.solve(list(pods))
    assert ts.last_resident  # warm path proven before the carrier
    cordoned = _carrier_node(sd)
    ts.update([sd.pool], sd.inventory, existing=[cordoned])
    pods.append(sd.pod(0))
    res = ts.solve(list(pods))
    assert not ts.last_resident
    ref = _fresh_solve(sd, [cordoned], pods)
    assert _placement_key(res) == _placement_key(ref)
    return [res]


def _trust_window(sd: _Side) -> list:
    """Inside a tick trust window (`ResidentCache.note_sync`) a delta skips
    the per-node diff and still equals a fresh solve; a changed node list
    closes the window and the per-call scan takes over."""
    ts, cache = sd.ts, sd.ts._resident
    nodes = [sd.node("tw-1", "zone-a"), sd.node("tw-2", "zone-b")]
    ts.update([sd.pool], sd.inventory, existing=nodes)
    pods = [sd.pod(1) for _ in range(4)]
    results = [ts.solve(list(pods))]
    cache.note_sync(ts)
    assert cache.carrier_free(ts) and cache.catalog_key(ts) == cache._tick[3]
    for size in (2, 0):  # the second delta in the window skips the node diff
        pods.append(sd.pod(size))
        results.append(ts.solve(list(pods)))
        assert ts.last_resident and cache._window(ts) is not None
        assert _placement_key(results[-1]) == _placement_key(_fresh_solve(sd, nodes, pods))
    nodes = nodes + [sd.node("tw-3", "zone-c")]
    ts.update([sd.pool], sd.inventory, existing=nodes)
    assert cache._window(ts) is None
    pods.append(sd.pod(3))
    results.append(ts.solve(list(pods)))
    assert ts.last_resident
    assert _placement_key(results[-1]) == _placement_key(_fresh_solve(sd, nodes, pods))
    return results


COHERENCE = {
    "cache_hit_after_delta_decodes_original_membership": _cache_hit_after_delta,
    "equal_count_swap_refreshes_snapshot": _equal_count_swap,
    "cordoned_carrier_blocks_resident_seed": _cordoned_carrier_blocks_seed,
    "carrier_arrival_falls_back_to_full_compile": _carrier_arrival_falls_back,
    "trust_window_skips_the_node_diff": _trust_window,
}


@pytest.mark.parametrize("case", sorted(COHERENCE))
def test_resident_coherence_twin(case):
    """Each case holds on both sides, and the two agree on the counters
    and on every decoded result."""
    seen = {}
    for pkg, labels in ((JAX, jax_labels), (PORT, L)):
        sd = _Side(pkg)
        results = COHERENCE[case](sd)
        seen[pkg] = (
            [getattr(sd.ts, k) for k in COUNTERS],
            [torch_specs.canonical(r, labels) for r in results],
        )
    assert seen[PORT] == seen[JAX]
