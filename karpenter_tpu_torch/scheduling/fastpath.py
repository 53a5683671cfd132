"""Single-pod admission fast path (docs/designs/admission-fastpath.md).

Port of ``karpenter_tpu/scheduling/fastpath.py``: the score runs on the
device of the scheduler's resident state, the hand-written CUDA kernel on
the card (``ops/fused_packer.py: admit``) and its plain version on the CPU
(``ops/packer.py: admit_reference``), one [K+2] fetch either way.

At production traffic the dominant event is ONE pod arriving into a
cluster whose resident tensors already sit on device — and until this
module existed that pod paid a full warm solve plus up to a second of
coalesce-window wait.  The fast path instead:

1. **scatters** the arrival into the resident state through the same
   `ResidentCache.refresh` delta step the batched solve uses (donated
   buffers, changed rows only) — so by construction the authoritative
   solve and the fast path see the IDENTICAL device tensors;
2. **scores** the pod's class against open capacity and live-node
   headroom in ONE launch (`ops.packer.admit_kernel`, whose kernel shares
   the scan's capacity arithmetic and block scan, so it is the solve's
   own);
3. **cross-checks** the device verdict against a sequential host oracle
   (the verdict-mismatch discipline) — any disagreement refuses
   the nomination, counts `karpenter_admission_fastpath_mismatch_total`,
   and falls back to the batched solve, which stays authoritative;
4. **nominates** immediately, replicating `_decode`'s class-member /
   slot ordering exactly, so the periodic full solve converges to the
   identical cluster state (the twin test in tests/test_fastpath.py
   pins this tick-for-tick).

Anything outside the eligible shape — mixed-class bursts, affinity
carriers, a catalog roll in flight, a cold resident plane — falls back
with a counted reason (`karpenter_admission_fastpath_fallback_total`).
This module must NEVER tensorize (`compile_problem` / `_compile_tensor`),
so the sub-millisecond budget is structural.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from karpenter_tpu_torch.api import Pod
from karpenter_tpu_torch.obs.device import OBSERVATORY
from karpenter_tpu_torch.ops.packer import admit_kernel
from karpenter_tpu_torch.ops.resident import _plain_pod
from karpenter_tpu_torch.utils.trace import phase

# a "tiny burst" the fast path still absorbs in one dispatch: larger
# arrivals amortize the batched solve fine and gain nothing here
FASTPATH_MAX_BURST = 8

# fallback taxonomy (the `reason` label on
# karpenter_admission_fastpath_fallback_total; see the design doc table)
REASON_BURST_TOO_LARGE = "burst_too_large"  # > FASTPATH_MAX_BURST pods
REASON_MIXED_BURST = "mixed_burst"  # more than one pod class arriving
REASON_POD_SHAPE = "pod_shape"  # affinity/topology/volume carrier pod
REASON_AFFINITY_CARRIER = "affinity_carrier"  # bound carrier on a node
REASON_CATALOG_ROLL = "catalog_roll"  # inventory/pool epoch moved
REASON_RESIDENT_COLD = "resident_cold"  # no resident state seeded yet
REASON_RESIDENT_MISS = "resident_miss"  # delta planner declined the diff
REASON_SHARDED_BACKEND = "sharded_backend"  # mesh pack: batched path only
REASON_NEEDS_NEW_NODE = "needs_new_node"  # fits nowhere live, but openable
REASON_UNSCHEDULABLE = "unschedulable"  # fits nowhere, nothing openable
REASON_NO_POOLS = "no_pools"  # nothing to schedule against
REASON_VERDICT_MISMATCH = "verdict_mismatch"  # device refuted by oracle


@dataclass
class FastpathResult:
    """One admission attempt's verdict.

    outcome: ``"nominated"`` (placements holds pod key -> node name),
    ``"fallback"`` (reason names why; the batched solve must run), or
    ``"mismatch"`` (the device score disagreed with the sequential host
    oracle — a convergence-contract violation; treated as a fallback
    but counted separately, because the contract says it never happens).
    """

    outcome: str
    reason: str = ""
    placements: Dict[str, str] = field(default_factory=dict)


def _cap_host(rem: np.ndarray, req: np.ndarray) -> np.ndarray:
    """`ops.packer._per_node_cap`, transcribed to numpy float32 term for
    term (the float32 constants matter: a Python-float nudge would
    promote to float64 and round differently than XLA)."""
    safe = np.where(req > 0, req, np.float32(1.0))
    per_axis = np.where(
        req > 0,
        np.floor(rem / safe + np.float32(1e-4)),
        np.float32(2**30),
    )
    cap = per_axis.min(axis=-1)
    return np.maximum(cap, np.float32(0.0)).astype(np.int32)


def _open_ok(st, g: int, req_g: np.ndarray) -> bool:
    """The oracle's open-capacity bit, memoized on the state.

    The kernel reduces ``feas & openable & (cap > 0)`` over every
    column, but ``h_openable`` is True only on the CATALOG prefix
    (``[:fe]``) — a live node is never openable, and the delta step
    never writes the prefix's alloc/openable rows (col scatters start at
    ``fe``).  So the bit depends only on (g's req row, g's feas prefix),
    both tiny to key on — and the 4k-column ``_cap_host`` sweep, the
    single most expensive oracle term, runs once per class shape instead
    of once per admission."""
    fe = st.fe
    key = (int(g), req_g.tobytes(), st.h_feas[g, :fe].tobytes())
    memo = st.__dict__.setdefault("_open_ok_memo", {})
    hit = memo.get(key)
    if hit is None:
        cap_open = _cap_host(st.h_alloc[:fe], req_g)
        hit = bool(
            (st.h_feas[g, :fe] & st.h_openable[:fe] & (cap_open > 0)).any()
        )
        if len(memo) > 64:
            memo.clear()
        memo[key] = hit
    return hit


def _oracle(st, g: int):
    """The sequential host re-derivation of the admit score, from the
    resident HOST mirrors — the authority the device verdict must match
    bit-for-bit (take vector, placed count, and open-capacity bit)."""
    Kp = st.Kp
    E = len(st.live)
    req_g = st.h_req[g]
    # the kernel gathers alloc rows through a masked cfg index; on host
    # the valid rows are the contiguous live-column slice [fe, fe+E), so
    # the gather collapses to views and the masked tail to a zero fill —
    # identical arithmetic (the tail's cap is forced to 0 either way).
    # Likewise `_per_node_cap`'s axis sweep restricts to the axes the
    # class actually requests: a non-requested axis contributes the
    # 2**30 constant to the min, reintroduced below as a clamp, and a
    # requested axis runs the EXACT float32 op chain (`_cap_host` term
    # for term) — most classes request 2 of the R axes, and the oracle
    # sits on the per-admission budget.
    pos = np.flatnonzero(req_g > 0)
    if pos.size:
        rem_pos = (
            st.h_alloc[st.fe : st.fe + E, pos]
            - st.h_used0[:E, pos]
        )  # [E, |pos|]
        per_axis = np.floor(rem_pos / req_g[pos] + np.float32(1e-4))
        capf = per_axis.min(axis=1)
        if pos.size < req_g.shape[0]:
            capf = np.minimum(capf, np.float32(2**30))
    else:
        capf = np.full(E, np.float32(2**30), dtype=np.float32)
    cap = np.maximum(capf, np.float32(0.0)).astype(np.int32)
    cap = np.where(st.h_feas[g, st.fe : st.fe + E], cap, 0)
    prefix = np.cumsum(cap, dtype=np.int64).astype(np.int32) - cap
    n_g = st.h_cnt[g]
    take = np.zeros(Kp, dtype=np.int32)
    take[:E] = np.clip(n_g - prefix, 0, cap)
    open_ok = _open_ok(st, g, req_g)
    return take, int(take.sum()), open_ok


def try_admit(scheduler, pods: Sequence[Pod]) -> FastpathResult:
    """Attempt the incremental admission of a tiny fresh-pod burst.

    The caller (Provisioner._admit_fastpath) has already synced the
    scheduler against the live snapshot; this function owns eligibility,
    the resident scatter, the one-dispatch score, the oracle
    cross-check, and the decode.  It NEVER mutates cluster state — the
    caller nominates from the returned placements.

    The body runs with the cyclic collector deferred: a gen-scan pause
    landing mid-admission is the single largest tail term at this
    budget, and the critical section's few dozen short-lived
    allocations cannot themselves need a collection.  Collection
    resumes (same enabled-state as on entry) before the verdict is
    returned."""
    was_enabled = gc.isenabled()
    if was_enabled:
        gc.disable()
    try:
        return _try_admit(scheduler, pods)
    finally:
        if was_enabled:
            gc.enable()


def _try_admit(scheduler, pods: Sequence[Pod]) -> FastpathResult:
    pods = list(pods)
    # ---- eligibility: the resident plane's rules, checked cheapest-first
    if not pods or len(pods) > FASTPATH_MAX_BURST:
        return FastpathResult("fallback", REASON_BURST_TOO_LARGE)
    if any(not _plain_pod(p) for p in pods):
        return FastpathResult("fallback", REASON_POD_SHAPE)
    ck = pods[0].class_key()
    if len(pods) > 1 and any(p.class_key() != ck for p in pods[1:]):
        # the admit score is exactly the full solve's ONLY when the
        # arriving class is the sole class being placed (the pack scan
        # is order-sensitive across classes)
        return FastpathResult("fallback", REASON_MIXED_BURST)
    cache = scheduler._resident
    if not cache.states:
        return FastpathResult("fallback", REASON_RESIDENT_COLD)
    # carrier scan + catalog key ride the cache's tick trust window when
    # the caller opened one (Provisioner._sync_scheduler) — otherwise
    # both are computed rigorously per call.  The window is validated
    # ONCE here (the witness walks every node id) and handed to refresh.
    win = cache._window(scheduler)
    if win is not None:
        carrier_ok, cat_key = win[2], win[3]
    else:
        carrier_ok = cache.carrier_free(scheduler)
        cat_key = cache.catalog_key(scheduler)
    if not carrier_ok:
        return FastpathResult("fallback", REASON_AFFINITY_CARRIER)
    if all(st.cat_key != cat_key for st in cache.states):
        return FastpathResult("fallback", REASON_CATALOG_ROLL)
    # ---- scatter: the batched solve's own delta step, shared verbatim.
    # Running it here (not a private copy) is the convergence mechanism:
    # after a nomination the authoritative solve refreshes the SAME
    # state and sees zero churn.
    with phase("delta"):
        st = cache.refresh(scheduler, pods, _win=win)
    if st is None:
        return FastpathResult("fallback", REASON_RESIDENT_MISS)
    if st.mesh is not None:
        # the sharded backend packs over its mesh only in the batched
        # solve; the refresh above still warmed the state for it
        return FastpathResult("fallback", REASON_SHARDED_BACKEND)
    g = st.slot_of.get(ck)
    if g is None:
        return FastpathResult("fallback", REASON_RESIDENT_MISS)
    # ---- score: ONE launch, ONE [Kp+2] fetch (g a host int: the launch
    # signature counts numbers by type, so a new class is no new signature)
    with phase("dispatch"):
        out = OBSERVATORY.dispatch(
            "admit_kernel", admit_kernel,
            st.d_req, st.d_cnt, st.d_feas, st.d_alloc, st.d_openable,
            st.d_used0, st.d_cfg0, int(g),
        )
    with phase("device_block"):
        arr = out.cpu().numpy()
    take_dev = arr[:-2]
    placed_dev = int(arr[-2])
    open_dev = bool(arr[-1])
    # ---- verdict-mismatch discipline: sequential oracle, bit-equality
    with phase("oracle"):
        take_host, placed_host, open_host = _oracle(st, int(g))
        ok = (
            placed_dev == placed_host
            and open_dev == open_host
            and bool((take_dev == take_host).all())
        )
    if not ok:
        return FastpathResult("mismatch", REASON_VERDICT_MISMATCH)
    n_g = int(st.h_cnt[g])
    if placed_host < n_g:
        return FastpathResult(
            "fallback",
            REASON_NEEDS_NEW_NODE if open_host else REASON_UNSCHEDULABLE,
        )
    # ---- decode: exactly solver._decode's ordering — class members in
    # arrival order fill ascending nonzero slots
    with phase("decode"):
        placements: Dict[str, str] = {}
        members: List[Pod] = st.cls[g].cm.pods
        cursor = 0
        for k in np.nonzero(take_host)[0]:
            c = int(take_host[k])
            for p in members[cursor : cursor + c]:
                placements[p.key()] = st.live[int(k)].name
            cursor += c
    return FastpathResult("nominated", placements=placements)
