"""Device-resident incremental solve tensors: the warm reconcile tick.

Port of ``karpenter_tpu/ops/resident.py``.  Every reconcile tick used to
re-tensorize the pods x classes x configs problem on the host and upload it;
this module keeps the PADDED solve tensors **resident on the card across
ticks** and updates them with **gather + scatter deltas** instead.

- `ResidentState` owns one padded problem: host numpy MIRRORS (the source
  of truth the delta planner edits) plus device tensors kept bit-identical
  to them by replaying every edit through one gather + scatter step
  (`_delta_step`).  The step gathers into a partner buffer allocated at
  seed time and swaps the two (the counterpart of the reference's donated
  buffers), so a warm tick keeps every resident allocation and uploads only
  the permutations and the changed rows and columns.
- The **delta planner** diffs the incoming (pods, live nodes) against the
  resident epoch: pod and pool objects key by ``(id, _mut)``, live nodes by
  content.  The diff becomes a class-axis permutation (arrivals insert at
  their FFD sort position, departures compact), a live-column permutation
  over the config and node-slot axes, and scatter payloads for new or
  changed rows.
- **Equivalence discipline**: the delta path produces tensors bit-equal to
  a from-scratch `compile_problem` at every step (tests/test_torch_resident.py
  holds it against the JAX package and against a fresh compile).  Row
  assembly is shared with the compiler (`tensorize.open_config_row` /
  `restrict_open_tier` / `ffd_class_key`), and anything the planner cannot
  prove equivalent (catalog roll, pool change, constraint carriers, axis
  changes, bucket overflow, another device) falls back to the full compile.
- The resident pack (`ResidentState.pack`) launches `fused_packer.ffd_pack`
  straight on the resident tensors: on the card the hand-written kernels,
  for a CPU state their plain version.
- **Sharding**: when the scheduler's pack_fn is the mesh backend
  (parallel/mesh.py `mesh_pack_fn`), the buffers are placed by the mesh's
  one table of shard specs (``SHARD_SPECS``: the class and catalog buffers
  one copy a device, the slot buffers split over the data rows), the delta
  step edits each copy and reshards the slot buffers, and the pack runs
  the sharded pack on them (``sharded_pack``).
- Every upload goes through the device observatory's counted `put`
  (obs/device.py) under the reference's sites, ``resident_seed`` and
  ``resident_delta``; the pack and the delta step launch through its
  `dispatch`, and each update counts as ``seed``, ``donated`` or ``noop``.

`TenantResidentPool` is the multi-tenant solver service's counterpart
(service/server.py): each tenant's solve tensors stay on the device between
its solves, keyed by content fingerprint, under a global bytes budget with
tenant-granular LRU eviction.

Eligibility (the "plain" subset): every batch pod free of pod affinity /
topology spread / preferences / multi-OR-term node affinity / volume
claims, and no bound pod on ANY existing node (live, cordoned or draining)
carrying pod affinity.  Everything else takes the ordinary compile path.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.api import Pod
from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.obs.device import OBSERVATORY
from karpenter_tpu_torch.ops.packer import (
    _bucket,
    _bucket_classes,
    dispatch_pack,
    resolve_device,
)
from karpenter_tpu_torch.ops.tensorize import (
    BIG,
    Catalog,
    ClassMeta,
    CompiledProblem,
    ConfigMeta,
    _fits_existing,
    _vec,
    ffd_class_key,
    live_filter,
    open_config_row,
    restrict_open_tier,
)
from karpenter_tpu_torch.parallel.mesh import SHARD_SPECS, place
from karpenter_tpu_torch.utils.trace import phase

# a delta touching more than this fraction of the batch rebuilds instead:
# past the midpoint the full compile is cheaper than planning and
# scattering most of the tensor anyway (the +8 grace keeps tiny batches
# from thrashing on integer effects)
REBUILD_FRACTION = 0.5

# node-slot headroom replicated from packer.node_slot_bound for the plain
# shape (no constrained classes): E + min(n_pods, 256)
_SLOT_HEADROOM = 256


def _plain_pod(p: Pod) -> bool:
    """The resident-expressible pod shape: no pod-level coupling, no
    relax-eligible soft constraints, no volume claims, so every delta is
    order-independent at the class level."""
    return not (
        p.pod_affinity
        or p.topology_spread
        or p.preferred_affinity
        or p.volume_claims
        or len(p.node_affinity_terms()) > 1
    )


def resident_capable(pack_fn) -> bool:
    """Resident tensors serve only the pack backends that run in this
    process on its devices: the in-process pack (``pack_fn`` None) or the
    mesh-sharded one.  A sidecar's (or any custom) pack_fn keeps the plain
    upload path: its transfer contract is its own."""
    return pack_fn is None or getattr(pack_fn, "mesh", None) is not None


def _carrier_free(existing) -> bool:
    """No bound pod anywhere in `existing` (live, cordoned or draining) may
    carry a pod-affinity term.  partition_groups routes batch classes
    selected by any existing carrier's anti term to the oracle, a decision
    keyed to ALL existing nodes that the delta planner cannot replay, and
    live carriers change feasibility columns.  It is also why the resident
    path may skip the solver's compaction guard."""
    return not any(bp.pod_affinity for sn in existing for bp in sn.pods)


def _catalog_key(solver) -> tuple:
    """Identity+epoch fingerprint of everything the catalog derives from: a
    rolled inventory list, a mutated pool or a changed daemonset set
    obsoletes every resident tensor."""
    return (
        tuple((id(p), p.__dict__.get("_mut", 0)) for p in solver.pools),
        tuple(sorted((k, id(v)) for k, v in solver.instance_types.items())),
        tuple((id(d), d.__dict__.get("_mut", 0)) for d in solver.daemonsets),
    )


def _node_sched_fp(sn) -> tuple:
    """The node content that drives ADMISSION (the feasibility column and
    the allocatable row): labels, taints, allocatable."""
    return (
        tuple(sorted(sn.labels.items())),
        tuple(map(repr, sn.taints)),
        tuple(sorted(sn.allocatable.items())),
    )


def _node_usage_fp(sn) -> tuple:
    """The node content that drives PREFILL (used0/npods0): usage plus the
    bound-pod identity+epoch set (a mutated bound pod could grow pod
    affinity, which the eligibility guard must re-check)."""
    return (
        tuple(sorted(sn.used.items())),
        tuple((id(bp), bp.__dict__.get("_mut", 0)) for bp in sn.pods),
    )


class _Cls:
    """One resident class: the compile's ClassMeta plus planner caches."""

    __slots__ = ("cm", "key", "req_vec", "sched", "sort_key")

    def __init__(self, cm: ClassMeta, key, axes):
        self.cm = cm
        self.key = key  # the interned ClassKey
        self.req_vec = _vec(cm.requests, axes)
        rep = cm.pods[0]
        # signature-determined, so any member's is equivalent: computed
        # once per class and kept even if the original rep departs
        self.sched = rep.scheduling_requirements(preferred=True)
        self.sort_key = ffd_class_key(cm)


def _pad_idx(idx: List[int], scratch: int, floor: int = 4) -> np.ndarray:
    """Pad a scatter index list to its power-of-two bucket with the scratch
    slot (whose payload entries are canonical pad values), so the delta
    step's shapes come from a few buckets instead of every delta size."""
    n = _bucket(max(len(idx), 1), floor=floor)
    return np.asarray(idx + [scratch] * (n - len(idx)), np.int32)


class ResidentState:
    """One device-resident padded problem plus the metadata to diff it."""

    # the seven buffers a delta edits, each with a partner of the same
    # shape that the step gathers into before the two swap
    _MUTABLE = ("req", "cnt", "feas", "alloc", "price", "used0", "npods0")

    def __init__(self):
        # which solver purpose seeded this state: the consumer label of
        # ResidentCache.footprint
        self.consumer = "solve"
        # identity / catalog epoch
        self.cat_key: tuple = ()
        self.axes: Tuple[str, ...] = ()
        self.catalog: Optional[Catalog] = None
        self.pools_by_name: dict = {}
        self.fe = 0  # first_existing == len(catalog.configs)
        self.device: Optional[torch.device] = None  # where the tensors live
        # the pack backend the state was seeded for, and its mesh (None: one
        # device); on a mesh every d_* buffer is a `Sharded`
        self.pack_fn_ref = None
        self.mesh = None
        self.pins: tuple = ()  # keep every id-keyed object allocated
        # classes / pods
        self.cls: List[_Cls] = []
        self.slot_of: Dict[object, int] = {}  # ClassKey -> g
        self.pod_entry: Dict[int, tuple] = {}  # id -> (pod, mut, ClassKey)
        self.extra_axes: Dict[str, int] = {}  # extra axis -> using classes
        # live nodes
        self.live: list = []
        self.node_pos: Dict[str, int] = {}
        self.node_fp: Dict[str, tuple] = {}
        self.configs_live: List[ConfigMeta] = []
        # padded host mirrors (source of truth; the device mirrors them)
        self.Gp = self.Cp = self.Kp = self.R = 0
        self.h_req = self.h_cnt = self.h_feas = None
        self.h_alloc = self.h_price = self.h_openable = None
        self.h_used0 = self.h_npods0 = None
        # device tensors
        self.d_req = self.d_cnt = self.d_feas = None
        self.d_alloc = self.d_price = self.d_openable = None
        self.d_used0 = self.d_npods0 = self.d_cfg0 = None
        self.d_maxper = self.d_slot = self.d_sig0 = None
        # gather partners of the seven mutable buffers, plus cfg0's iota
        self.partner: Dict[str, torch.Tensor] = {}
        self.iota = self.neg1 = None
        # current snapshot (what the solver's compile cache stores)
        self.prob: Optional[CompiledProblem] = None
        self.last_delta_rows = 0
        self.last_update = ""  # "seed" | "donated" | "noop"
        # the trust window (ResidentCache.note_sync) this state's node
        # columns were last refreshed in
        self.tick_token = None

    # -------------------------------------------------------------- build
    @classmethod
    def build(
        cls, solver, pods: List[Pod], prob: CompiledProblem, catalog,
        consumer: str = "solve",
    ):
        """Seed a state from a freshly-compiled problem, or None when the
        problem falls outside the resident-expressible shape."""
        if prob is None or not prob.supported or prob.compile_relaxed:
            return None
        if prob.n_track_slots != 1:
            return None
        for cm in prob.classes:
            if (
                cm.group_size
                or cm.zone_pin
                or cm.rep_override is not None
                or cm.pool_allow is not None
                or cm.infeasible
            ):
                return None
        if len(set(map(id, pods))) != len(pods):
            return None  # duplicate objects would double-count a class
        for p in pods:
            if not _plain_pod(p):
                return None
        fe = len(catalog.configs)
        live = [cfg.existing for cfg in prob.configs[fe:]]
        if not _carrier_free(solver.existing):
            return None  # carriers (even on non-live nodes) change the partition
        st = cls()
        st.consumer = consumer
        st.cat_key = _catalog_key(solver)
        st.axes = prob.axes
        st.catalog = catalog
        st.pools_by_name = {p.name: p for p in catalog.pools}
        st.fe = fe
        st.device = solver.device
        st.pack_fn_ref = solver.pack_fn
        st.mesh = getattr(solver.pack_fn, "mesh", None)
        st.pins = (
            tuple(solver.pools),
            tuple(solver.instance_types.values()),
            tuple(solver.daemonsets),
        )
        G, C = prob.feas.shape
        E = C - fe
        n_pods = prob.total_pods()
        st.R = len(prob.axes)
        st.Gp = _bucket_classes(G + 1)
        st.Cp = _bucket(C + 1)
        # not pad_problem's node_slot_bound: the scratch slot needs the +1,
        # and the solver's overflow retry (k_slots != Kp) keys on the gap
        st.Kp = _bucket(E + min(n_pods, _SLOT_HEADROOM) + 1)
        for g, cm in enumerate(prob.classes):
            key = cm.pods[0].class_key()
            st.cls.append(_Cls(cm, key, st.axes))
            st.slot_of[key] = g
            for ax in cm.requests.keys():
                if ax not in L.WELL_KNOWN_RESOURCES:
                    st.extra_axes[ax] = st.extra_axes.get(ax, 0) + 1
            for p in cm.pods:
                st.pod_entry[id(p)] = (p, p.__dict__.get("_mut", 0), key)
        st.live = list(live)
        st.configs_live = list(prob.configs[fe:])
        for e, sn in enumerate(live):
            st.node_pos[sn.name] = e
            st.node_fp[sn.name] = (_node_sched_fp(sn), _node_usage_fp(sn))
        # padded mirrors (pad_problem's conventions: price inf, cfg -1)
        st.h_req = np.zeros((st.Gp, st.R), np.float32)
        st.h_req[:G] = prob.req
        st.h_cnt = np.zeros(st.Gp, np.int32)
        st.h_cnt[:G] = prob.cnt
        st.h_feas = np.zeros((st.Gp, st.Cp), bool)
        st.h_feas[:G, :C] = prob.feas
        st.h_alloc = np.zeros((st.Cp, st.R), np.float32)
        st.h_alloc[:C] = prob.alloc
        st.h_price = np.full(st.Cp, np.inf, np.float32)
        st.h_price[:C] = prob.price
        st.h_openable = np.zeros(st.Cp, bool)
        st.h_openable[:C] = prob.openable
        st.h_used0 = np.zeros((st.Kp, st.R), np.float32)
        st.h_used0[:E] = prob.used0
        st.h_npods0 = np.zeros(st.Kp, np.int32)
        st.h_npods0[:E] = prob.npods0
        st._device_seed()
        st.prob = prob
        st.last_delta_rows = 0
        return st

    def _device_seed(self) -> None:
        """Upload the mirrors once (the rebuild's one full transfer), plus
        the pack-time constants the plain shape never mutates (maxper=BIG,
        slot=0, sig0=0), and allocate the gather partners.  Every later
        tick reuses these allocations.  Each upload is a fresh allocation
        (never a view of a mirror), counted under ``resident_seed``.  On a
        mesh each buffer is placed by ``SHARD_SPECS``, the table the sharded
        pack reads; the partners are the replicated buffers' (each copy its
        own), and the delta step's slot edits run whole on the first data
        row (``_hub``)."""
        dev = self.device

        def upload(name: str, h: np.ndarray):
            if self.mesh is None:
                return OBSERVATORY.put("resident_seed", h, dev)
            return place(self.mesh, SHARD_SPECS[name], h, "resident_seed")

        E = len(self.live)
        cfg0 = np.full(self.Kp, -1, np.int32)
        cfg0[:E] = np.arange(self.fe, self.fe + E, dtype=np.int32)
        for name, h in (
            ("req", self.h_req), ("cnt", self.h_cnt), ("feas", self.h_feas),
            ("alloc", self.h_alloc), ("price", self.h_price), ("openable", self.h_openable),
            ("used0", self.h_used0), ("npods0", self.h_npods0), ("cfg0", cfg0),
            ("maxper", np.full(self.Gp, BIG, np.int32)), ("slot", np.zeros(self.Gp, np.int32)),
            ("sig0", np.zeros((2, self.Kp), np.int32)),  # Sp floor 2
        ):
            setattr(self, f"d_{name}", upload(name, h))
        if self.mesh is None:
            self.partner = {
                name: torch.empty_like(getattr(self, f"d_{name}"))
                for name in self._MUTABLE
            }
        else:
            dev = self._hub()
            self.partner = {
                (name, d): torch.empty_like(t)
                for name in self._ROWS for d, t in getattr(self, f"d_{name}").parts.items()
            }
        self.iota = torch.arange(self.Kp, dtype=torch.int32, device=dev)
        self.neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
        self.last_update = "seed"

    # the mutable buffers a delta edits row by row on every copy, and those
    # it edits by slot
    _ROWS = ("req", "cnt", "alloc", "price", "feas")
    _SLOTS = ("used0", "npods0")

    def _hub(self) -> torch.device:
        """Where a mesh state's slot edits run: the first data row's device."""
        return self.mesh.rows[0]

    def device_bytes(self) -> int:
        """Live device footprint of this state, gather partners included."""
        return sum(
            int(t.nbytes)  # a Sharded buffer: the bytes of every part
            for t in (
                self.d_req, self.d_cnt, self.d_feas, self.d_alloc,
                self.d_price, self.d_openable, self.d_used0, self.d_npods0,
                self.d_cfg0, self.d_maxper, self.d_slot, self.d_sig0,
                self.iota, self.neg1, *self.partner.values(),
            )
            if t is not None
        )

    # ------------------------------------------------------------ refresh
    def try_refresh(
        self, solver, pods: List[Pod], cat_key, live_new, node_fps,
        nodes_same: bool = False,
    ) -> bool:
        """Two-phase delta: PLAN validates eligibility and computes the
        permutations and scatters without touching any state (so a bail-out
        leaves the state coherent); APPLY edits the mirrors and replays the
        identical edit on the device.  cat_key / live_new / node_fps are the
        tick-wide invariants `ResidentCache.refresh` computed once for every
        candidate state.  ``nodes_same`` is the cache's tick-window
        attestation that THIS state's node columns were already refreshed
        against the identical live set inside the current trust window: the
        node half of the plan is then the identity."""
        plan = self._plan(solver, pods, cat_key, live_new, node_fps,
                          nodes_same)
        if plan is None:
            return False
        self._apply(plan, pods)
        return True

    def _plan(self, solver, pods: List[Pod], cat_key, live_new, node_fps,
              nodes_same: bool = False):
        if solver.device != self.device:
            return None  # tensors seeded on another device
        if solver.pack_fn is not self.pack_fn_ref:
            return None  # seeded for another pack backend (or mesh)
        if cat_key != self.cat_key:
            return None  # catalog roll / pool mutation: full rebuild
        # ---- live nodes --------------------------------------------------
        if nodes_same:
            # tick trust window (ResidentCache.note_sync): node columns are
            # bit-identical to this state's, so skip the per-node diff
            E_new = len(self.live)
            node_plan = None
        else:
            E_new = len(live_new)
            if self.fe + E_new + 1 > self.Cp:
                return None  # live-column bucket overflow
            node_plan = []  # (sn, old_pos_or_None, sched_ch, usage_ch, fps)
            names_new = set()
            for sn, (sched_fp, usage_fp) in zip(live_new, node_fps):
                if sn.name in names_new:
                    return None  # duplicate names would alias columns
                names_new.add(sn.name)
                old = self.node_pos.get(sn.name)
                if old is None:
                    sched_ch = usage_ch = True
                else:
                    prev_sched, prev_usage = self.node_fp[sn.name]
                    sched_ch = sched_fp != prev_sched
                    usage_ch = usage_fp != prev_usage
                node_plan.append(
                    (sn, old, sched_ch, usage_ch, sched_fp, usage_fp)
                )
        # ---- pods --------------------------------------------------------
        cur_ids = set()
        adds: List[Tuple[Pod, object]] = []
        drops: List[Tuple[Pod, object]] = []
        first_occ: Dict[object, int] = {}
        for i, p in enumerate(pods):
            pid = id(p)
            if pid in cur_ids:
                return None  # duplicate pod object
            cur_ids.add(pid)
            ent = self.pod_entry.get(pid)
            mut = p.__dict__.get("_mut", 0)
            if ent is not None and ent[1] == mut:
                ck = ent[2]
            else:
                if not _plain_pod(p):
                    return None
                ck = p.class_key()
                if ent is not None:
                    drops.append((p, ent[2]))
                adds.append((p, ck))
            if ck not in first_occ:
                first_occ[ck] = i
        for pid, ent in self.pod_entry.items():
            if pid not in cur_ids:
                drops.append((ent[0], ent[2]))
        churn = len(adds) + len(drops)
        if churn > REBUILD_FRACTION * max(len(pods), 1) + 8:
            return None  # past the midpoint a full compile is cheaper
        # ---- axis stability ---------------------------------------------
        # an arriving extended resource (or the departure of the only class
        # carrying one) changes the axis set, which re-shapes every tensor
        extra = dict(self.extra_axes)
        add_by_class: Dict[object, List[Pod]] = {}
        for p, ck in adds:
            add_by_class.setdefault(ck, []).append(p)
        drop_by_class: Dict[object, set] = {}
        for p, ck in drops:
            drop_by_class.setdefault(ck, set()).add(id(p))

        def class_extras(requests) -> list:
            return [
                ax for ax in requests.keys()
                if ax not in L.WELL_KNOWN_RESOURCES
            ]

        touched = set(add_by_class) | set(drop_by_class)
        survivors: List[Tuple[_Cls, List[Pod]]] = []  # (cls, new members)
        for c in self.cls:
            if c.key not in touched:
                survivors.append((c, c.cm.pods))
                continue
            dropset = drop_by_class.get(c.key, ())
            members = [p for p in c.cm.pods if id(p) not in dropset]
            members += add_by_class.pop(c.key, [])
            if members:
                survivors.append((c, members))
            else:
                for ax in class_extras(c.cm.requests):
                    extra[ax] -= 1
                    if extra[ax] == 0:
                        del extra[ax]
        fresh: List[Tuple[object, List[Pod]]] = []
        for ck, members in add_by_class.items():
            fresh.append((ck, members))
            for ax in class_extras(members[0].requests):
                if ax not in self.axes:
                    return None  # new axis: tensors re-shape
                extra[ax] = extra.get(ax, 0) + 1
        if set(extra) != set(self.extra_axes):
            # the axis SET must stay exactly the state's (a vanished axis
            # would make a from-scratch compile narrower than our tensors)
            return None
        G_new = len(survivors) + len(fresh)
        if G_new + 1 > self.Gp:
            return None  # class bucket overflow
        n_pods = len(pods)
        if E_new + min(n_pods, _SLOT_HEADROOM) + 1 > self.Kp:
            return None  # node-slot bucket overflow
        return dict(
            node_plan=node_plan,
            survivors=survivors,
            fresh=fresh,
            adds=adds,
            drops=drops,
            first_occ=first_occ,
            extra=extra,
            E_new=E_new,
        )

    def _apply(self, plan: dict, pods: List[Pod]) -> None:
        fe, Gp, Cp, Kp = self.fe, self.Gp, self.Cp, self.Kp
        first_occ = plan["first_occ"]
        # ---- new class order: exactly the from-scratch compile's -------
        # stable FFD sort over first-occurrence order == sort by the
        # (ffd key, first occurrence) pair, which is total per class
        entries: List[Tuple[tuple, int, Optional[_Cls], object, list]] = []
        old_pos = {id(c): g for g, c in enumerate(self.cls)}
        for c, members in plan["survivors"]:
            entries.append(
                (c.sort_key, first_occ[c.key], c, c.key, members)
            )
        for ck, members in plan["fresh"]:
            rep = members[0]
            cm = ClassMeta(
                pods=members,
                requests=rep.requests,
                signature=rep.constraint_signature(),
            )
            nc = _Cls(cm, ck, self.axes)
            entries.append((nc.sort_key, first_occ[ck], nc, ck, members))
        entries.sort(key=lambda e: (e[0], e[1]))

        g_perm = np.full(Gp, Gp - 1, np.int32)  # scratch = canonical pad
        class_scatter: List[int] = []
        new_cls: List[_Cls] = []
        meta_changed = False
        for gnew, (_, _, c, ck, members) in enumerate(entries):
            src = old_pos.get(id(c))
            if src is None:
                class_scatter.append(gnew)  # brand-new class
            else:
                g_perm[gnew] = src
                if len(members) != len(c.cm.pods):
                    class_scatter.append(gnew)  # count changed
            if members is not c.cm.pods:
                # REBIND a fresh ClassMeta rather than edit in place:
                # snapshots stored in the solver's compile cache share these
                # meta objects, and an in-place edit would desync a cached
                # problem's copied cnt from its class membership
                c.cm = replace(c.cm, pods=members)
                meta_changed = True
            new_cls.append(c)
        # ---- live-column order: the new snapshot's ----------------------
        node_plan = plan["node_plan"]
        E_new = plan["E_new"]
        if node_plan is None:
            # tick-window identity: same nodes, same order, same content
            c_perm = np.full(Cp, Cp - 1, np.int32)
            c_perm[: fe + E_new] = np.arange(fe + E_new, dtype=np.int32)
            k_perm = np.full(Kp, Kp - 1, np.int32)
            k_perm[:E_new] = np.arange(E_new, dtype=np.int32)
            col_scatter: List[int] = []
            used_scatter: List[int] = []
            live_new = self.live
            configs_new = self.configs_live
            identity_c = True
        else:
            c_perm = np.full(Cp, Cp - 1, np.int32)
            c_perm[:fe] = np.arange(fe, dtype=np.int32)
            k_perm = np.full(Kp, Kp - 1, np.int32)
            col_scatter = []  # NEW-order positions e
            used_scatter = []
            live_new = []
            configs_new = []
            for e, (sn, old, sched_ch, usage_ch, _, _) in enumerate(node_plan):
                if old is not None:
                    c_perm[fe + e] = fe + old
                    k_perm[e] = old
                if sched_ch:
                    col_scatter.append(e)
                if usage_ch:
                    used_scatter.append(e)
                live_new.append(sn)
                if old is not None and not sched_ch:
                    # same column, same content: reuse the wrapper when it
                    # still wraps this very node object, else re-point
                    # `existing` on a fresh ConfigMeta (older snapshots keep
                    # the wrapper they compiled against; content-equal
                    # wrappers are interchangeable)
                    prev = self.configs_live[old]
                    configs_new.append(
                        prev if prev.existing is sn
                        else replace(prev, existing=sn)
                    )
                else:
                    configs_new.append(
                        ConfigMeta(
                            pool=None,
                            instance_type=None,
                            zone=sn.zone,
                            capacity_type=sn.capacity_type,
                            price=0.0,
                            existing=sn,
                        )
                    )
            identity_c = bool(
                (c_perm[fe : fe + E_new] ==
                 np.arange(fe, fe + E_new)).all()
            ) and E_new == len(self.live)
        identity_g = bool((g_perm[: len(entries)] ==
                           np.arange(len(entries))).all()) and len(
            entries
        ) == len(self.cls)
        # ---- host mirror: permutations ----------------------------------
        if not (identity_g and identity_c):
            self.h_req = self.h_req[g_perm]
            self.h_cnt = self.h_cnt[g_perm]
            self.h_feas = self.h_feas[g_perm][:, c_perm]
            self.h_alloc = self.h_alloc[c_perm]
            self.h_price = self.h_price[c_perm]
            self.h_used0 = self.h_used0[k_perm]
            self.h_npods0 = self.h_npods0[k_perm]
        G_new = len(entries)
        # ---- host mirror: class-row scatters ----------------------------
        catalog = self.catalog
        for gnew in class_scatter:
            c = new_cls[gnew]
            cm = c.cm
            self.h_req[gnew] = c.req_vec
            self.h_cnt[gnew] = len(cm.pods)
            if g_perm[gnew] == Gp - 1:  # brand-new: assemble the full row
                rep = cm.pods[0]
                open_row = open_config_row(
                    catalog, rep, cm.signature, self.pools_by_name
                )
                open_row = restrict_open_tier(catalog, open_row, c.req_vec)
                row = np.zeros(Cp, bool)
                row[:fe] = open_row
                for e, sn in enumerate(live_new):
                    row[fe + e] = _fits_existing(rep, c.sched, sn)
                self.h_feas[gnew] = row
        # ---- host mirror: live-column scatters --------------------------
        for e in col_scatter:
            sn = live_new[e]
            col = fe + e
            self.h_alloc[col] = _vec(sn.allocatable, self.axes)
            self.h_price[col] = 0.0
            for g in range(G_new):
                self.h_feas[g, col] = _fits_existing(
                    new_cls[g].cm.pods[0], new_cls[g].sched, sn
                )
            self.h_feas[G_new:, col] = False
        for e in used_scatter:
            sn = live_new[e]
            self.h_used0[e] = _vec(sn.used, self.axes)
            self.h_npods0[e] = len(sn.pods)
        # ---- device: one gather + scatter step --------------------------
        n_delta = len(class_scatter) + len(col_scatter) + len(used_scatter)
        if n_delta or not (identity_g and identity_c):
            self._delta_step(
                g_perm, c_perm, k_perm,
                _pad_idx(class_scatter, Gp - 1),
                _pad_idx([fe + e for e in col_scatter], Cp - 1),
                _pad_idx(used_scatter, Kp - 1),
                E_new,
            )
            self.last_update = "donated"
        else:
            self.last_update = "noop"
        # ---- bookkeeping -------------------------------------------------
        self.cls = new_cls
        self.slot_of = {c.key: g for g, c in enumerate(new_cls)}
        for p, ck in plan["drops"]:
            self.pod_entry.pop(id(p), None)
        for p, ck in plan["adds"]:
            self.pod_entry[id(p)] = (p, p.__dict__.get("_mut", 0), ck)
        self.extra_axes = plan["extra"]
        if node_plan is not None:
            self.live = live_new
            self.configs_live = configs_new
            self.node_pos = {sn.name: e for e, sn in enumerate(live_new)}
            self.node_fp = {
                sn.name: (fp_s, fp_u)
                for (sn, _, _, _, fp_s, fp_u) in node_plan
            }
        self.last_delta_rows = n_delta
        # meta_changed alone (an equal-count membership swap) produces no
        # tensor delta but DOES change which pod objects decode assigns:
        # the snapshot must refresh for it too
        self.prob = self._snapshot() if meta_changed or n_delta or not (
            identity_g and identity_c
        ) else self.prob

    def _delta_step(self, g_perm, c_perm, k_perm, g_idx, col_idx, k_idx,
                    e_new: int) -> None:
        """Replay the host edit on the device tensors, the arithmetic of the
        reference's ``_delta_fn.step``.  Host to device travel only the
        permutations and the scatter payloads (read from the FINAL host
        mirrors, so the row/column overlap cells agree by construction),
        packed into one int32, one float32 and one bool array."""
        dev = self.device
        h_ints = np.concatenate(
            [g_perm, c_perm, k_perm, g_idx, col_idx, k_idx,
             self.h_cnt[g_idx], self.h_npods0[k_idx]]
        )
        h_f32 = np.concatenate(
            [self.h_req[g_idx].ravel(), self.h_alloc[col_idx].ravel(),
             self.h_price[col_idx], self.h_used0[k_idx].ravel()]
        )
        h_bool = np.concatenate(
            [self.h_feas[g_idx].ravel(), self.h_feas[:, col_idx].ravel()]
        )
        sizes = (len(g_perm), len(c_perm), len(k_perm),
                 len(g_idx), len(col_idx), len(k_idx))
        if self.mesh is None:
            ints, f32, bools = (
                OBSERVATORY.put("resident_delta", a, dev)
                for a in (h_ints, h_f32, h_bool)
            )
            OBSERVATORY.dispatch(
                "resident_delta", self._delta_apply, ints, f32, bools, sizes,
                e_new,
            )
            return
        # a mesh: the payloads go to every device that holds a copy
        payloads = {
            d: tuple(OBSERVATORY.put("resident_delta", a, d) for a in (h_ints, h_f32, h_bool))
            for d in self.mesh.distinct()
        }
        OBSERVATORY.dispatch(
            "resident_delta", self._delta_apply_mesh, payloads, sizes, e_new,
        )

    def _unpack(self, ints, f32, bools, sizes) -> dict:
        """The uploaded payloads split into the step's indices and rows."""
        n_idx = sum(sizes)
        ng, nc, nk = sizes[3:]
        # index_select / index_copy_ take int64 indices: convert the index
        # half of the int32 upload on the device, never the payloads
        gp, cp, kp, gi, ci, ki = ints[:n_idx].long().split(sizes)
        g_cnt, k_np = ints[n_idx:].split([ng, nk])
        R = self.R
        g_req, col_alloc, col_price, k_used = f32.split(
            [ng * R, nc * R, nc, nk * R]
        )
        g_feas, col_feas = bools.split([ng * self.Cp, self.Gp * nc])
        return dict(
            gp=gp, cp=cp, kp=kp, gi=gi, ci=ci, ki=ki, g_cnt=g_cnt, k_np=k_np,
            g_req=g_req.view(ng, R), col_alloc=col_alloc.view(nc, R),
            col_price=col_price, k_used=k_used.view(-1, R),
            g_feas=g_feas.view(ng, self.Cp), col_feas=col_feas.view(self.Gp, nc),
        )

    @staticmethod
    def _edit_rows(cur: dict, partner: dict, u: dict) -> None:
        """The class-row and live-column edits on one copy of the buffers
        (``cur``: name -> tensor, swapped with ``partner`` in place).
        1) permutations: class rows compact/insert to the new FFD order,
        live columns follow the new snapshot order; fresh and vacated
        positions gather from the reserved scratch slot, which permanently
        holds canonical pad values.  Each gather writes the partner buffer,
        which then swaps with the live one; feas takes its class
        permutation into the partner and its column permutation back into
        its own buffer.  2) scatters in place: class rows, then live
        columns.  Padded index entries all name the scratch slot; on CUDA,
        index_copy_ writes duplicate indices in no fixed order, which is
        bit-safe only because every padded payload entry holds the same
        canonical pad value (the scratch slot's own)."""
        for name, perm in (("req", u["gp"]), ("cnt", u["gp"]), ("alloc", u["cp"]),
                           ("price", u["cp"])):
            torch.index_select(cur[name], 0, perm, out=partner[name])
            cur[name], partner[name] = partner[name], cur[name]
        torch.index_select(cur["feas"], 0, u["gp"], out=partner["feas"])
        torch.index_select(partner["feas"], 1, u["cp"], out=cur["feas"])
        cur["req"].index_copy_(0, u["gi"], u["g_req"])
        cur["cnt"].index_copy_(0, u["gi"], u["g_cnt"])
        cur["feas"].index_copy_(0, u["gi"], u["g_feas"])
        cur["alloc"].index_copy_(0, u["ci"], u["col_alloc"])
        cur["price"].index_copy_(0, u["ci"], u["col_price"])
        cur["feas"].index_copy_(1, u["ci"], u["col_feas"])

    @staticmethod
    def _edit_slots(cur: dict, partner: dict, u: dict) -> None:
        """The slot edits (the node-slot permutation, then the changed
        slots' rows), as `_edit_rows` does them."""
        for name in ("used0", "npods0"):
            torch.index_select(cur[name], 0, u["kp"], out=partner[name])
            cur[name], partner[name] = partner[name], cur[name]
        cur["used0"].index_copy_(0, u["ki"], u["k_used"])
        cur["npods0"].index_copy_(0, u["ki"], u["k_np"])

    def _delta_apply(self, ints, f32, bools, sizes, e_new: int) -> None:
        """The device half of `_delta_step`: the gathers into the partner
        buffers and the scatters of the uploaded payloads."""
        u = self._unpack(ints, f32, bools, sizes)
        cur = {name: getattr(self, f"d_{name}") for name in self._MUTABLE}
        self._edit_rows(cur, self.partner, u)
        self._edit_slots(cur, self.partner, u)
        for name in self._MUTABLE:
            setattr(self, f"d_{name}", cur[name])
        # 3) the live slots' configs: where(iota < e_new, fe + iota, -1)
        torch.where(self.iota < e_new, self.iota + self.fe, self.neg1,
                    out=self.d_cfg0)

    def _delta_apply_mesh(self, payloads: dict, sizes, e_new: int) -> None:
        """`_delta_apply` on a mesh: the row edits on each device's copy of
        the replicated buffers, then the slot edits on the whole slot
        buffers, gathered to the first data row and split back (the node-slot
        permutation moves slots ACROSS data rows; each slice is one counted
        exchange under ``resident_reshard``: 2 x Kp x (R + 2) x 4 bytes a
        delta)."""
        for dev, (ints, f32, bools) in payloads.items():
            u = self._unpack(ints, f32, bools, sizes)
            cur = {name: getattr(self, f"d_{name}").parts[dev] for name in self._ROWS}
            partner = {name: self.partner[(name, dev)] for name in self._ROWS}
            self._edit_rows(cur, partner, u)
            for name in self._ROWS:
                getattr(self, f"d_{name}").parts[dev] = cur[name]
                self.partner[(name, dev)] = partner[name]
        hub = self._hub()
        u = self._unpack(*payloads[hub], sizes)
        site = "resident_reshard"
        cur = {name: getattr(self, f"d_{name}").gather(hub, site) for name in self._SLOTS}
        partner = {name: torch.empty_like(t) for name, t in cur.items()}
        self._edit_slots(cur, partner, u)
        for name in self._SLOTS:
            getattr(self, f"d_{name}").scatter(cur[name], site)
        cfg0 = torch.where(self.iota < e_new, self.iota + self.fe, self.neg1)
        self.d_cfg0.scatter(cfg0, site)

    # ----------------------------------------------------------- snapshot
    def _snapshot(self) -> CompiledProblem:
        """A CompiledProblem over COPIES of the unpadded mirror regions:
        decode (and its lazy widen thunks) and the compile cache keep it
        while later deltas edit the mirrors in place."""
        G = len(self.cls)
        E = len(self.live)
        C = self.fe + E
        return CompiledProblem(
            axes=self.axes,
            classes=[c.cm for c in self.cls],
            configs=list(self.catalog.configs) + list(self.configs_live),
            req=self.h_req[:G].copy(),
            cnt=self.h_cnt[:G].copy(),
            maxper=np.full(G, BIG, np.int32),
            slot=np.zeros(G, np.int32),
            alloc=self.h_alloc[:C].copy(),
            price=self.h_price[:C].copy(),
            openable=self.h_openable[:C].copy(),
            feas=self.h_feas[:G, :C].copy(),
            pool_daemon_overhead=self.catalog.pool_overhead,
            used0=self.h_used0[:E].copy(),
            cfg0=np.arange(self.fe, self.fe + E, dtype=np.int32),
            npods0=self.h_npods0[:E].copy(),
            sig_used0=np.zeros((1, E), np.int32),
            n_track_slots=1,
        )

    def problem(self) -> CompiledProblem:
        if self.prob is None:
            self.prob = self._snapshot()
        return self.prob

    def groups(self) -> list:
        """partition_groups-shaped (key, members) list for the solver's
        compile-cache entry (resident batches never have an oracle half)."""
        return [
            ((c.cm.signature, c.cm.requests), list(c.cm.pods))
            for c in self.cls
        ]

    # ---------------------------------------------------------------- pack
    def pack(self, prob, k_slots: int = 0, objective: str = "nodes"):
        """A pack over the RESIDENT tensors: no per-solve upload (only the
        first free slot travels, as a launch argument).  An explicit
        k_slots (the solver's overflow retry) falls back to the ordinary
        upload path over the snapshot problem."""
        if k_slots and k_slots != self.Kp:
            return self._fallback_pack(prob, k_slots, objective)
        return self._device_pack(objective)

    def pack_args(self) -> tuple:
        """The pack's positional arguments over the resident tensors, the
        first free slot (the live node count) as a host int."""
        return (
            self.d_req, self.d_cnt, self.d_maxper, self.d_slot,
            self.d_feas, self.d_alloc, self.d_price, self.d_openable,
            self.d_used0, self.d_cfg0, self.d_npods0, len(self.live),
            self.d_sig0,
        )

    def _device_pack(self, objective: str):
        """`choose_config` and the scan its shapes pick, launched on the
        resident tensors (their plain version for a CPU state); on a mesh
        the sharded pack over the placed buffers.  A launch that fails
        raises, as the cold path's does."""
        if self.mesh is not None:
            from karpenter_tpu_torch.parallel.mesh import sharded_pack

            return OBSERVATORY.dispatch(
                "mesh_pack", sharded_pack, self.mesh, *self.pack_args(),
                k_slots=self.Kp, objective=objective,
            )
        from karpenter_tpu_torch.ops.fused_packer import ffd_pack

        return OBSERVATORY.dispatch(
            "ffd_pack", ffd_pack, *self.pack_args(), objective=objective
        )

    def _fallback_pack(self, prob, k_slots: int, objective: str):
        if self.mesh is not None:
            return self.pack_fn_ref(prob, k_slots, objective)
        return dispatch_pack(prob, k_slots, objective, self.device)


# distinguishes "caller did not pass a window" from "caller validated and
# found no window" in ResidentCache.refresh
_WIN_UNSET = object()


class ResidentCache:
    """A small LRU of resident states (a provisioner's pending set and a
    deprovisioner's universes alternate on one scheduler; two slots keep
    both warm without letting device buffers accumulate)."""

    CAP = 2

    def __init__(self):
        self.states: List[ResidentState] = []
        # open tick trust window (note_sync): (witness, token, carrier_ok,
        # cat_key, live_new, node_fps) or None
        self._tick = None

    def note_sync(self, solver) -> None:
        """Open a tick trust window: compute the tick-wide invariants
        (carrier scan, live filter, per-node fingerprints, catalog key) ONCE
        for the solver's current ``existing`` snapshot, so every refresh
        inside the window skips the O(cluster) rescan.  The caller's
        contract is that ``existing`` and its nodes are NOT mutated inside
        the window; re-sync after any mutation.  The window
        self-invalidates when the node set changes (the witness: a saved
        list compared with ``==``, identity first per element, then field
        value).  Callers that never note_sync keep the per-call scan,
        including in-place node mutation detection."""
        witness = (id(solver), list(solver.existing))
        carrier_ok = _carrier_free(solver.existing)
        live_new = live_filter(solver.existing)
        node_fps = [
            (_node_sched_fp(sn), _node_usage_fp(sn)) for sn in live_new
        ]
        self._tick = (
            witness, object(), carrier_ok, _catalog_key(solver),
            live_new, node_fps,
        )

    def _window(self, solver):
        """The open trust window's payload when its witness still matches
        this solver's existing snapshot, else None."""
        t = self._tick
        if (
            t is not None
            and t[0][0] == id(solver)
            and t[0][1] == solver.existing
        ):
            return t
        return None

    def carrier_free(self, solver) -> bool:
        t = self._window(solver)
        if t is not None:
            return t[2]
        return _carrier_free(solver.existing)

    def catalog_key(self, solver):
        t = self._window(solver)
        if t is not None:
            return t[3]
        return _catalog_key(solver)

    def refresh(
        self, solver, pods: List[Pod], _win=_WIN_UNSET
    ) -> Optional[ResidentState]:
        """Delta-update the first state that can absorb this tick's diff;
        None when every state misses (the caller runs the full compile and
        seeds a state via `rebuild`).  ``_win`` lets a caller that already
        validated the trust window hand it over."""
        if not self.states or not resident_capable(solver.pack_fn):
            return None  # a sidecar's pack_fn keeps the plain upload path
        # tick-wide invariants, identical for every candidate state: built
        # once per call (and, under an open trust window, once per tick)
        win = self._window(solver) if _win is _WIN_UNSET else _win
        if win is not None:
            _, token, carrier_ok, cat_key, live_new, node_fps = win
        else:
            token = None
            carrier_ok = _carrier_free(solver.existing)
            cat_key = _catalog_key(solver)
            live_new = live_filter(solver.existing)
            node_fps = [
                (_node_sched_fp(sn), _node_usage_fp(sn)) for sn in live_new
            ]
        if not carrier_ok:
            # a carrier appeared, possibly on a NON-live node the live
            # filter hides (a cordoned node's bound anti term still repels
            # batch pods in the full compile's partition)
            return None
        for st in list(self.states):
            nodes_same = token is not None and st.tick_token is token
            if st.try_refresh(
                solver, pods, cat_key, live_new, node_fps, nodes_same
            ):
                st.tick_token = token
                # "donated" (a delta that reused the resident buffers)
                # or "noop"
                OBSERVATORY.count_resident_update(st.last_update)
                self.states.remove(st)
                self.states.append(st)  # most-recently-used last
                return st
        return None

    def rebuild(
        self, solver, pods: List[Pod], prob: CompiledProblem, catalog,
        consumer: str = "solve",
    ) -> Optional[ResidentState]:
        # resident tensors serve only the in-process packs: a sidecar's (or
        # any custom) pack_fn keeps the plain upload path
        if catalog is None or not resident_capable(solver.pack_fn):
            return None
        with phase("delta"):
            st = ResidentState.build(
                solver, pods, prob, catalog, consumer=consumer
            )
        if st is None:
            return None
        while len(self.states) >= self.CAP:
            self.states.pop(0)
        self.states.append(st)
        OBSERVATORY.count_resident_update("seed")
        self._report_footprint()
        return st

    def footprint(self) -> Dict[str, int]:
        """Live device bytes per consumer across the cache's states."""
        out: Dict[str, int] = {}
        for st in self.states:
            out[st.consumer] = out.get(st.consumer, 0) + st.device_bytes()
        return out

    def _report_footprint(self) -> None:
        OBSERVATORY.set_resident_footprint(self, self.footprint())

    def match(self, prob: CompiledProblem, device=None, pack_fn=None) -> Optional[ResidentState]:
        """The state whose CURRENT snapshot is exactly `prob` (identity): a
        compile-cache hit re-serving that snapshot may pack straight from
        the resident tensors with no delta at all.  ``device`` and
        ``pack_fn`` fence against a state seeded on another device or for
        another pack backend."""
        for st in self.states:
            if (st.prob is prob and (device is None or st.device == device)
                    and st.pack_fn_ref is pack_fn):
                return st
        return None


# ---------------------------------------------------------------------------
# Tenant-keyed resident pool (the multi-tenant solver service)
#
# ResidentCache above keeps two states warm for one operator.  The
# multi-tenant SolverServer generalizes the same discipline across a fleet:
# each tenant's upload-heavy solve tensors stay on the device between its
# solves, keyed by CONTENT fingerprint (the wire arrays are fresh numpy
# objects every RPC, so identity keys can never hit).  A global device-bytes
# budget bounds the footprint; crossing it evicts whole tenants least
# recently used first, never a tenant currently being served.
# ---------------------------------------------------------------------------


def _content_fp(arr: np.ndarray) -> tuple:
    """Content fingerprint of a wire array: shape + dtype + payload hash.
    sha1 over the raw bytes: collision-safe at cache-key strength, and
    cheap next to the device upload it saves."""
    import hashlib

    arr = np.ascontiguousarray(arr)
    return (
        arr.shape,
        arr.dtype.str,
        hashlib.sha1(arr.tobytes()).digest(),
    )


class _TenantEntry:
    """One tenant's resident tensors: name -> (fingerprint, device tensor,
    nbytes).  The numpy source is not kept: the fingerprint is content
    based, so a re-sent identical array hits without it."""

    __slots__ = ("arrays", "nbytes")

    def __init__(self):
        self.arrays: Dict[str, tuple] = {}
        self.nbytes = 0


class TenantResidentPool:
    """Device-resident per-tenant tensor cache with a global bytes budget.

    ``get(tenant, name, arr)`` returns a tensor on ``device`` (the card
    unless the caller asks for the CPU) for ``arr``: a fingerprint hit
    reuses the resident tensor (zero transfer), a miss uploads through the
    observatory's counted seam under ``site`` and replaces the tenant's
    entry for ``name``.  ``budget_bytes <= 0`` disables caching entirely
    (every get returns the host array untouched: the legacy single-tenant
    upload path).  Eviction is tenant-granular LRU: python dicts iterate in
    insertion order and hits re-insert.  NOT thread-safe: the service
    serializes access under its own lock.
    """

    def __init__(
        self, budget_bytes: int, site: str = "tenant_resident", device=None,
    ):
        self.budget_bytes = int(budget_bytes)
        self.site = site
        self.device = resolve_device(device)
        self.tenants: Dict[str, _TenantEntry] = {}
        # lifetime counters the service exports per tenant
        self.hits = 0
        self.misses = 0
        self.evictions: List[str] = []  # evicted tenant names, in order

    # ------------------------------------------------------------- access
    def get(self, tenant: str, name: str, arr: np.ndarray):
        if self.budget_bytes <= 0:
            return arr
        ent = self.tenants.get(tenant)
        if ent is None:
            ent = self.tenants[tenant] = _TenantEntry()
        else:
            # mark most-recently-used (insertion-order LRU)
            del self.tenants[tenant]
            self.tenants[tenant] = ent
        fp = _content_fp(arr)
        cached = ent.arrays.get(name)
        if cached is not None and cached[0] == fp:
            self.hits += 1
            return cached[1]
        self.misses += 1
        dev = OBSERVATORY.put(self.site, np.ascontiguousarray(arr), self.device)
        nbytes = int(dev.numel() * dev.element_size())
        if cached is not None:
            ent.nbytes -= cached[2]
        ent.arrays[name] = (fp, dev, nbytes)
        ent.nbytes += nbytes
        self.evict_to_budget(active={tenant})
        return dev

    # ----------------------------------------------------------- eviction
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.tenants.values())

    def bytes_of(self, tenant: str) -> int:
        ent = self.tenants.get(tenant)
        return ent.nbytes if ent is not None else 0

    def evict_to_budget(self, active=()) -> List[str]:
        """Drop least-recently-used tenants until the pool fits the budget;
        tenants in ``active`` (being served) are never dropped, so a single
        oversized tenant can transiently exceed the budget rather than
        thrash its own working set mid-solve.  Returns the tenant names
        evicted by this call (also appended to ``self.evictions`` for the
        service's counters)."""
        dropped: List[str] = []
        while self.total_bytes() > self.budget_bytes:
            victim = next(
                (t for t in self.tenants if t not in active), None
            )
            if victim is None:
                break
            del self.tenants[victim]
            dropped.append(victim)
        self.evictions.extend(dropped)
        return dropped

    def drop(self, tenant: str) -> None:
        self.tenants.pop(tenant, None)

    # ---------------------------------------------------------- reporting
    def footprint(self) -> Dict[str, int]:
        """Per-tenant resident bytes: the karpenter_service_resident_bytes
        truth, and the consumer-labeled observatory report."""
        return {t: e.nbytes for t, e in self.tenants.items()}

    def report_footprint(self) -> None:
        OBSERVATORY.set_resident_footprint(
            self, {f"tenant:{t}": b for t, b in self.footprint().items()}
        )
