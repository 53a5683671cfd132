"""Multi-tenant solver service: one card serving a fleet.

Port of ``karpenter_tpu/service/server.py``.  The controller half (pure
Python: providers, reconcilers, constraint compilation) can live anywhere;
the solver half owns the device (the card unless ``device="cpu"`` is asked
for) and serves `pack` over a length-prefixed socket protocol
(service/codec.py).

Nothing forces one solver process per cluster — the expensive half is
behind a plugin boundary, so ONE SolverService can serve a fleet of
operators (docs/designs/solver-service.md).  Four planes make that safe:

- **per-tenant resident state**: each tenant's solve tensors stay
  device-resident between its solves (ops/resident.TenantResidentPool),
  content-fingerprinted so a re-sent identical array uploads nothing,
  under a global device-bytes budget with cross-tenant LRU eviction;
- **cross-tenant batching**: solves arriving while the device is busy
  (or within the CoalesceWindow) stack into ONE fleet pack
  (ops/fused_packer.fleet_pack: one launch of each kernel for the whole
  batch) with per-tenant decode fan-out; a lone RPC hitting an idle group
  falls through to the solo pack (`ffd_pack`) immediately and never waits
  out the window;
- **admission and fairness**: per-tenant in-flight caps and a
  weighted-round-robin drain (batcher/core.WeightedRoundRobin) bound a
  noisy tenant's share; a saturated queue refuses EXPLICITLY with a
  retry-after hint — never silent queuing;
- **tenant-scoped observability**: every karpenter_service_* family
  carries a ``tenant`` label (lint rule 12 enforces it), the ledger
  records tenant-attributed batch/refusal/eviction events, the flight
  recorder snapshots per-dispatch ticks, and ``/debug/tenants`` on the
  telemetry port serves the per-tenant admission/resident state.

Methods:
- ``ping``                      liveness
- ``info``                      device inventory (platform, device count)
- ``pack``  arrays + {k_slots, objective, tenant?, ctx?} -> PackResult
            arrays, or {status: "retry", retry_after_s} under
            backpressure

Legacy posture: ``multi_tenant=False`` (the default, and the chart's
default) serves exactly the single-operator sidecar contract — no
batching, no admission, no resident pool.

What differs from the reference is the device seam alone: the wire arrays
go up through the device observatory's counted `put` (``ops/packer.py:
to_device``) under the reference's site names, the solo pack is the
port's `ffd_pack`, the batch its `fleet_pack` at the true batch size (the
reference pads B to a power of two for XLA's compile cache, which the
port does not have), and ``info`` reports torch's device.  A fleet pack
that fails raises to every tenant of the batch; nothing falls back.

    python -m karpenter_tpu_torch.service.server --device cuda --port 7421
"""

from __future__ import annotations

import logging
import signal
import socket
import socketserver
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.obs.context import current_trace_id, trace_context
from karpenter_tpu_torch.obs.events import EventLedger
from karpenter_tpu_torch.obs.flight import FlightRecorder
from karpenter_tpu_torch.ops.packer import resolve_device
from karpenter_tpu_torch.service.codec import decode, encode, recv_frame, send_frame
from karpenter_tpu_torch.utils.locks import make_condition, make_lock
from karpenter_tpu_torch.utils.trace import Tracer

log = logging.getLogger(__name__)

PACK_ARG_ORDER = (
    "req", "cnt", "maxper", "slot", "feas", "alloc", "price", "openable",
    "used0", "cfg0", "npods0", "next0", "sig0",
)
PACK_RESULT_FIELDS = ("take", "leftover", "node_cfg", "node_pods", "node_used")
_NEXT0_IDX = PACK_ARG_ORDER.index("next0")

DEFAULT_TENANT = "default"
# fleet-pack rows per dispatch (the reference's bound, kept: it also bounds
# one tenant group's share of a drain)
MAX_BATCH = 16
# total queued solves (across every tenant and group) before admission
# refuses outright — the mesh is saturated and honest backpressure beats
# unbounded queueing (reference: never let a queue hide an outage)
SATURATION_QUEUED = 64


def _b_bucket(n: int) -> int:
    """The reference's batch-axis bucket, the next power of two (1, 2, 4, 8,
    16).  The port launches at the true B and does not pad; kept for the
    reference's name and its readers."""
    return 1 << max(n - 1, 0).bit_length()


def solve_group_key(args, k_slots: int, objective: str) -> tuple:
    """The group a multi-tenant solve joins: solves of one key stack into
    one fleet pack (the statics, and every wire array's shape and dtype but
    next0's)."""
    return (k_slots, objective) + tuple(
        (tuple(np.shape(a)), np.asarray(a).dtype.str)
        for i, a in enumerate(args)
        if i != _NEXT0_IDX
    )


class _Pending:
    """One queued solve awaiting a fleet dispatch."""

    __slots__ = ("tenant", "args", "k_slots", "objective", "future")

    def __init__(self, tenant, args, k_slots, objective):
        self.tenant = tenant
        self.args = args
        self.k_slots = k_slots
        self.objective = objective
        self.future: Future = Future()


class _SolveGroup:
    """Solves that can stack into one fleet dispatch: same padded bucket
    shapes, same (k_slots, objective) statics."""

    __slots__ = ("key", "queues", "window", "busy", "worker", "waited")

    def __init__(self, key, idle_s: float, max_s: float):
        from karpenter_tpu_torch.batcher.core import CoalesceWindow

        self.key = key
        self.queues: Dict[str, deque] = {}
        self.window = CoalesceWindow(idle_s, max_s)
        self.busy = False  # a solo or fleet dispatch is on the device
        self.worker: Optional[threading.Thread] = None
        # True when a queued item arrived while the device was busy: the
        # window exists to coalesce DURING a dispatch, so once the device
        # frees, waiting any longer is pure added latency
        self.waited = False

    def depth(self) -> int:
        return sum(len(q) for q in self.queues.values())


class _TenantStats:
    __slots__ = ("name", "inflight", "solves", "batched", "refused",
                 "last_ts")

    def __init__(self, name: str):
        self.name = name
        self.inflight = 0
        self.solves = 0
        self.batched = 0
        self.refused = 0
        self.last_ts = 0.0


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: "SolverServer" = self.server  # type: ignore[assignment]
        # tracked so stop() can sever this connection: daemon handler
        # threads otherwise outlive shutdown() and keep answering with
        # pre-stop state (the zombie-handler bug the store fixed first)
        server.track_conn(self.request)
        try:
            self._serve(server)
        finally:
            server.untrack_conn(self.request)

    def _serve(self, server: "SolverServer") -> None:
        while True:
            try:
                payload = recv_frame(self.request)
            except (ConnectionError, OSError):
                return
            except ValueError as exc:  # garbage/oversized frame: close clean
                log.warning("dropping malformed frame: %s", exc)
                return
            try:
                response = server.dispatch(payload)
            except Exception as exc:  # report, keep serving
                log.exception("solver request failed")
                response = encode({"status": "error", "error": str(exc)}, {})
            try:
                send_frame(self.request, response)
            except (ConnectionError, OSError):
                return


class SolverServer(socketserver.ThreadingTCPServer):
    """Serve solves on (host, port); port 0 picks a free port.

    ``multi_tenant=True`` turns on the fleet posture: per-tenant resident
    pooling, cross-tenant batching, admission caps, WRR fairness and
    backpressure.  Off (the default), every knob is inert and the wire
    contract is exactly the legacy single-operator sidecar's.  ``device``
    is where every solve runs: the card unless the caller asks for the
    CPU (the plain version).
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        multi_tenant: bool = False,
        batch_idle_s: float = 0.005,
        batch_max_s: float = 0.05,
        inflight_cap: int = 4,
        resident_budget_mb: int = 256,
        device=None,
    ):
        # before the socket binds: no card means no server
        self.device = resolve_device(device)
        super().__init__((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None
        self.multi_tenant = bool(multi_tenant)
        self.batch_idle_s = float(batch_idle_s)
        self.batch_max_s = float(batch_max_s)
        self.inflight_cap = int(inflight_cap)
        # float MB so a sub-MB budget (tiny meshes, tests) stays exact
        self.resident_budget_mb = float(resident_budget_mb)
        # the serving process's OWN observability surface (the store
        # server's posture): request counters + handling spans recorded
        # under each client's trace ID, a tenant-attributed event ledger,
        # and a flight ring snapshotting hist deltas per dispatch
        self.registry = Registry()
        self.tracer = Tracer(enabled=True)
        self.ledger = EventLedger(registry=self.registry)
        self.registry.ledger = self.ledger
        self.flight = FlightRecorder(
            self.ledger.clock, self.registry, ledger=self.ledger,
            tracer=self.tracer,
        )
        self._flight_seq = 0
        # established handler connections, severed by stop()
        self._conns: set = set()
        self._conns_lock = make_lock("SolverServer._conns_lock")
        # admission plane: ONE condition guards tenants/groups/queues
        self._cv = make_condition("SolverServer._cv")
        self._tenants: Dict[str, _TenantStats] = {}
        self._groups: Dict[tuple, _SolveGroup] = {}
        from karpenter_tpu_torch.batcher.core import WeightedRoundRobin

        self._wrr = WeightedRoundRobin()
        self.tenant_weights: Dict[str, float] = {}
        # per-tenant device-resident arrays, budgeted (ops/resident.py);
        # its own lock — never held together with _cv
        from karpenter_tpu_torch.ops.resident import TenantResidentPool

        self._pool = TenantResidentPool(
            self.resident_budget_mb * (1 << 20) if multi_tenant else 0,
            device=self.device,
        )
        self._pool_lock = make_lock("SolverServer._pool_lock")

    @classmethod
    def from_settings(
        cls, settings, host: str = "127.0.0.1", port: int = 7421, device=None,
    ) -> "SolverServer":
        """Build from the chart-rendered Settings (api/settings.py):
        the service.multiTenant.* values land here via the configmap."""
        return cls(
            host=host,
            port=port,
            device=device,
            multi_tenant=settings.service_multi_tenant,
            batch_idle_s=settings.service_batch_idle_s,
            batch_max_s=settings.service_batch_max_s,
            inflight_cap=settings.service_tenant_inflight_cap,
            resident_budget_mb=settings.service_resident_budget_mb,
        )

    # ------------------------------------------------------------- dispatch
    def dispatch(self, payload: bytes) -> bytes:
        header, arrays = decode(payload)
        method = str(header.get("method"))
        tenant = str(header.get("tenant") or DEFAULT_TENANT)
        # adopt the CLIENT's trace context for the handling span: the
        # server's span log records this RPC under the caller's tick
        # trace ID, stitching the two processes' timelines (the store
        # server has done this since the telemetry split; the solver's
        # spans used to record under their own IDs, breaking
        # cross-process tick timelines)
        ctx = header.get("ctx") or {}
        t0 = time.perf_counter()
        self.registry.inc(
            "karpenter_service_requests_total",
            {"tenant": tenant, "method": method},
        )
        with trace_context(ctx.get("trace_id", "")), \
                self.tracer.span(f"solver.{method}", tenant=tenant):
            if method == "ping":
                return encode({"status": "ok"}, {})
            if method == "info":
                # the device the solves run on: the card's platform and
                # torch.cuda.device_count(), or the host as one CPU device
                cuda = self.device.type == "cuda"
                return encode(
                    {
                        "status": "ok",
                        "platform": self.device.type,
                        "device_count": torch.cuda.device_count() if cuda else 1,
                        "multi_tenant": self.multi_tenant,
                    },
                    {},
                )
            if method == "pack":
                response = self._pack(tenant, header, arrays)
                # arrival-to-answer latency, queue wait included — the
                # doctor's tenant-starvation rule reads this family's
                # per-tenant flight deltas
                self.registry.observe(
                    "karpenter_service_solve_wait_seconds",
                    time.perf_counter() - t0,
                    {"tenant": tenant},
                )
                return response
            return encode(
                {"status": "error", "error": f"unknown method {method}"}, {}
            )

    def _pack(self, tenant: str, header: dict, arrays: dict) -> bytes:
        missing = [n for n in PACK_ARG_ORDER if n not in arrays]
        if missing:
            return encode(
                {"status": "error", "error": f"missing arrays: {missing}"}, {}
            )
        k_slots = int(header["k_slots"])
        objective = str(header.get("objective", "nodes"))
        args = [arrays[n] for n in PACK_ARG_ORDER]
        # next0 travels as a 0-d array; the kernels take a host int
        args[_NEXT0_IDX] = int(args[_NEXT0_IDX])
        if np.shape(arrays["used0"])[:1] != (k_slots,):
            return encode(
                {"status": "error",
                 "error": f"k_slots={k_slots} but used0 has shape "
                          f"{list(np.shape(arrays['used0']))}"}, {}
            )
        if not self.multi_tenant:
            take, leftover, node_cfg, node_used = self._solve_plain(
                args, k_slots, objective
            )
            path = "solo"
        else:
            take, leftover, node_cfg, node_used, path = self._admit_and_solve(
                tenant, args, k_slots, objective
            )
            if path == "retry":
                # the refusal rode back through _admit_and_solve's tuple
                return take  # type: ignore[return-value]
        self.registry.inc(
            "karpenter_service_solves_total",
            {"tenant": tenant, "path": path},
        )
        # node_pods reconstructs exactly from the inputs: npods0 + takes
        node_pods = np.asarray(arrays["npods0"], dtype=np.int32) + take.sum(
            axis=0, dtype=np.int32
        )
        out = (take, leftover, node_cfg, node_pods, node_used)
        return encode(
            {"status": "ok"},
            {name: val for name, val in zip(PACK_RESULT_FIELDS, out)},
        )

    # ----------------------------------------------------- admission plane
    def _refuse(self, tenant: str, reason: str, retry_after_s: float) -> bytes:
        """Explicit backpressure: the caller gets a machine-readable
        retry-after hint, never a silent queue slot."""
        self.registry.inc(
            "karpenter_service_refusals_total",
            {"tenant": tenant, "reason": reason},
        )
        self.ledger.emit(
            "TenantRefused", tenant=tenant, reason=reason,
            retry_after_s=f"{retry_after_s:.3f}",
        )
        return encode(
            {
                "status": "retry",
                "retry_after_s": retry_after_s,
                "reason": reason,
            },
            {},
        )

    def _admit_and_solve(self, tenant, args, k_slots, objective):
        key = solve_group_key(args, k_slots, objective)
        pend = None
        refusal = None  # (reason, retry_after_s), encoded OUTSIDE _cv
        with self._cv:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantStats(tenant)
            ts.last_ts = self.ledger.clock.now()
            if ts.inflight >= self.inflight_cap:
                ts.refused += 1
                refusal = ("inflight-cap", self.batch_idle_s)
            elif (
                sum(g.depth() for g in self._groups.values())
                >= SATURATION_QUEUED
            ):
                ts.refused += 1
                refusal = ("saturated", self.batch_max_s)
            else:
                # admission and inflight++ are ONE atomic decision: a
                # split would let two at-cap requests both slip in
                ts.inflight += 1
                self.registry.set(
                    "karpenter_service_inflight", ts.inflight,
                    {"tenant": tenant},
                )
                grp = self._groups.get(key)
                if grp is None:
                    grp = self._groups[key] = _SolveGroup(
                        key, self.batch_idle_s, self.batch_max_s
                    )
                # single-tenant fall-through: an idle group's lone RPC
                # takes the solo kernel NOW, never waiting out the window
                solo = not grp.busy and grp.depth() == 0
                if solo:
                    grp.busy = True
                else:
                    pend = _Pending(tenant, args, k_slots, objective)
                    grp.queues.setdefault(tenant, deque()).append(pend)
                    grp.window.observe(time.monotonic())
                    if grp.busy:
                        grp.waited = True
                    if grp.worker is None:
                        grp.worker = threading.Thread(
                            target=self._group_worker, args=(grp,),
                            daemon=True, name="solver-batch",
                        )
                        grp.worker.start()
                    self._cv.notify_all()
        if refusal is not None:
            return (
                self._refuse(tenant, *refusal), None, None, None, "retry",
            )
        try:
            if solo:
                try:
                    take, leftover, node_cfg, node_used = self._solve_pooled(
                        tenant, args, k_slots, objective
                    )
                    path = "solo"
                finally:
                    with self._cv:
                        grp.busy = False
                        self._cv.notify_all()
            else:
                take, leftover, node_cfg, node_used = pend.future.result()
                path = "batched"
                with self._cv:
                    ts.batched += 1
        finally:
            with self._cv:
                ts.inflight -= 1
                ts.solves += 1
                self.registry.set(
                    "karpenter_service_inflight", ts.inflight,
                    {"tenant": tenant},
                )
        return take, leftover, node_cfg, node_used, path

    # ------------------------------------------------------- solve backends
    def _solve_plain(self, args, k_slots, objective):
        """The legacy single-tenant path: the wire arrays straight into the
        solo pack, no pooling, no queueing — the original sidecar
        behavior."""
        from karpenter_tpu_torch.obs.device import OBSERVATORY
        from karpenter_tpu_torch.ops.fused_packer import ffd_pack
        from karpenter_tpu_torch.ops.packer import to_device

        t0 = time.perf_counter()
        # the sidecar owns the device, so ITS process observatory is where
        # this pack's upload and launch accounting belongs (the
        # reference's dispatch counts the wire arrays under its name)
        dev = to_device(tuple(args), self.device, site="pack_kernel")
        result = OBSERVATORY.dispatch(
            "ffd_pack", ffd_pack, *dev, objective=objective,
        )
        out = _fetch(result)
        self._flight_tick(time.perf_counter() - t0, {"path": "solo"})
        return out

    def _pooled_args(self, tenant: str, args, site: str) -> list:
        """Swap each wire array for the tenant's device-resident copy
        (content-fingerprint hit: zero transfer; miss: one counted
        upload).  next0 stays a host int.  With no pool budget the pool
        hands the host array back, and it goes up under ``site``, the
        dispatch's upload, as the reference's dispatch counts it."""
        from karpenter_tpu_torch.obs.device import OBSERVATORY

        with self._pool_lock:
            dev = []
            for name, a in zip(PACK_ARG_ORDER, args):
                if name == "next0":
                    dev.append(int(a))
                    continue
                t = self._pool.get(tenant, name, np.asarray(a))
                if isinstance(t, np.ndarray):
                    t = OBSERVATORY.put(site, t, self.device)
                dev.append(t)
            evicted = list(self._pool.evictions)
            self._pool.evictions.clear()
            tenant_bytes = self._pool.bytes_of(tenant)
            self._pool.report_footprint()
        for victim in evicted:
            self.registry.inc(
                "karpenter_service_resident_evictions_total",
                {"tenant": victim},
            )
            self.registry.set(
                "karpenter_service_resident_bytes", 0, {"tenant": victim}
            )
            self.ledger.emit("TenantEvicted", tenant=victim)
            with self._cv:
                self._wrr.forget(victim)
        self.registry.set(
            "karpenter_service_resident_bytes", tenant_bytes,
            {"tenant": tenant},
        )
        return dev

    def _solve_pooled(self, tenant, args, k_slots, objective):
        """The solo pack over the tenant's resident tensors."""
        from karpenter_tpu_torch.obs.device import OBSERVATORY
        from karpenter_tpu_torch.ops.fused_packer import ffd_pack

        t0 = time.perf_counter()
        dev = self._pooled_args(tenant, args, "pack_kernel")
        result = OBSERVATORY.dispatch(
            "ffd_pack", ffd_pack, *dev, objective=objective,
        )
        out = _fetch(result)
        self._flight_tick(time.perf_counter() - t0, {"path": "solo"})
        return out

    def _group_worker(self, grp: _SolveGroup) -> None:
        """Drain one group: wait for the device to free and the window to
        close, WRR-pick up to MAX_BATCH queued solves, run ONE fleet
        dispatch, fan the rows out."""
        while True:
            with self._cv:
                while True:
                    if grp.depth() == 0:
                        grp.worker = None
                        if not grp.busy and self._groups.get(grp.key) is grp:
                            del self._groups[grp.key]
                        return
                    now = time.monotonic()
                    if not grp.busy and (
                        grp.waited or grp.window.ready(now)
                    ):
                        break
                    timeout = 0.05
                    if not grp.busy and grp.window.open:
                        timeout = max(grp.window.deadline() - now, 0.0)
                    self._cv.wait(timeout=timeout)
                weights = {
                    t: self.tenant_weights.get(t, 1.0) for t in grp.queues
                }
                batch = self._wrr.drain(grp.queues, MAX_BATCH, weights)
                grp.queues = {t: q for t, q in grp.queues.items() if q}
                grp.busy = True
                # leftovers already waited a full dispatch: drain them
                # the moment the device frees again
                grp.waited = grp.depth() > 0
                grp.window.reset()
                if grp.depth() > 0:
                    grp.window.observe(time.monotonic())
            try:
                self._run_batch([p for _, p in batch])
            finally:
                with self._cv:
                    grp.busy = False
                    self._cv.notify_all()

    def _run_batch(self, batch: List[_Pending]) -> None:
        """ONE fleet pack for the whole batch (one launch of each kernel,
        at the true batch size: no padding); per-tenant rows fan back out
        to the waiting handler threads."""
        from karpenter_tpu_torch.obs.device import OBSERVATORY
        from karpenter_tpu_torch.ops.fused_packer import fleet_pack

        t0 = time.perf_counter()
        try:
            p0 = batch[0]
            rows_args = [
                self._pooled_args(p.tenant, p.args, "fleet_pack_kernel")
                for p in batch
            ]
            cols = tuple(
                tuple(r[i] for r in rows_args)
                for i in range(len(PACK_ARG_ORDER))
            )
            res = OBSERVATORY.dispatch(
                "fleet_pack", fleet_pack, cols,
                k_slots=p0.k_slots, objective=p0.objective,
            )
            # each output comes back in one read; row b is tenant b's
            take, leftover, node_cfg, _pods, node_used = (
                t.cpu().numpy() for t in res
            )
            for b, p in enumerate(batch):
                p.future.set_result(
                    (take[b], leftover[b], node_cfg[b], node_used[b])
                )
            self.ledger.emit(
                "TenantBatch",
                size=len(batch),
                tenants=",".join(sorted({p.tenant for p in batch})),
                k_slots=p0.k_slots,
            )
            self._flight_tick(
                time.perf_counter() - t0,
                {"path": "batched", "size": len(batch)},
            )
        except Exception as exc:  # fan the failure out to every waiter
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)

    def _flight_tick(self, duration_s: float, summary: dict) -> None:
        from karpenter_tpu_torch.obs.device import OBSERVATORY

        with self._cv:
            self._flight_seq += 1
            seq = self._flight_seq
        self.flight.record(
            seq, current_trace_id(), duration_s, summary=summary,
            device=OBSERVATORY.snapshot(),
        )

    # ----------------------------------------------------- debug surfaces
    def tenants_payload(self) -> dict:
        """The /debug/tenants JSON body: per-tenant admission state,
        resident footprint, and that tenant's slice of the recent event
        ledger — "who is this mesh serving and who is it throttling"."""
        with self._cv:
            tenants = {
                t.name: {
                    "inflight": t.inflight,
                    "solves": t.solves,
                    "batched": t.batched,
                    "refused": t.refused,
                    "last_ts": t.last_ts,
                    "weight": self.tenant_weights.get(t.name, 1.0),
                }
                for t in self._tenants.values()
            }
            groups = [
                {
                    "k_slots": g.key[0],
                    "objective": g.key[1],
                    "queued": g.depth(),
                    "busy": g.busy,
                }
                for g in self._groups.values()
            ]
        with self._pool_lock:
            resident = self._pool.footprint()
            budget = self._pool.budget_bytes
        for name, nbytes in resident.items():
            tenants.setdefault(name, {})["resident_bytes"] = nbytes
        events: Dict[str, list] = {}
        for ev in self.ledger.recent(500):
            t = ev.attrs.get("tenant")
            if t:
                events.setdefault(t, []).append(ev.to_dict())
        for name, evs in events.items():
            tenants.setdefault(name, {})["events"] = evs[-20:]
        return {
            "multi_tenant": self.multi_tenant,
            "inflight_cap": self.inflight_cap,
            "resident_budget_bytes": budget,
            "tenants": tenants,
            "groups": groups,
        }

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> Tuple[str, int]:
        return self.server_address  # type: ignore[return-value]

    def start_background(self) -> "SolverServer":
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="solver-server"
        )
        self._thread.start()
        return self

    def track_conn(self, sock) -> None:
        with self._conns_lock:
            self._conns.add(sock)

    def untrack_conn(self, sock) -> None:
        with self._conns_lock:
            self._conns.discard(sock)

    def stop(self) -> None:
        # sever established handler connections FIRST: shutdown() only
        # stops the accept loop, and the per-connection daemon threads
        # would otherwise keep answering with pre-stop state (the
        # zombie-handler class the store server fixed)
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.shutdown()
        self.server_close()


# the subsystem name (docs/designs/solver-service.md); the class kept its
# original name for the wire-era importers
SolverService = SolverServer


def _fetch(outs) -> tuple:
    """A solo pack's (take, leftover, node_cfg, node_used) as host arrays."""
    take, leftover, node_cfg, _pods, node_used = (t.cpu().numpy() for t in outs)
    return take, leftover, node_cfg, node_used


def main(argv=None) -> int:  # pragma: no cover - CLI entry
    import argparse

    parser = argparse.ArgumentParser(description="karpenter-tpu solver sidecar")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7421)
    parser.add_argument(
        "--telemetry-port",
        type=int,
        default=0,
        help="HTTP port for /metrics, /healthz, /events, /trace, "
        "/debug/flight, /debug/device and /debug/tenants on THIS "
        "process (0 disables)",
    )
    parser.add_argument(
        "--settings-file",
        default="",
        help="chart-rendered settings.json (api/settings.py); the "
        "service.multiTenant.* values arrive here",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the solves run (default: the card)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # a pod is stopped by SIGTERM: stop serving and exit 0, as on SIGINT,
    # also when the signal comes while the server starts
    stop = threading.Event()

    def _stop(_sig, _frame):
        log.info("shutting down")
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    if args.settings_file:
        from karpenter_tpu_torch.api.settings import Settings

        settings = Settings.from_file(args.settings_file)
        server = SolverServer.from_settings(
            settings, host=args.host, port=args.port, device=args.device
        )
    else:
        server = SolverServer(args.host, args.port, device=args.device)
    telemetry = None
    if args.telemetry_port:
        from karpenter_tpu_torch.obs.device import OBSERVATORY
        from karpenter_tpu_torch.obs.http import start_telemetry

        telemetry = start_telemetry(
            args.telemetry_port,
            server.registry,
            tracer=server.tracer,
            ledger=server.ledger,
            flight=server.flight,
            device=OBSERVATORY,
            tenants=server.tenants_payload,
        )
        log.info("telemetry on :%d", args.telemetry_port)
    log.info(
        "solver sidecar listening on %s:%d (multi_tenant=%s, device=%s)",
        *server.address, server.multi_tenant, server.device,
    )
    server.start_background()
    while not stop.wait(0.5):
        pass
    server.stop()
    if telemetry is not None:
        telemetry.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
