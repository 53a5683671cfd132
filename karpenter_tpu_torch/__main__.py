"""Controller entry point of the port: ``python -m karpenter_tpu_torch``.

Runs the port's `Operator` over the in-repo fake cloud (the reference's
full catalog, ``karpenter_tpu/__main__.py``) with the reference's demo
NodeClass and NodePool and ``--pods`` pending demo pods, for ``--ticks``
reconciles ``--interval`` seconds apart on the wall clock, the
Provisioner's solver on ``--device`` (the card unless ``cpu`` is asked
for).  Each tick prints one JSON line: the tick's ``reconcile_once`` ms,
the solves by kind (cold, hit or delta), the claims launched so far and
the device observatory's tick section and whether this replica leads
(``leading``: the ``karpenter_leader_election_leading`` gauge).
``--solver-address host:port`` moves the device half of every solve into
a solver sidecar (``python -m karpenter_tpu_torch.service.server``): the
Provisioner's scheduler packs through `RemoteSolver.pack_problem`.

``--store-address host:port`` makes the process a client of a shared
cluster store (``store-server`` below; `state/remote.py`'s
`RemoteKubeStore`), so several replicas share one durable state; a
comma-separated list names a sharded store (keys partition across the
servers in order, Leases pin to the first).  ``--leader-elect`` (on by
default) takes the store's Lease before reconciling, and a replica that
does not lead skips its ticks: run two replicas over one store and one of
them reconciles.  With ``enable_lock_sanitizer`` in the settings
(``--settings-file``, or ``KARPENTER_*`` variables), the runtime lock
sanitizer is enabled before any store or provider is built, the operator
arms the lock watchdog when ``lock_watchdog_stall_s`` is set, and the lock
witness lands in ``witness.json`` (under ``flight_dir``) on exit.  The
HTTP telemetry server's ``--metrics-port`` is not ported (ROADMAP A8).

Subcommands, dispatched as the JAX package's entry point does:

- ``sim``: the deterministic cluster simulator (``sim/cli.py``), on the
  card unless ``--device cpu``;
- ``doctor``: the diagnosis of a flight-recorder dump (``obs/doctor.py``);
- ``obs``: span dumps and simulator traces rendered as Chrome-trace JSON
  (``obs/render.py``);
- ``store-server``: the shared cluster store (``service/store_server.py``)
  that ``--store-address`` replicas share.

    python -m karpenter_tpu_torch --ticks 3 --device cpu
    python -m karpenter_tpu_torch --ticks 3 --device cpu --solver-address 127.0.0.1:7421
    python -m karpenter_tpu_torch sim --scenario steady --seed 3 --ticks 40 --device cpu
    python -m karpenter_tpu_torch store-server --port 18097 &
    python -m karpenter_tpu_torch --ticks 30 --store-address 127.0.0.1:18097 --leader-elect
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import threading
import time

from karpenter_tpu_torch.api import NodeClass, NodePool, Pod, Resources, Settings
from karpenter_tpu_torch.api.objects import SelectorTerm
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, generate_catalog
from karpenter_tpu_torch.metrics.registry import REGISTRY
from karpenter_tpu_torch.obs.device import OBSERVATORY
from karpenter_tpu_torch.operator import Operator, solve_kind, solver_counters
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock

log = logging.getLogger("karpenter_tpu_torch")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "obs":
        from karpenter_tpu_torch.obs.render import main as obs_main

        return obs_main(argv[1:])
    if argv and argv[0] == "doctor":
        from karpenter_tpu_torch.obs.doctor import main as doctor_main

        return doctor_main(argv[1:])
    if argv and argv[0] == "sim":
        from karpenter_tpu_torch.sim.cli import main as sim_main

        return sim_main(argv[1:])
    if argv and argv[0] == "store-server":
        # the shared cluster store: one durable KubeStore that
        # --store-address replicas (and their Lease election) share
        from karpenter_tpu_torch.service.store_server import main as store_main

        return store_main(argv[1:])
    parser = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch")
    parser.add_argument("--ticks", type=int, default=3, help="reconciles to run")
    parser.add_argument(
        "--interval", type=float, default=1.0, help="seconds between ticks"
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the Provisioner's solver runs (default: the card)",
    )
    parser.add_argument(
        "--pods", type=int, default=100,
        help="pending demo pods seeded before the first tick",
    )
    parser.add_argument(
        "--solver-address", default="",
        help="host:port of a solver sidecar (service/server.py) that packs "
        "every solve; default port 7421",
    )
    parser.add_argument(
        "--settings-file",
        help="JSON settings file; KARPENTER_* env vars apply when omitted",
    )
    parser.add_argument(
        "--store-address", default="",
        help="host:port of a shared cluster-store server (`python -m "
        "karpenter_tpu_torch store-server`; default port 8082): this "
        "process becomes a store client so replicas share one durable "
        "state and the Lease election is real.  A comma-separated list "
        "names a sharded store: keys partition across the servers in "
        "order, Leases pin to the first.  Without it the store is "
        "in-process and each replica is a cluster of its own",
    )
    parser.add_argument(
        "--leader-elect", action=argparse.BooleanOptionalAction, default=True,
        help="take the store's Lease before reconciling; a replica that "
        "does not lead skips its ticks",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    settings = (
        Settings.from_file(args.settings_file) if args.settings_file
        else Settings.from_env()
    )
    settings.validate()
    # the runtime lock sanitizer: enabled BEFORE any store or provider is
    # built, so every lock built through the seams is wrapped into the
    # witness; the operator arms the deadlock watchdog when
    # lock_watchdog_stall_s > 0, and the exit leaves the witness
    sanitizer_mod = None
    if settings.enable_lock_sanitizer:
        from karpenter_tpu_torch.analysis import sanitizer as sanitizer_mod

        sanitizer_mod.enable("operator")

    identity = f"{socket.gethostname()}-{os.getpid()}"
    clock = Clock()
    cloud = FakeCloud(clock, shapes=generate_catalog()).with_default_topology()
    if args.store_address:
        from karpenter_tpu_torch.state.remote import RemoteKubeStore

        addresses = []
        for addr in args.store_address.split(","):
            host, _, port = addr.strip().partition(":")
            addresses.append((host, int(port) if port else 8082))
        # the client half of the store plane (karpenter_store_rpc_seconds,
        # the byte counters, StoreResync events) lands in the process
        # registry the operator uses
        kube = RemoteKubeStore(
            addresses[0][0],
            addresses[0][1],
            identity=identity,
            codec=settings.store_codec,
            registry=REGISTRY,
            events_cap=settings.store_events_cap,
            shards=addresses if len(addresses) > 1 else None,
        )
    else:
        kube = KubeStore()
    elector = None
    if args.leader_elect:
        from karpenter_tpu_torch.utils.leader import LeaderElector

        elector = LeaderElector(kube, cloud.clock, identity=identity)
    operator = Operator(cloud, kube, settings=settings, elector=elector,
                        device=args.device)
    kube.put_node_class(
        NodeClass(
            name="default",
            subnet_selector_terms=[SelectorTerm.of(Name="*")],
            security_group_selector_terms=[SelectorTerm.of(Name="*")],
        )
    )
    kube.put_node_pool(NodePool(name="default", node_class_ref="default"))
    for i in range(args.pods):
        # a replica joining a shared store leaves the demo pods already
        # there (and their bindings) as they are
        if f"default/demo-{i}" not in kube.pods:
            kube.put_pod(
                Pod(name=f"demo-{i}", requests=Resources(cpu=0.25, memory=512 * 2**20))
            )

    scheduler = operator.provisioner.scheduler
    if args.solver_address:
        from karpenter_tpu_torch.service.client import RemoteSolver

        host, _, port = args.solver_address.partition(":")
        # default port matches service/server.py's listener
        remote = RemoteSolver(host, int(port)) if port else RemoteSolver(host)
        scheduler.pack_fn = remote.pack_problem
    stop = threading.Event()
    if elector is not None:
        # keep the lease fresh through ticks longer than its duration
        elector.start_background_renewal(stop)
    if operator.watchdog is not None:
        operator.watchdog.start()
    try:
        _tick_loop(args, operator, kube, clock, scheduler)
    finally:
        stop.set()
        if operator.watchdog is not None:
            operator.watchdog.stop()
        if elector is not None:
            # graceful handoff: free the Lease so the standby takes over
            # at once instead of waiting out the expiry
            elector.release()
        if hasattr(kube, "close"):  # store client: stop the watch stream
            kube.close()
    if sanitizer_mod is not None:
        san = sanitizer_mod.disable()
        witness = san.witness()
        directory = settings.flight_dir or "."
        os.makedirs(directory, exist_ok=True)
        path = witness.dump(os.path.join(directory, "witness.json"))
        log.warning(
            "lock witness %s -> %s (%d finding(s), %d edge(s))",
            witness.fingerprint, path, len(witness.findings),
            len(witness.edges),
        )
    return 0


def _tick_loop(args, operator, kube, clock, scheduler) -> None:
    for tick in range(args.ticks):
        before = solver_counters(scheduler)
        t0 = time.perf_counter()
        operator.reconcile_once()
        ms = (time.perf_counter() - t0) * 1e3
        kind = solve_kind(before, solver_counters(scheduler))
        print(json.dumps({
            "tick": tick + 1,
            "ms": round(ms, 3),
            "solves": {kind: 1} if kind else {},
            "kernel": scheduler.last_kernel if kind else "",
            "leading": operator.elector is None or operator.elector.leading,
            "claims": len(kube.node_claims),
            "pending": len(kube.pending_pods()),
            "device": OBSERVATORY.tick_section(),
            "device_detail": OBSERVATORY.tick_detail(),
        }), flush=True)
        if tick + 1 < args.ticks:
            clock.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
