"""Controller entry point of the port: ``python -m karpenter_tpu_torch``.

The reference's deployable contract (``karpenter_tpu/__main__.py``, the
analogue of cmd/controller/main.go): resolve Settings (``--settings-file``,
else ``KARPENTER_*`` variables, else defaults; ``--dump-settings`` prints
them and exits), build the port's `Operator` over the in-repo fake cloud
(the reference's full catalog) with the Provisioner's solver on
``--device`` (the card unless ``cpu`` is asked for; asking for the card
without one raises), serve the telemetry surface on ``--metrics-port``
(``obs/http.py``: /metrics, /healthz, /events, /trace, /debug/flight and
the device observatory's /debug/device), mirror the event ledger into
``--events-log``, seed ``--demo-pods`` pending pods with a default
NodeClass and NodePool, and run `Operator.run` every ``--interval``
seconds until SIGINT or SIGTERM.  SIGUSR1 asks for a flight-recorder
dump at the end of the current tick.  On shutdown the process releases
the lease, closes the store client, stops the telemetry server, writes
the lock witness (under the sanitizer), and under ``enable_profiling``
prints the span report and writes ``spans.json`` into ``profile_dir``,
where each solve's ``torch.profiler`` timeline lands too.

``--ticks N`` runs N reconciles instead (bounded runs: tests, the card's
smoke run), one JSON line a tick: the tick's ``reconcile_once`` ms, the
solves by kind (cold, hit or delta), the claims launched so far, the
device observatory's tick section and whether this replica leads
(``leading``: the ``karpenter_leader_election_leading`` gauge); there the
telemetry server runs only when ``--metrics-port`` is given.  ``--pods``
is ``--demo-pods``.  ``--solver-address host:port`` moves the device half
of every solve into a solver sidecar (``python -m
karpenter_tpu_torch.service.server``): the Provisioner's scheduler packs
through `RemoteSolver.pack_problem`.

``--store-address host:port`` makes the process a client of a shared
cluster store (``store-server`` below; `state/remote.py`'s
`RemoteKubeStore`), so several replicas share one durable state; a
comma-separated list names a sharded store (keys partition across the
servers in order, Leases pin to the first).  ``--leader-elect`` (on by
default) takes the store's Lease before reconciling, and a replica that
does not lead skips its ticks: run two replicas over one store and one of
them reconciles.  With ``enable_lock_sanitizer`` in the settings the
runtime lock sanitizer is enabled before any store or provider is built,
the operator arms the lock watchdog when ``lock_watchdog_stall_s`` is set,
and the lock witness lands in ``witness.json`` (under ``flight_dir``) on
exit.

Subcommands, dispatched as the JAX package's entry point does:

- ``sim``: the deterministic cluster simulator (``sim/cli.py``), the fleet
  scenarios too, on the card unless ``--device cpu``;
- ``doctor``: the diagnosis of a flight-recorder dump (``obs/doctor.py``);
- ``obs``: span dumps and simulator traces rendered as Chrome-trace JSON
  (``obs/render.py``);
- ``store-server``: the shared cluster store (``service/store_server.py``)
  that ``--store-address`` replicas share;
- ``lint``: the static analysis of the port's own tree (``analysis/cli.py``:
  the rule engine and its 18 rules; ``--json``, ``--rule``,
  ``--list-rules``, ``--profile``, ``--witness``, ``--baseline``).

    python -m karpenter_tpu_torch --interval 1 --metrics-port 8080 --demo-pods 100
    python -m karpenter_tpu_torch --ticks 3 --device cpu --pods 100
    python -m karpenter_tpu_torch --ticks 3 --device cpu --pods 100 --solver-address 127.0.0.1:7421
    python -m karpenter_tpu_torch sim --scenario store-fleet-chaos --seed 0 --ticks 36 --device cpu
    python -m karpenter_tpu_torch store-server --port 18097 &
    python -m karpenter_tpu_torch --ticks 30 --pods 100 --store-address 127.0.0.1:18097
    python -m karpenter_tpu_torch lint --json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket
import sys
import threading
import time

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
    if argv and argv[0] == "lint":
        # the static analysis of the port's own tree (analysis/cli.py):
        # exit 0 clean, 1 findings, 2 checker error
        from karpenter_tpu_torch.analysis.cli import main as lint_main

        return lint_main(argv[1:])
    if argv and argv[0] == "store-server":
        # the shared cluster store: one durable KubeStore that
        # --store-address replicas (and their Lease election) share
        from karpenter_tpu_torch.service.store_server import main as store_main

        # a pod is stopped by SIGTERM: the store ends as on SIGINT, which
        # its serve loop takes as the end, and exits 0, also when the
        # signal comes before the loop starts
        signal.signal(signal.SIGTERM, signal.default_int_handler)
        try:
            return store_main(argv[1:])
        except KeyboardInterrupt:
            return 0
    # the controller's modules (torch and the CUDA library's wrappers among
    # them) load only here: the store server above is a process of its own
    # that needs none of them
    from karpenter_tpu_torch.api import Settings
    from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, generate_catalog
    from karpenter_tpu_torch.metrics.registry import REGISTRY
    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.state.kube import KubeStore
    from karpenter_tpu_torch.utils.clock import Clock

    parser = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch")
    parser.add_argument(
        "--settings-file",
        help="JSON settings file (the karpenter-global-settings configmap "
        "analogue); KARPENTER_* env vars apply when omitted",
    )
    parser.add_argument(
        "--interval", type=float, default=1.0, help="reconcile interval (s)"
    )
    parser.add_argument(
        "--ticks", type=int, default=0,
        help="run this many reconciles, one JSON line each, then shut down "
        "(default 0: run until SIGINT or SIGTERM)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the Provisioner's solver runs (default: the card)",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None,
        help="HTTP port for the telemetry surface (0 disables; default 8080, "
        "and none under --ticks): /metrics (Prometheus exposition), "
        "/healthz, /events (the cluster event ledger, ?since_seq=N&limit=M "
        "cursor), /trace (the span ring, renderable via `python -m "
        "karpenter_tpu_torch obs`), /debug/flight (the flight recorder "
        "ring, diagnosable via `python -m karpenter_tpu_torch doctor`), "
        "/debug/device (the device observatory's launches, transfers and "
        "resident footprint)",
    )
    parser.add_argument(
        "--events-log", default="",
        help="JSONL file the cluster event ledger appends to; the ring at "
        "/events is bounded, this sink is not",
    )
    parser.add_argument(
        "--solver-address", default="",
        help="host:port of a solver sidecar (service/server.py) that packs "
        "every solve; default port 7421",
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
    parser.add_argument(
        "--demo-pods", "--pods", dest="demo_pods", type=int, default=0,
        metavar="N",
        help="seed a default NodeClass and NodePool and N small pending "
        "pods at boot, so a freshly booted process provisions; a replica "
        "joining a shared store leaves the demo pods already there",
    )
    parser.add_argument(
        "--dump-settings", action="store_true",
        help="print the resolved settings and exit",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )

    settings = (
        Settings.from_file(args.settings_file) if args.settings_file
        else Settings.from_env()
    )
    settings.validate()
    if args.dump_settings:
        print(json.dumps(settings.__dict__, default=str, indent=2))
        return 0
    # the runtime lock sanitizer: enabled BEFORE any store or provider is
    # built, so every lock built through the seams is wrapped into the
    # witness; the operator arms the deadlock watchdog when
    # lock_watchdog_stall_s > 0, and the exit leaves the witness
    sanitizer_mod = None
    if settings.enable_lock_sanitizer:
        from karpenter_tpu_torch.analysis import sanitizer as sanitizer_mod

        sanitizer_mod.enable("operator")
        log.info("lock sanitizer enabled (witness on shutdown)")

    identity = f"{socket.gethostname()}-{os.getpid()}"
    cloud = FakeCloud(Clock(), shapes=generate_catalog()).with_default_topology()
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
        log.info("shared cluster store at %s (%d shard%s)", args.store_address,
                 len(addresses), "" if len(addresses) == 1 else "s")
    else:
        kube = KubeStore()
    elector = None
    if args.leader_elect:
        from karpenter_tpu_torch.utils.leader import LeaderElector

        elector = LeaderElector(kube, cloud.clock, identity=identity)
    operator = Operator(cloud, kube, settings=settings, elector=elector,
                        device=args.device)

    scheduler = operator.provisioner.scheduler
    if args.solver_address:
        from karpenter_tpu_torch.service.client import RemoteSolver

        host, _, port = args.solver_address.partition(":")
        # default port matches service/server.py's listener
        remote = RemoteSolver(host, int(port)) if port else RemoteSolver(host)
        scheduler.pack_fn = remote.pack_problem
        log.info("solver sidecar at %s", args.solver_address)

    if args.events_log:
        operator.ledger.set_sink(args.events_log)
        log.info("event ledger sink at %s", args.events_log)

    if args.demo_pods:
        _seed_demo(kube, args.demo_pods)
        log.info("seeded demo workload: %d pending pods", args.demo_pods)

    server = None
    metrics_port = args.metrics_port
    if metrics_port is None:
        metrics_port = 0 if args.ticks else 8080
    if metrics_port:
        from karpenter_tpu_torch.obs.http import start_telemetry

        server = start_telemetry(
            metrics_port,
            REGISTRY,
            tracer=operator.tracer,
            ledger=operator.ledger,
            flight=operator.flight,
            device=OBSERVATORY,
        )
        log.info("metrics on :%d/metrics", metrics_port)

    stop = threading.Event()

    def _stop(_sig, _frame):
        log.info("shutting down")
        stop.set()
        operator.stop()

    def _flight_dump(_sig, _frame):
        # only set a flag: the handler runs on the main thread, and
        # dumping takes locks the interrupted frame may hold.  The dump
        # lands at the end of the current or next tick, in flight_dir
        # when set, the working directory otherwise
        operator.request_flight_dump("sigusr1")

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, _flight_dump)
    log.info("karpenter-tpu controller running (cluster=%s, interval=%.1fs, "
             "device=%s)", settings.cluster_name, args.interval, operator.device)
    try:
        if args.ticks:
            _bounded_run(args, operator, kube, scheduler, stop)
        else:
            operator.run(interval_s=args.interval)
    finally:
        if elector is not None:
            # graceful handoff: free the Lease so the standby takes over
            # at once instead of waiting out the expiry
            elector.release()
        if hasattr(kube, "close"):  # store client: stop the watch stream
            kube.close()
        if server is not None:
            server.shutdown()
    if sanitizer_mod is not None:
        san = sanitizer_mod.disable()
        witness = san.witness()
        directory = settings.flight_dir or "."
        os.makedirs(directory, exist_ok=True)
        path = witness.dump(os.path.join(directory, "witness.json"))
        log.info(
            "lock witness %s -> %s (%d finding(s), %d edge(s))",
            witness.fingerprint, path, len(witness.findings),
            len(witness.edges),
        )
    if operator.tracer.enabled:
        # the pprof-style hot-path table on shutdown; a JSON snapshot lands
        # beside the solves' profiler timelines when profile_dir is set
        print(operator.tracer.report(), flush=True)
        if settings.profile_dir:
            os.makedirs(settings.profile_dir, exist_ok=True)
            operator.tracer.dump(os.path.join(settings.profile_dir, "spans.json"))
    return 0


def _seed_demo(kube, n: int) -> None:
    """The demo workload: a default NodeClass and NodePool and ``n`` small
    pending pods (those a shared store already holds are left as they
    are, bindings included)."""
    from karpenter_tpu_torch.api import NodeClass, NodePool, Pod, Resources
    from karpenter_tpu_torch.api.objects import SelectorTerm

    kube.put_node_class(
        NodeClass(
            name="default",
            subnet_selector_terms=[SelectorTerm.of(Name="*")],
            security_group_selector_terms=[SelectorTerm.of(Name="*")],
        )
    )
    kube.put_node_pool(NodePool(name="default", node_class_ref="default"))
    for i in range(n):
        if f"default/demo-{i}" not in kube.pods:
            kube.put_pod(
                Pod(name=f"demo-{i}", requests=Resources(cpu=0.25, memory=512 * 2**20))
            )


def _bounded_run(args, operator, kube, scheduler, stop) -> None:
    """``--ticks`` reconciles, one JSON line each, with the lease renewed
    in the background and the lock watchdog running, as `Operator.run`
    keeps them; a signal ends the run early."""
    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.operator import solve_kind, solver_counters

    if operator.elector is not None:
        # keep the lease fresh through ticks longer than its duration
        operator.elector.start_background_renewal(stop)
    if operator.watchdog is not None:
        operator.watchdog.start()
    try:
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
            if tick + 1 == args.ticks or stop.wait(args.interval):
                break
    finally:
        stop.set()
        if operator.watchdog is not None:
            operator.watchdog.stop()


if __name__ == "__main__":
    sys.exit(main())
