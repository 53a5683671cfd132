"""Controller entry point of the port: ``python -m karpenter_tpu_torch``.

Runs the port's `Operator` over the in-repo fake cloud (the reference's
full catalog, ``karpenter_tpu/__main__.py``) with the reference's demo
NodeClass and NodePool and ``--pods`` pending demo pods, for ``--ticks``
reconciles ``--interval`` seconds apart on the wall clock, the
Provisioner's solver on ``--device`` (the card unless ``cpu`` is asked
for).  Each tick prints one JSON line: the tick's ``reconcile_once`` ms,
the solves by kind (cold, hit or delta), the claims launched so far and
the device observatory's tick section.  ``--solver-address host:port``
moves the device half of every solve into a solver sidecar
(``python -m karpenter_tpu_torch.service.server``): the Provisioner's
scheduler packs through `RemoteSolver.pack_problem`.  The HTTP telemetry
server's ``--metrics-port`` and the remote store are not ported (ROADMAP
§A).

Subcommands, dispatched as the JAX package's entry point does:

- ``sim``: the deterministic cluster simulator (``sim/cli.py``), on the
  card unless ``--device cpu``;
- ``doctor``: the diagnosis of a flight-recorder dump (``obs/doctor.py``);
- ``obs``: span dumps and simulator traces rendered as Chrome-trace JSON
  (``obs/render.py``).

    python -m karpenter_tpu_torch --ticks 3 --device cpu
    python -m karpenter_tpu_torch --ticks 3 --device cpu --solver-address 127.0.0.1:7421
    python -m karpenter_tpu_torch sim --scenario steady --seed 3 --ticks 40 --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from karpenter_tpu_torch.api import NodeClass, NodePool, Pod, Resources, Settings
from karpenter_tpu_torch.api.objects import SelectorTerm
from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, generate_catalog
from karpenter_tpu_torch.obs.device import OBSERVATORY
from karpenter_tpu_torch.operator import Operator, solve_kind, solver_counters
from karpenter_tpu_torch.state.kube import KubeStore
from karpenter_tpu_torch.utils.clock import Clock


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
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    clock = Clock()
    cloud = FakeCloud(clock, shapes=generate_catalog()).with_default_topology()
    kube = KubeStore()
    settings = Settings()
    operator = Operator(cloud, kube, settings=settings, device=args.device)
    kube.put_node_class(
        NodeClass(
            name="default",
            subnet_selector_terms=[SelectorTerm.of(Name="*")],
            security_group_selector_terms=[SelectorTerm.of(Name="*")],
        )
    )
    kube.put_node_pool(NodePool(name="default", node_class_ref="default"))
    for i in range(args.pods):
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
            "claims": len(kube.node_claims),
            "pending": len(kube.pending_pods()),
            "device": OBSERVATORY.tick_section(),
            "device_detail": OBSERVATORY.tick_detail(),
        }), flush=True)
        if tick + 1 < args.ticks:
            clock.sleep(args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
