"""``python -m karpenter_tpu_torch sim`` — run or replay a cluster scenario.

    python -m karpenter_tpu_torch sim --scenario steady --seed 3 --ticks 40
    python -m karpenter_tpu_torch sim --scenario steady --seed 3 --ticks 40 --device cpu
    python -m karpenter_tpu_torch sim --replay sim-steady-seed3.jsonl

stdout is the deterministic SLO report (JSON): running the same
scenario/seed/ticks twice prints the identical report and writes
byte-identical traces; replaying a recorded trace reproduces the identical
report.  Trace location/sha and the replay verdict go to stderr so they
never perturb the comparable surface.  `--profile` attaches the wall-clock
solver phase breakdown — explicitly non-deterministic, off by default.

The port of ``karpenter_tpu/sim/cli.py``.  The operator runs on
``--device`` (the card by default; without one the run raises rather than
carrying on on the CPU), and a trace does not depend on the device.  There
is no platform pin and no re-exec: nothing of the trace depends on set
iteration order.  The fleet scenarios (``sim/fleet.py``: several operators
over one store server, shards or solver service) run on ``--device`` too,
and a trace whose meta line says ``fleet`` replays through `replay_fleet`.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch sim")
    parser.add_argument("--scenario", default="steady")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ticks", type=int, default=200)
    parser.add_argument(
        "--trace",
        default="",
        help="trace JSONL path (default: sim-<scenario>-seed<seed>.jsonl)",
    )
    parser.add_argument(
        "--replay",
        default="",
        metavar="TRACE",
        help="re-execute a recorded trace instead of generating; exits 1 "
        "if the recomputed report differs from the recorded one",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the operator's solver runs (default: the card)",
    )
    parser.add_argument(
        "--profile",
        action="store_true",
        help="attach the wall-clock solver phase breakdown to the report "
        "(NON-deterministic by nature)",
    )
    parser.add_argument(
        "--list", action="store_true", help="list scenarios and exit"
    )
    args = parser.parse_args(argv)

    from karpenter_tpu_torch.sim.fleet import (
        FLEET_SCENARIOS,
        _FleetTrace,
        replay_fleet,
        run_fleet,
    )
    from karpenter_tpu_torch.sim.report import wall_profile
    from karpenter_tpu_torch.sim.runner import SCENARIOS, replay, run_scenario
    from karpenter_tpu_torch.sim.trace import TraceWriter, read_trace

    # the load-harness corpus registers its scenarios on import (the
    # entry points below also trigger this, but --list needs it NOW)
    import karpenter_tpu_torch.load.corpus  # noqa: F401

    if args.list:
        for name, factory in sorted(SCENARIOS.items()):
            print(f"{name}: {factory(200).description}")
        for name, description in sorted(FLEET_SCENARIOS.items()):
            print(f"{name}: {description}")
        return 0

    if args.replay:
        trace_path = args.trace or (args.replay + ".replayed")
        # fleet traces replay through the fleet runner (the meta line
        # says which kind of trace this is)
        head = next(iter(read_trace(args.replay)), {})
        if head.get("fleet"):
            writer = _FleetTrace(trace_path)
            runner, report, recorded = replay_fleet(
                args.replay, trace=writer, device=args.device
            )
        else:
            writer = TraceWriter(trace_path)
            runner, report, recorded = replay(
                args.replay, trace=writer, device=args.device
            )
        matches = recorded is not None and report == recorded
        print(
            f"replayed {args.replay} -> {trace_path} "
            f"(sha256 {writer.sha256()[:16]}); report "
            f"{'matches' if matches else 'DIFFERS FROM'} the recorded one",
            file=sys.stderr,
        )
    elif args.scenario in FLEET_SCENARIOS:
        trace_path = args.trace or f"sim-{args.scenario}-seed{args.seed}.jsonl"
        writer = _FleetTrace(trace_path)
        runner, report = run_fleet(
            args.scenario, args.seed, args.ticks, trace=writer,
            device=args.device,
        )
        matches = True
        print(
            f"trace -> {trace_path} (sha256 {writer.sha256()[:16]})",
            file=sys.stderr,
        )
    else:
        if args.scenario not in SCENARIOS:
            print(
                f"unknown scenario {args.scenario!r}; have "
                f"{', '.join(sorted({**SCENARIOS, **FLEET_SCENARIOS}))}",
                file=sys.stderr,
            )
            return 64
        trace_path = args.trace or f"sim-{args.scenario}-seed{args.seed}.jsonl"
        writer = TraceWriter(trace_path)
        runner, report = run_scenario(
            args.scenario, args.seed, args.ticks, trace=writer,
            device=args.device,
        )
        matches = True
        print(
            f"trace -> {trace_path} (sha256 {writer.sha256()[:16]})",
            file=sys.stderr,
        )

    if args.profile:
        if hasattr(runner, "env"):
            report = dict(report, profile=wall_profile(runner.env.registry))
        else:
            print(
                "--profile is not supported for fleet scenarios "
                "(per-operator wall profiles are not aggregated); ignoring",
                file=sys.stderr,
            )
    print(json.dumps(report, indent=2, sort_keys=True))

    if report["invariants"]["violations"]:
        print(
            f"{len(report['invariants']['violations'])} invariant "
            "violation(s)",
            file=sys.stderr,
        )
        return 2
    return 0 if matches else 1
