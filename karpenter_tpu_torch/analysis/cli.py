"""``python -m karpenter_tpu_torch lint`` — the static-analysis CLI.

Exit codes: 0 clean (no non-baselined findings), 1 findings, 2 internal
error (the analyzer itself broke — CI must distinguish "violations"
from "the checker is down").

``--json`` emits the stable, sorted report schema (core.to_report) so
CI diffs are deterministic; ``--profile`` adds per-rule wall timings (to
stderr in text mode, under ``timings_s`` in JSON mode) so a slow rule
cannot silently balloon tier-1 time.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch lint",
        description="whole-program static analysis over the package "
        "(docs/designs/static-analysis.md)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the stable machine-readable report on stdout",
    )
    parser.add_argument(
        "--rule", action="append", default=[], metavar="NAME",
        help="run only this rule (repeatable); default: all registered",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog (name, title, guarded guarantee)",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="print per-rule wall timings",
    )
    parser.add_argument(
        "--root", default="", metavar="DIR",
        help="package directory to lint (default: the installed "
        "karpenter_tpu_torch package)",
    )
    parser.add_argument(
        "--baseline", default="", metavar="FILE",
        help="suppression file (default: <package>/analysis/"
        "baseline.json)",
    )
    parser.add_argument(
        "--witness", default="", metavar="FILE",
        help="runtime witness artifact (a sanitized run's serialized "
        "lock graph, analysis/witness.py): merge its runtime edges "
        "into the static order graph and report both directions — a "
        "runtime edge the static model never predicted is a FINDING "
        "(static-model incompleteness), a static edge never exercised "
        "is an informational coverage gap",
    )
    args = parser.parse_args(argv)

    try:
        from karpenter_tpu_torch.analysis import (
            PackageSnapshot,
            RULES,
            load_baseline,
            run_rules,
            to_report,
        )
        from karpenter_tpu_torch.analysis.core import default_baseline_path

        if args.list_rules:
            for name in sorted(RULES):
                rule = RULES[name]
                print(f"{name:28s} {rule.title}")
                print(f"{'':28s}   guards: {rule.guards}")
            return 0

        snap = PackageSnapshot.load(
            pathlib.Path(args.root) if args.root else None
        )
        baseline_path = (
            pathlib.Path(args.baseline)
            if args.baseline
            else default_baseline_path(snap)
        )
        baseline = load_baseline(baseline_path)
        timings = {} if args.profile else None
        live, suppressed = run_rules(
            snap,
            rule_names=args.rule or None,
            baseline=baseline,
            timings=timings,
        )
        witness_section = None
        if args.witness:
            witness_section, live = _cross_validate(
                snap, pathlib.Path(args.witness), live
            )
    except Exception as exc:  # the checker itself broke: exit 2
        print(f"lint internal error: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 2

    rule_names = args.rule or sorted(RULES)
    if args.json:
        report = to_report(snap, live, suppressed, rule_names, timings)
        if witness_section is not None:
            report["witness"] = witness_section
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for f in live:
            print(f.render())
        if suppressed:
            print(f"({len(suppressed)} baselined finding(s) suppressed)")
        print(
            f"lint: {len(live)} finding(s), {len(suppressed)} baselined, "
            f"{len(rule_names)} rule(s)"
        )
        if witness_section is not None:
            cv = witness_section["cross_validation"]
            print(
                f"witness {witness_section['fingerprint']} "
                f"({witness_section['scenario']}): "
                f"{len(cv['confirmed'])} edge(s) confirmed, "
                f"{len(cv['missing_static'])} missing from the static "
                f"model, {len(cv['unexercised_static'])} static edge(s) "
                f"unexercised (coverage gap), "
                f"{len(cv['unmodeled'])} out-of-layer"
            )
        if timings is not None:
            for name, dt in sorted(
                timings.items(), key=lambda kv: -kv[1]
            ):
                print(f"  {name:28s} {dt * 1000:8.1f} ms", file=sys.stderr)
    return 1 if live else 0


def _cross_validate(snap, witness_path, live):
    """Merge a witness into the static order graph.  Runtime-only edges
    (minus allowlists.WITNESS_EDGES) become live ``witness-gap``
    findings; everything else lands in the report's informational
    ``witness`` section."""
    from karpenter_tpu_torch.analysis.allowlists import WITNESS_EDGES
    from karpenter_tpu_torch.analysis.core import Finding
    from karpenter_tpu_torch.analysis.locks import static_order_edges
    from karpenter_tpu_torch.analysis.witness import Witness, cross_validate

    witness = Witness.load(witness_path)
    edges, universe = static_order_edges(snap)
    cv = cross_validate(witness, edges, universe, WITNESS_EDGES)
    for entry in cv.missing_static:
        site = entry["sites"][0] if entry["sites"] else "?"
        live.append(
            Finding(
                rule="witness-gap",
                file=site.split(":", 1)[0],
                line=0,
                message=(
                    f"runtime lock-order edge {entry['outer']} -> "
                    f"{entry['inner']} (witnessed at {site}) is absent "
                    "from the static order graph — the static model is "
                    "incomplete for this path (or a seam lock name "
                    "drifted); fix the resolution or allowlist the "
                    "edge in WITNESS_EDGES with an argument"
                ),
            )
        )
    section = {
        "scenario": witness.scenario,
        "fingerprint": witness.fingerprint,
        "findings_in_witness": len(witness.findings),
        "cross_validation": cv.to_dict(),
    }
    return section, sorted(live)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
