"""Generate docs/torch/metrics.md from the metric names in the port's tree.

The reference generates its metrics reference page from code
(hack/docs/metrics_gen_docs.go -> website concepts/metrics.md); this is
the same contract here: the doc is derived, never hand-edited, and a test
(tests/test_torch_tools.py) fails when it drifts from the source.  The
port's page is its own (``docs/metrics.md`` is the JAX package's): each
entry names the port's modules, and a family the port adds is documented
here without touching the reference's page.

Run: ``python -m karpenter_tpu_torch.tools.gen_metrics_doc``
"""

from __future__ import annotations

import pathlib
import re
from collections import defaultdict
from typing import Dict, List

from karpenter_tpu_torch.metrics.catalog import METRIC_DETAILS

# a trailing underscore is a subsystem PREFIX (lint rules and group
# tables name those to match families, not to emit one), never a family
_METRIC_RE = re.compile(r'"(karpenter_[a-z0-9_]*[a-z0-9])"')

# subsystem ordering mirrors the reference page's grouping
_GROUPS = [
    ("karpenter_provisioner_", "Provisioner"),
    ("karpenter_nodeclaims_", "NodeClaims"),
    ("karpenter_nodes_", "Nodes"),
    ("karpenter_pods_", "Pods"),
    ("karpenter_admission_", "Admission fast path"),
    ("karpenter_deprovisioning_", "Deprovisioning"),
    ("karpenter_consistency_", "Consistency"),
    ("karpenter_interruption_", "Interruption"),
    ("karpenter_cloudprovider_", "CloudProvider"),
    ("karpenter_cloud_api_", "Cloud API resilience"),
    ("karpenter_provider_cache_", "Provider caches"),
    ("karpenter_tpu_controller_", "Controller health"),
    ("karpenter_batcher_", "Batcher"),
    ("karpenter_cache_", "Cache"),
    ("karpenter_instancetype_", "Instance types"),
    ("karpenter_solver_", "Solver"),
    ("karpenter_consolidation_", "Consolidation"),
    ("karpenter_sim_", "Simulator"),
    ("karpenter_events_", "Event ledger"),
    ("karpenter_telemetry_", "Telemetry endpoint"),
    ("karpenter_store_", "Store server"),
    ("karpenter_service_", "Solver service"),
    ("karpenter_reconcile_", "Reconcile loop"),
    ("karpenter_slo_", "SLO engine"),
    ("karpenter_anomaly_", "Anomaly detection"),
    ("karpenter_flight_", "Flight recorder"),
    ("karpenter_device_", "Device observatory"),
]

# metric type / label set / movement semantics, rendered as a sub-line —
# the SAME catalog the live /metrics exposition renders HELP/TYPE from
# (metrics/catalog.py), so the doc and the wire can never disagree.
_DETAILS = METRIC_DETAILS


def collect(root: pathlib.Path) -> Dict[str, List[str]]:
    """metric name -> sorted list of emitting modules.  The generator
    itself and the metadata catalog are excluded: naming a metric to
    document it is not emitting it."""
    out: Dict[str, set] = defaultdict(set)
    excluded = {
        pathlib.Path(__file__).resolve(),
        (root / "metrics" / "catalog.py").resolve(),
    }
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts or path.resolve() in excluded:
            continue
        rel = path.relative_to(root.parent).as_posix()
        for name in _METRIC_RE.findall(path.read_text()):
            out[name].add(rel)
    return {k: sorted(v) for k, v in out.items()}


def render(root: pathlib.Path) -> str:
    metrics = collect(root)
    lines = [
        "# Metrics",
        "",
        "GENERATED by `python -m karpenter_tpu_torch.tools.gen_metrics_doc` — do",
        "not edit.  Mirrors the reference's generated metrics reference",
        "(hack/docs/metrics_gen_docs.go, website v0.31 concepts/metrics.md).",
        "",
        f"{len(metrics)} metric families.",
        "",
    ]
    def entry(n: str, mods) -> List[str]:
        out = [f"- `{n}` — {', '.join(f'`{m}`' for m in mods)}"]
        detail = _DETAILS.get(n)
        if detail is not None:
            mtype, labels, when = detail
            out.append(f"  - {mtype}, labels: {labels} — {when}")
        return out

    rest = dict(metrics)
    for prefix, title in _GROUPS:
        members = sorted(n for n in rest if n.startswith(prefix))
        if not members:
            continue
        lines += [f"## {title}", ""]
        for n in members:
            lines += entry(n, rest.pop(n))
        lines.append("")
    if rest:
        lines += ["## Other", ""]
        for n in sorted(rest):
            lines += entry(n, rest[n])
        lines.append("")
    return "\n".join(lines)


def main() -> None:
    pkg = pathlib.Path(__file__).resolve().parent.parent
    doc = pkg.parent / "docs" / "torch" / "metrics.md"
    doc.parent.mkdir(parents=True, exist_ok=True)
    doc.write_text(render(pkg))
    print(f"wrote {doc}")


if __name__ == "__main__":
    main()
