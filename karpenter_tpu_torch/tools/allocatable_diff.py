"""allocatable-diff: computed vs actual node resources, as CSV.

Re-creation of reference tools/allocatable-diff/main.go:60-140: for every
managed node, compare the instance-type provider's COMPUTED capacity and
allocatable (kubeReserved curve + VM memory overhead, the numbers the
scheduler packs against) with the node's ACTUAL registered status.  Drift
between the two means the packing model is wrong — pods that "fit" on
paper get stuck at the kubelet — so this is the calibration tool for the
vm_memory_overhead_percent setting (main.go's --overhead-percent flag).

Usage (against a live operator or the test Environment):

    from karpenter_tpu_torch.tools.allocatable_diff import diff_rows, write_csv
    rows = diff_rows(operator)
    write_csv(rows, "allocatable-diff.csv")

or ``python -m karpenter_tpu_torch.tools.allocatable_diff --out-file x.csv``
(runs against a fake-cloud environment for demonstration, its solver on
the card unless ``--device cpu`` is asked for; a real deployment
constructs the operator against its live backend first).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import List, Optional

from karpenter_tpu_torch.api import labels as L

# axes and units mirrored from the reference CSV (Mi / milli-cpu / Mi)
_HEADER_TOP = [
    "Instance Type",
    "Expected Capacity", "", "Expected Allocatable", "",
    "Actual Capacity", "", "Actual Allocatable", "",
    "Diff Allocatable", "",
]
_HEADER_SUB = [
    "",
    "Memory (Mi)", "CPU (m)", "Memory (Mi)", "CPU (m)",
    "Memory (Mi)", "CPU (m)", "Memory (Mi)", "CPU (m)",
    "Memory (Mi)", "CPU (m)",
]


@dataclass
class DiffRow:
    node: str
    instance_type: str
    expected_capacity_mem_mi: int
    expected_capacity_cpu_m: int
    expected_alloc_mem_mi: int
    expected_alloc_cpu_m: int
    actual_capacity_mem_mi: int
    actual_capacity_cpu_m: int
    actual_alloc_mem_mi: int
    actual_alloc_cpu_m: int

    @property
    def alloc_mem_diff_mi(self) -> int:
        """expected - actual: positive means the model OVERPROMISES
        (pods that fit on paper won't fit on the machine)."""
        return self.expected_alloc_mem_mi - self.actual_alloc_mem_mi

    @property
    def alloc_cpu_diff_m(self) -> int:
        return self.expected_alloc_cpu_m - self.actual_alloc_cpu_m


@dataclass
class DiffReport:
    rows: List[DiffRow]
    # managed nodes the sweep could NOT model (pool deleted, type gone
    # from the listing): themselves calibration findings, never silent
    skipped: List[str]

    def __iter__(self):
        return iter(self.rows)

    def __len__(self) -> int:
        return len(self.rows)


def _mi(v: float) -> int:
    return int(v / (1024 * 1024))


def _milli(v: float) -> int:
    return int(v * 1000)


def diff_rows(operator) -> "DiffReport":
    """One row per managed node, instance-type sorted (main.go:103-139).
    Nodes whose pool is gone or whose type is missing from the provider's
    current listing are collected in ``skipped`` instead of crashing the
    sweep (the reference log.Fatals; a calibration tool should report the
    rest of the fleet — and a type that left the listing is itself a
    finding)."""
    skipped: List[str] = []
    rows: List[DiffRow] = []
    nodes = [
        n
        for n in operator.kube.nodes.values()
        if n.labels.get(L.LABEL_NODEPOOL) and n.allocatable.get("memory")
    ]
    nodes.sort(key=lambda n: n.labels.get(L.LABEL_INSTANCE_TYPE, ""))
    # one listing per (pool, node-class) pair, reused across that pair's nodes
    listings = {}
    for node in nodes:
        pool = operator.kube.node_pools.get(node.labels.get(L.LABEL_NODEPOOL))
        if pool is None:
            skipped.append(node.name)
            continue
        nc = operator.kube.node_classes.get(pool.node_class_ref)
        key = (pool.name, getattr(nc, "name", None))
        if key not in listings:
            listings[key] = operator.instance_types.list(pool, nc)
        it = next(
            (
                t
                for t in listings[key]
                if t.name == node.labels.get(L.LABEL_INSTANCE_TYPE)
            ),
            None,
        )
        if it is None:
            skipped.append(node.name)
            continue
        alloc = it.allocatable()
        rows.append(
            DiffRow(
                node=node.name,
                instance_type=it.name,
                expected_capacity_mem_mi=_mi(it.capacity.get("memory")),
                expected_capacity_cpu_m=_milli(it.capacity.get("cpu")),
                expected_alloc_mem_mi=_mi(alloc.get("memory")),
                expected_alloc_cpu_m=_milli(alloc.get("cpu")),
                actual_capacity_mem_mi=_mi(node.capacity.get("memory")),
                actual_capacity_cpu_m=_milli(node.capacity.get("cpu")),
                actual_alloc_mem_mi=_mi(node.allocatable.get("memory")),
                actual_alloc_cpu_m=_milli(node.allocatable.get("cpu")),
            )
        )
    return DiffReport(rows=rows, skipped=skipped)


def write_csv(rows: List[DiffRow], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(_HEADER_TOP)
        w.writerow(_HEADER_SUB)
        for r in rows:
            w.writerow(
                [
                    r.instance_type,
                    r.expected_capacity_mem_mi, r.expected_capacity_cpu_m,
                    r.expected_alloc_mem_mi, r.expected_alloc_cpu_m,
                    r.actual_capacity_mem_mi, r.actual_capacity_cpu_m,
                    r.actual_alloc_mem_mi, r.actual_alloc_cpu_m,
                    r.alloc_mem_diff_mi, r.alloc_cpu_diff_m,
                ]
            )


def overpromised(rows: List[DiffRow]) -> List[DiffRow]:
    """Rows where the computed allocatable EXCEEDS the machine's actual —
    the dangerous direction (scheduler packs pods that cannot start)."""
    return [r for r in rows if r.alloc_mem_diff_mi > 0 or r.alloc_cpu_diff_m > 0]


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="allocatable-diff")
    parser.add_argument("--out-file", default="allocatable-diff.csv")
    parser.add_argument(
        "--overhead-percent", type=float, default=None,
        help="override vm_memory_overhead_percent for the computation",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the demonstration operator's solver runs (default: the "
        "card; 'cpu' for the plain version)",
    )
    args = parser.parse_args(argv)

    # demonstration harness: a fake-cloud environment with a small fleet;
    # real deployments build Operator against their live backend instead
    from karpenter_tpu_torch.api import Pod, Resources, Settings
    from karpenter_tpu_torch.testing import Environment

    settings = Settings()
    if args.overhead_percent is not None:
        settings.vm_memory_overhead_percent = args.overhead_percent
    env = Environment(settings=settings, device=args.device)
    env.default_node_class()
    env.default_node_pool()
    for _ in range(8):
        env.kube.put_pod(Pod(requests=Resources(cpu=2, memory="4Gi")))
    env.settle()
    report = diff_rows(env.operator)
    write_csv(report.rows, args.out_file)
    bad = overpromised(report.rows)
    print(f"{len(report.rows)} nodes written to {args.out_file}; "
          f"{len(bad)} overpromised; {len(report.skipped)} skipped")
    for name in report.skipped:
        print(f"  skipped (unmodelable): {name}")
    return 1 if bad or report.skipped else 0


if __name__ == "__main__":
    raise SystemExit(main())
