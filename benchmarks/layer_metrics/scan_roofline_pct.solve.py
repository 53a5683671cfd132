"""The kernels: the solve's picked scan's least time (roofline/ffd_scan.py)
over its device time in the trace, over the solves the check re-derived."""

EXCLUDED = ("batched", "window", "fleet", "shard")


def picked_scan(name: str) -> bool:
    return "ffd_scan" in name and not any(x in name for x in EXCLUDED)


def read(run):
    return run.roofline_pct("ffd_scan", picked_scan)
