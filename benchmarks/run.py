"""Run one cell of the benchmark once.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed and warms up every call its
traffic makes; the window then drives the program for ``--seconds``;
afterwards the program's state is freed and a seeded sample of the
window's answers is held to the plain reference.  With ``--trace 0`` the
result line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a torch.profiler trace of the window.  The
last line of standard output is the result; the numbers the check
compared, each with its limit, are the last lines of standard error.

A run needs an NVIDIA card: without one it exits 2 and prints no result.
It exits 1, naming them, if JAX or the JAX package was loaded.
``--control 1`` puts the reference with one of the configuration's
guarantees broken in the program's place in the check (the control that
the check has to fail): memory requests dropped in the solve cells, each
pod's nodeSelector dropped in the admission cell, a removal's pods solved
onto new nodes alone (the rest of the cluster's room unused) in the what-if
cell.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device: str, t_start: float, card: dict, manifest=None) -> dict:
    """Set-up, window and check of one cell on ``device``; the result line
    as a dict with the check's numbers under ``checks``."""
    import torch

    from benchmarks import harness as H
    from benchmarks.drivers import DRIVERS

    cell = H.Cell(args.workload, manifest)
    driver = DRIVERS[cell.traffic["driver"]](cell, args.seed, device, bool(args.trace))
    t_setup = time.perf_counter()
    driver.setup()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    with H.Window(args.seconds, trace=bool(args.trace)) as win:
        driver.window(win)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"loaded {', '.join(leaked)}: the port's run must not load JAX "
                         "or the JAX package")
    attempted, failed = driver.attempted(win)
    driver.free()
    t_check = time.perf_counter()
    checks = driver.check(bool(args.control))
    check_s = time.perf_counter() - t_check
    correct = all(limit is None or value <= limit for _, value, limit in checks)
    run = H.Run(win, driver.bounds)
    if args.trace:
        metrics = H.per_layer(cell, run)
    else:
        values = {"setup_s": setup_s, **driver.end_to_end(win)}
        metrics = {m["name"]: H.metric(values[m["name"]], m["unit"]) for m in cell.end_to_end}
    dev = dict(card, memory_peak_bytes=int(peak))
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if args.trace:
        dev.update(busy_s=run.busy_s(), window_s=run.window_s)
        if run.trace is not None:
            out["breakdown"] = run.trace.breakdown(run.calls, run.held, run.lo, run.hi)
    out["harness"] = {"calls": len(win.calls), "held_s": win.held_s, "check_s": check_s,
                      "gc_s": sum(win.gc_pauses), "imports_s": t_setup - t_start,
                      "inputs_s": driver.build_s,
                      "warmup_s": setup_s - (t_setup - t_start) - driver.build_s,
                      "call_ms_quartiles": [1e3 * q for q in H.quartiles([c["s"] for c in win.calls])],
                      "phase_ms": H.phase_means(win.calls)}
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmarks import harness as H

    chips = H.Cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} NVIDIA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    out = run_cell(args, "cuda", T_START, card)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
