"""Cells at a size a CPU test run holds: the manifest's own cells and the
parked ones, with their configurations cut to a few hundred pending pods
and a few dozen live nodes, run through the harness on the CPU (the look for a card
skipped), with faults planted in the program where a test asks."""

from __future__ import annotations

import json
import time
from pathlib import Path

from benchmarks import harness as H
from benchmarks import run as RUN

PODS, NODES = 400, 60
CARD = {"platform": "cpu", "kind": "cpu", "count": 1}
# cells whose drivers and traffic are here but which the manifest does not
# run (their end-to-end metrics spread past what a bound may take); the
# CPU tests still drive them
PARKED = [
    {"name": "live500-solve-cold", "config": "hetero300-live500", "traffic": "solve-cold",
     "chips": 1},
    {"name": "live5k-solve-warm", "config": "hetero300-live5k", "traffic": "solve-warm",
     "chips": 1},
]


def manifest(tmp: Path, pods: int = PODS, nodes: int = NODES) -> dict:
    m = H.load_json(H.MANIFEST)
    names = {w["name"] for w in m["workloads"]}
    m["workloads"] += [w for w in PARKED if w["name"] not in names]
    for c in m["configs"]:
        cfg = H.load_json(H.ROOT / c["file"])
        cfg["pending"]["pods"] = pods
        cfg["cluster"]["nodes"] = nodes
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return m


def run(tmp: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 2.0,
        trace: int = 0, control: int = 0, **size) -> dict:
    args = RUN.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace), "--control", str(control)])
    return RUN.run_cell(args, "cpu", time.perf_counter(), CARD, manifest=manifest(tmp, **size))
