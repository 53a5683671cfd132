"""Load harness: the vectorized traffic plane for the simulator.

Scales the deterministic simulator (karpenter_tpu_torch/sim/) to millions of
pod events without the generator or the invariant suite becoming the
bottleneck:

- `generators.py` — columnar event tapes: whole scenario timelines as
  numpy column arrays built in one seeded pass, materialized into
  `SimEvent`s lazily per tick.  Byte-identical to hand-written per-event
  twins on shared seeds (the parity contract).
- `invariants.py` — `VectorInvariantChecker`: the per-tick invariant
  suite as array ops over interned id columns, emitting the exact same
  `Violation` strings as the scalar `sim/invariants.py` plane.
- `corpus.py` — production scenario corpus: the BASELINE.md scale
  anchors, gang/TPU-slice jobs, spot price shocks, capacity droughts,
  rolling catalog deprecations, and the million-event throughput run.
- `sketch.py` — deterministic streaming percentile sketches feeding the
  fleet-level section of the SLO report.

Nothing here imports eagerly from `sim/` at package-import time beyond
the workload/invariant base classes, and `corpus` is only imported by
the sim entry points (CLI, `run_scenario`, `replay`) — keeping the
`sim -> load -> sim` edges acyclic.
"""
