"""Production scenario corpus: the load harness's scale and correctness
anchors, registered in the sim CLI alongside the classic scenarios.

All traffic here is TAPE-DRIVEN (columnar specs, load/generators.py) —
the corpus is where the vectorized traffic plane runs in production
form, not just in parity tests.

Scale anchors (BASELINE.md, reference `provisioning_test.go`):

- `anchor-500-antiaffinity[-smoke]` — N pods with self-selecting
  hostname anti-affinity, forcing exactly N single-pod nodes (the
  reference's 500-node / 500-pod anchor, 30-minute SpecTimeout -> our
  time-to-settle budget on the simulated clock).
- `anchor-6600-density[-smoke]` — N tiny pods on a one-shape catalog
  whose `max_pods=110` is the binding constraint, forcing N/110 dense
  nodes (the reference's 6,600-pod / 60-node anchor).

The full-size anchors take minutes of wall time and are exercised by
`slow`-marked tests; the `-smoke` variants shrink only the pod counts
(same shapes, same invariants, same budgets) and run in tier 1.

Correctness/chaos anchors:

- `gang-slice` — a multi-host TPU-slice gang (zone co-location +
  hostname anti-affinity, GANG_LABEL-tagged) landing during a
  cross-zone capacity drought; the gang-atomic invariant proves the
  slice lands all-or-nothing.
- `spot-shock-drought` — spot price shocks plus an AZ capacity drought
  over churning lifetimed arrivals.
- `catalog-deprecations` — rolling image generations where each old
  generation is deprecated away (image_deprecate), driving drift.
- `million-events` — the throughput anchor: lifetimed Poisson arrivals
  sized so a full bench run applies >= 1M pod events, checked on the
  vectorized invariant plane.  `bench.py:run_load_harness` asserts the
  harness (generation + invariant checks) stays under 20% of wall.
"""

from __future__ import annotations

from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.cloud.fake.backend import MachineShape
from karpenter_tpu_torch.load.generators import (
    CInterruptionStorm,
    CPodBurst,
    CScript,
    CSteady,
    EventTape,
)
from karpenter_tpu_torch.obs.slo import SLORule
from karpenter_tpu_torch.sim.invariants import GANG_LABEL, GANG_SIZE_LABEL
from karpenter_tpu_torch.sim.runner import Scenario, scenario

# a scripted tick-0 budget freeze: the anchors measure PROVISIONING
# against their settle budgets, so voluntary disruption (consolidation
# churning nodes mid-wave) is pinned off, like the reference scale
# suites which assert provisioning only
_FREEZE_BUDGETS = {0: [("pool_update", {"pool": "default", "budgets": ["0"]})]}


def _anti_affinity_anchor(total: int, per_tick: int, budget_s: float):
    def factory(seed: int, ticks: int) -> EventTape:
        return EventTape(
            seed,
            ticks,
            [
                CScript(_FREEZE_BUDGETS),
                CPodBurst(
                    total=total,
                    per_tick=per_tick,
                    start=0,
                    cpu=0.5,
                    mem_gib=0.5,
                    prefix="anchor",
                    labels={"sim/anchor": "hostile"},
                    affinity=[
                        {
                            "topology_key": L.LABEL_HOSTNAME,
                            "match_labels": {"sim/anchor": "hostile"},
                            "anti": True,
                        }
                    ],
                ),
            ],
        )

    return Scenario(
        "",
        tape_factory=factory,
        tick_s=15.0,
        schedule_deadline_s=budget_s,
        settle_budget_s=budget_s,
    )


@scenario(
    "anchor-500-antiaffinity",
    "BASELINE scale anchor: 500 pods x hostname anti-affinity -> 500 "
    "nodes inside a 30-minute settle budget (slow; smoke variant below)",
)
def _anchor_500(ticks: int) -> Scenario:
    return _anti_affinity_anchor(total=500, per_tick=50, budget_s=1800.0)


@scenario(
    "anchor-500-antiaffinity-smoke",
    "tier-1 smoke shape of the 500-node anchor: 24 pods -> 24 nodes",
)
def _anchor_500_smoke(ticks: int) -> Scenario:
    return _anti_affinity_anchor(total=24, per_tick=12, budget_s=600.0)


def _dense_shapes():
    # one shape, deliberately cpu/memory-roomy so `max_pods=110` is the
    # binding constraint — the anchor proves pod-slot packing, not
    # resource packing
    return [
        MachineShape(
            name="dense-110",
            cpu=64.0,
            memory=256 * 2**30,
            od_price=2.0,
        )
    ]


def _density_anchor(total: int, per_tick: int, budget_s: float):
    def factory(seed: int, ticks: int) -> EventTape:
        return EventTape(
            seed,
            ticks,
            [
                CScript(_FREEZE_BUDGETS),
                CPodBurst(
                    total=total,
                    per_tick=per_tick,
                    start=0,
                    cpu=0.4,
                    mem_gib=0.5,
                    prefix="dense",
                ),
            ],
        )

    return Scenario(
        "",
        tape_factory=factory,
        shapes=_dense_shapes(),
        tick_s=15.0,
        schedule_deadline_s=budget_s,
        settle_budget_s=budget_s,
    )


@scenario(
    "anchor-6600-density",
    "BASELINE scale anchor: 6,600 tiny pods at 110 pods/node -> 60 dense "
    "nodes inside a 30-minute settle budget (slow; smoke variant below)",
)
def _anchor_6600(ticks: int) -> Scenario:
    return _density_anchor(total=6600, per_tick=660, budget_s=1800.0)


@scenario(
    "anchor-6600-density-smoke",
    "tier-1 smoke shape of the density anchor: 220 pods -> 2 nodes",
)
def _anchor_6600_smoke(ticks: int) -> Scenario:
    return _density_anchor(total=220, per_tick=110, budget_s=600.0)


@scenario(
    "gang-slice",
    "a multi-host TPU-slice gang (zone co-location + hostname "
    "anti-affinity) lands during a cross-zone capacity drought; the "
    "gang-atomic invariant proves all-or-nothing placement",
)
def _gang_slice(ticks: int) -> Scenario:
    drought = 2
    recover = max(drought + 10, min(ticks - 5, 24))

    def factory(seed: int, ticks_: int) -> EventTape:
        gang = {GANG_LABEL: "slice-a", GANG_SIZE_LABEL: "8"}
        return EventTape(
            seed,
            ticks_,
            [
                CScript(
                    {
                        **_FREEZE_BUDGETS,
                        drought: [
                            ("az_down", {"zone": "zone-b"}),
                            ("az_down", {"zone": "zone-c"}),
                        ],
                        recover: [
                            ("az_up", {"zone": "zone-b"}),
                            ("az_up", {"zone": "zone-c"}),
                        ],
                    }
                ),
                CSteady(rate=0.3, prefix="bg"),
                # the slice arrives mid-drought: every host must come
                # from the one zone left standing
                CPodBurst(
                    total=8,
                    per_tick=8,
                    start=5,
                    cpu=2.0,
                    mem_gib=4.0,
                    prefix="slice",
                    labels=gang,
                    affinity=[
                        {
                            "topology_key": L.LABEL_ZONE,
                            "match_labels": {GANG_LABEL: "slice-a"},
                        },
                        {
                            "topology_key": L.LABEL_HOSTNAME,
                            "match_labels": {GANG_LABEL: "slice-a"},
                            "anti": True,
                        },
                    ],
                ),
            ],
        )

    return Scenario("", tape_factory=factory, settle_budget_s=900.0)


@scenario(
    "spot-shock-drought",
    "spot prices spike 4x, an AZ dries up, prices collapse after "
    "recovery — lifetimed churn keeps the fleet moving throughout",
)
def _spot_shock_drought(ticks: int) -> Scenario:
    shock = max(4, ticks // 8)
    drought = shock + 3
    recover = min(max(drought + 8, ticks // 2), max(drought + 1, ticks - 5))
    collapse = recover + 4

    def factory(seed: int, ticks_: int) -> EventTape:
        return EventTape(
            seed,
            ticks_,
            [
                CScript(
                    {
                        shock: [("price_shock", {"factor": 4.0})],
                        drought: [("az_down", {"zone": "zone-b"})],
                        recover: [("az_up", {"zone": "zone-b"})],
                        collapse: [
                            ("price_shock", {"factor": 0.25, "zone": "zone-a"})
                        ],
                    }
                ),
                CSteady(rate=0.6, lifetime=(3, 8), prefix="sd"),
                CInterruptionStorm(
                    start=drought, duration=5, per_tick=1
                ),
            ],
        )

    return Scenario(
        "",
        tape_factory=factory,
        slo_rules=[
            SLORule(
                name="pending-pod-age", signal="pending_pod_age_max",
                threshold=60.0, op=">", budget=0.1,
                fast_window_s=20.0, slow_window_s=60.0,
                description="pods must nominate within a simulated minute",
            ),
        ],
    )


@scenario(
    "catalog-deprecations",
    "rolling catalog: new image generations appear and old ones are "
    "deprecated away, so resolved AMIs keep moving and drift churns the "
    "fleet at the disruption budget's pace",
)
def _catalog_deprecations(ticks: int) -> Scenario:
    first = max(5, ticks // 4)
    second = max(first + 5, ticks // 2)

    def factory(seed: int, ticks_: int) -> EventTape:
        return EventTape(
            seed,
            ticks_,
            [
                CScript(
                    {
                        first: [
                            ("image_roll", {"id": "image-standard-amd64-v2"}),
                            ("image_deprecate", {"id": "image-standard-amd64"}),
                        ],
                        second: [
                            ("image_roll", {"id": "image-standard-amd64-v3"}),
                            (
                                "image_deprecate",
                                {"id": "image-standard-amd64-v2"},
                            ),
                        ],
                    }
                ),
                CSteady(rate=0.5, lifetime=(5, 15), prefix="cd"),
            ],
        )

    return Scenario("", tape_factory=factory)


# sized so a full-scale bench run (850 ticks) applies >= 1M pod events:
# ~620 creates/tick plus almost as many lifetimed deletes
_MILLION_RATE = 620.0


@scenario(
    "million-events",
    "the throughput anchor: ~1.05M lifetimed pod events over 850 ticks, "
    "invariants on the vectorized plane — bench.py:run_load_harness "
    "asserts the harness share of wall time stays under 20%",
)
def _million_events(ticks: int) -> Scenario:
    def factory(seed: int, ticks_: int) -> EventTape:
        return EventTape(
            seed,
            ticks_,
            [
                CScript(_FREEZE_BUDGETS),
                CSteady(
                    rate=_MILLION_RATE,
                    cpus=(0.25, 0.5),
                    mem_gib=0.5,
                    lifetime=(2, 6),
                    prefix="m",
                ),
            ],
        )

    return Scenario(
        "",
        tape_factory=factory,
        vector_invariants=True,
        # the live set is bounded (~rate x mean lifetime), but each tick
        # lands hundreds of pods — give scheduling headroom on the
        # 1s-tick clock
        schedule_deadline_s=420.0,
    )
