"""Declarative SLO rule engine with multi-window burn-rate evaluation.

Karpenter's production contract is metrics-driven alerting — the
reference's docs tell operators to page on pending-pod age and disruption
rate (website v0.31 concepts/metrics.md) — but the telemetry plane
only *published* signals; nothing consumed them.  This engine closes the
loop: the Operator evaluates a rule set once per reconcile tick, on the
injected Clock, against the metrics registry the controllers already
write, and raises/clears alerts deterministically.

Mechanics (the SRE-workbook multi-window burn-rate shape, discretized to
reconcile ticks):

- a rule names a **signal** (a registered read over the registry:
  ``tick_duration_p99``, ``pending_pod_age_max``, ``circuits_open``, ...),
  a **threshold** with a comparison direction, and a **budget** — the
  fraction of time the signal is allowed to violate the threshold;
- each evaluation appends (now, violating?) to the rule's history and
  computes the violating time over a **fast** and a **slow** window;
  ``burn = (violating / window span) / budget`` (a budget of 0 means
  zero tolerance: any violation saturates the burn at BURN_CAP);
- a rule **breaches** when BOTH windows burn at >= 1 (the fast window
  pages, the slow window confirms it is not a blip) and **recovers**
  when the fast window drops back under 1;
- transitions emit ``SLOBreach`` / ``SLORecovered`` ledger events
  (stamped with the tick's trace ID like every other decision) and bump
  ``karpenter_slo_breaches_total{rule}``; every evaluation exports
  ``karpenter_slo_status{rule}`` and
  ``karpenter_slo_burn_rate{rule,window}``.

Everything is a pure function of the injected clock and the registry, so
the simulator evaluates scenario-declared rules and replays the breach/
recovery ledger lines byte-identically (tests/test_diagnosis.py).  Rules
are configured through ``Settings.slo_rules`` (and the chart's settings
values): per-rule overrides of threshold/budget/windows/enabled merged
over the defaults below, or entirely new rules naming a signal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.utils.clock import Clock

# burn saturation for zero-budget rules (any violation of a must-stay-0
# signal is an instant page; infinity would not round-trip through gauges)
BURN_CAP = 1000.0


# ----------------------------------------------------------------- signals
def _gauge_family_max(registry: Registry, name: str) -> Optional[float]:
    series = registry.gauges.get(name)
    if not series:
        return None
    return max(series.values())


_TICK_P99_MIN_SAMPLES = 30
_TICK_P99_WINDOW = 64


def _tick_duration_p99(registry: Registry) -> Optional[float]:
    """p99 of the last 64 tick durations, after a 30-tick startup grace:
    a paging signal must describe the cluster NOW, and the first ticks'
    kernel builds (seconds, by design) would otherwise pin the lifetime
    p99 above any sane threshold for hours."""
    from karpenter_tpu_torch.metrics.registry import _nearest_rank

    h = registry.histograms.get(
        "karpenter_reconcile_tick_duration_seconds", {}
    ).get(())
    if h is None or h.count < _TICK_P99_MIN_SAMPLES:
        return None
    window = list(h.samples)[-_TICK_P99_WINDOW:]
    return _nearest_rank(sorted(window), 0.99)


def _pending_pod_age_max(registry: Registry) -> Optional[float]:
    return registry.gauge("karpenter_pods_pending_age_seconds")


def _verdict_mismatches(registry: Registry) -> Optional[float]:
    return registry.counter("karpenter_consolidation_verdict_mismatch_total")


def _circuits_open(registry: Registry) -> Optional[float]:
    """Count of cloud APIs whose circuit breaker is OPEN (state 2) right
    now; HALF_OPEN probes count as recovering, not violating."""
    series = registry.gauges.get("karpenter_cloud_api_circuit_state")
    if series is None:
        return 0.0
    return float(sum(1 for v in series.values() if v >= 2.0))


def _compile_cache_hit_rate(registry: Registry) -> Optional[float]:
    """Lifetime hit rate across consumers; None until the sample is big
    enough to mean anything (a cold process always starts with misses)."""
    hits = sum(
        registry.counters.get(
            "karpenter_solver_compile_cache_hits_total", {}
        ).values()
    )
    misses = sum(
        registry.counters.get(
            "karpenter_solver_compile_cache_misses_total", {}
        ).values()
    )
    total = hits + misses
    if total < 20:
        return None
    return hits / total


def _provider_staleness_max(registry: Registry) -> Optional[float]:
    return _gauge_family_max(registry, "karpenter_provider_cache_stale_seconds")


SIGNALS: Dict[str, Callable[[Registry], Optional[float]]] = {
    "tick_duration_p99": _tick_duration_p99,
    "pending_pod_age_max": _pending_pod_age_max,
    "verdict_mismatches": _verdict_mismatches,
    "circuits_open": _circuits_open,
    "compile_cache_hit_rate": _compile_cache_hit_rate,
    "provider_staleness_max": _provider_staleness_max,
}


# ------------------------------------------------------------------- rules
@dataclass
class SLORule:
    """One declarative rule: signal OP threshold may hold for at most
    ``budget`` of the time, judged over a fast (paging) and a slow
    (confirming) window."""

    name: str
    signal: str  # key into SIGNALS
    threshold: float
    op: str = ">"  # violation when `signal op threshold` ('<' for floors)
    budget: float = 0.1
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    enabled: bool = True
    description: str = ""

    def violated(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == "<":
            return value < self.threshold
        raise ValueError(f"rule {self.name}: unknown op {self.op!r}")


# defaults: the production signal set.  Budgets/windows
# are deliberately conservative — alerts should be rare and credible.
DEFAULT_RULES: Dict[str, dict] = {
    "tick-duration-p99": dict(
        signal="tick_duration_p99", threshold=1.0, op=">", budget=0.1,
        fast_window_s=60.0, slow_window_s=300.0,
        description="reconcile tick p99 wall time must stay under 1s",
    ),
    "pending-pod-age": dict(
        signal="pending_pod_age_max", threshold=300.0, op=">", budget=0.1,
        fast_window_s=60.0, slow_window_s=300.0,
        description="no pod may sit pending un-nominated for 5 minutes",
    ),
    "verdict-mismatch": dict(
        signal="verdict_mismatches", threshold=0.0, op=">", budget=0.0,
        fast_window_s=60.0, slow_window_s=300.0,
        description="batched consolidation verdicts must never disagree "
        "with the sequential oracle",
    ),
    "cloud-circuit-open": dict(
        signal="circuits_open", threshold=0.0, op=">", budget=0.05,
        fast_window_s=60.0, slow_window_s=300.0,
        description="cloud-API circuit breakers may be open at most 5% "
        "of the time",
    ),
    "compile-cache-hit-rate": dict(
        signal="compile_cache_hit_rate", threshold=0.5, op="<", budget=0.25,
        fast_window_s=120.0, slow_window_s=600.0,
        description="a warm cluster's solver compile cache should mostly "
        "hit; a sustained miss storm means in-place mutation or catalog "
        "churn",
    ),
    "provider-staleness": dict(
        signal="provider_staleness_max", threshold=600.0, op=">", budget=0.1,
        fast_window_s=120.0, slow_window_s=600.0,
        description="degraded providers may serve last-good data, but not "
        "10-minute-old data for long",
    ),
}


def default_rules(settings=None) -> List[SLORule]:
    """The default rule set with ``settings.slo_rules`` overrides merged
    in: ``{rule-name: {threshold|budget|fast_window_s|slow_window_s|
    enabled|op|signal|description: ...}}``.  Overriding an unknown rule
    name CREATES a rule and must therefore carry ``signal``; naming an
    unknown signal is an error either way."""
    overrides: Dict[str, dict] = dict(getattr(settings, "slo_rules", {}) or {})
    rules: List[SLORule] = []
    for name, kw in DEFAULT_RULES.items():
        merged = {**kw, **overrides.pop(name, {})}
        rules.append(SLORule(name=name, **merged))
    for name, kw in sorted(overrides.items()):
        if "signal" not in kw:
            raise ValueError(
                f"slo rule {name!r} is not a default rule, so its override "
                "must name a signal"
            )
        kw = dict(kw)
        if "threshold" not in kw:
            raise ValueError(f"slo rule {name!r} needs a threshold")
        rules.append(SLORule(name=name, **kw))
    for rule in rules:
        if rule.signal not in SIGNALS:
            raise ValueError(
                f"slo rule {rule.name!r}: unknown signal {rule.signal!r} "
                f"(have {sorted(SIGNALS)})"
            )
        if not (0.0 <= rule.budget <= 1.0):
            raise ValueError(f"slo rule {rule.name!r}: budget must be in [0,1]")
        if rule.fast_window_s <= 0 or rule.slow_window_s < rule.fast_window_s:
            raise ValueError(
                f"slo rule {rule.name!r}: need slow_window_s >= "
                "fast_window_s > 0"
            )
    return rules


# ------------------------------------------------------------------ engine
@dataclass
class _RuleState:
    # (ts, dt_covered, violating) samples, oldest first, pruned to the
    # slow window; dt is the interval since the previous evaluation, so
    # jittered tick cadences weight correctly
    history: List[Tuple[float, float, bool]] = field(default_factory=list)
    last_eval: Optional[float] = None
    breached: bool = False
    breached_at: float = 0.0
    breaches: int = 0
    recoveries: int = 0
    breached_total_s: float = 0.0


class SLOEngine:
    """Evaluates a rule set once per reconcile tick.  Deterministic by
    construction: state advances only on `evaluate()`, timestamps come
    from the injected clock, signals read the registry."""

    def __init__(
        self,
        registry: Registry,
        clock: Clock,
        rules: Optional[List[SLORule]] = None,
    ):
        self.registry = registry
        self.clock = clock
        self.rules: List[SLORule] = list(rules or [])
        self._states: Dict[str, _RuleState] = {}

    def replace_rules(self, rules: List[SLORule]) -> None:
        """Swap the rule set and drop accumulated state (the simulator
        installs scenario-declared rules on a fresh operator)."""
        self.rules = list(rules)
        self._states.clear()

    # ------------------------------------------------------------- evaluate
    def _burn(
        self, rule: SLORule, state: _RuleState, now: float, window_s: float
    ) -> float:
        """Burn = (violating time / WINDOW SPAN) / budget.  Normalizing
        by the window, not by covered history, is what lets the slow
        window actually confirm: a freshly (re)started engine has seen
        only seconds of history, and dividing by that sliver would
        saturate both windows on the first violating tick — paging
        instantly on what may be a blip, exactly what multi-window burn
        rates exist to prevent.  Short history therefore UNDER-counts,
        which errs toward credible alerts."""
        lo = now - window_s
        violating = 0.0
        for ts, dt, bad in state.history:
            if not bad:
                continue
            # the sample's interval is (ts - dt, ts]; clip to the window
            overlap = min(ts, now) - max(ts - dt, lo)
            if overlap > 0.0:
                violating += overlap
        if rule.budget <= 0.0:
            # zero tolerance: any violating time in the window — or a
            # zero-duration first sample violating right now — pages
            last = state.history[-1] if state.history else None
            instant_bad = last is not None and last[2] and last[0] >= lo
            return BURN_CAP if (violating > 0.0 or instant_bad) else 0.0
        return min(BURN_CAP, violating / window_s / rule.budget)

    def evaluate(self) -> List[str]:
        """One evaluation pass over every enabled rule; returns the names
        of rules that NEWLY breached this pass (the operator's flight
        recorder dumps on a non-empty return)."""
        now = self.clock.now()
        newly_breached: List[str] = []
        for rule in self.rules:
            if not rule.enabled:
                continue
            value = SIGNALS[rule.signal](self.registry)
            state = self._states.setdefault(rule.name, _RuleState())
            if value is None:
                # no data yet: the rule cannot be judged; advance the
                # eval mark so a later first sample doesn't claim hours
                state.last_eval = now
                continue
            bad = rule.violated(value)
            dt = now - state.last_eval if state.last_eval is not None else 0.0
            state.history.append((now, max(0.0, dt), bad))
            state.last_eval = now
            lo = now - rule.slow_window_s
            while state.history and state.history[0][0] < lo:
                state.history.pop(0)
            fast = self._burn(rule, state, now, rule.fast_window_s)
            slow = self._burn(rule, state, now, rule.slow_window_s)
            if state.breached:
                state.breached_total_s += max(0.0, dt)
            self.registry.set(
                "karpenter_slo_burn_rate", round(fast, 6),
                {"rule": rule.name, "window": "fast"},
            )
            self.registry.set(
                "karpenter_slo_burn_rate", round(slow, 6),
                {"rule": rule.name, "window": "slow"},
            )
            if not state.breached and fast >= 1.0 and slow >= 1.0:
                state.breached = True
                state.breached_at = now
                state.breaches += 1
                newly_breached.append(rule.name)
                self.registry.inc(
                    "karpenter_slo_breaches_total", {"rule": rule.name}
                )
                self.registry.event(
                    "SLOBreach",
                    rule=rule.name,
                    signal=rule.signal,
                    value=round(value, 6),
                    threshold=rule.threshold,
                    burn_fast=round(fast, 6),
                    burn_slow=round(slow, 6),
                )
            elif state.breached and fast < 1.0:
                state.breached = False
                state.recoveries += 1
                self.registry.event(
                    "SLORecovered",
                    rule=rule.name,
                    signal=rule.signal,
                    value=round(value, 6),
                    breached_s=round(now - state.breached_at, 6),
                )
            self.registry.set(
                "karpenter_slo_status",
                1.0 if state.breached else 0.0,
                {"rule": rule.name},
            )
        return newly_breached

    # --------------------------------------------------------------- report
    def report(self) -> dict:
        """Deterministic per-rule summary for the sim's SLO report: breach
        and recovery counts, final status, total time spent breached."""
        rules = {}
        for rule in self.rules:
            state = self._states.get(rule.name, _RuleState())
            rules[rule.name] = {
                "breaches": state.breaches,
                "recoveries": state.recoveries,
                "status": "breached" if state.breached else "ok",
                "breached_s": round(state.breached_total_s, 6),
            }
        return {"rules": rules}
