"""Streaming anomaly detection over the per-phase latency series.

The phase histograms (``karpenter_solver_phase_seconds``,
``karpenter_consolidation_phase_seconds``, tick durations) say where time
went; this detector says when that changed.  Once per reconcile tick the
operator calls :meth:`AnomalyDetector.scan`, which walks the samples each
watched series gained since the last scan and compares every new
observation against a rolling ROBUST baseline of that series — median and
MAD (median absolute deviation), so a single earlier spike cannot inflate
the baseline the way a mean/stddev would.

A sample is anomalous when all of these hold (belt and suspenders — phase
latencies are noisy at the sub-millisecond floor):

- its robust z-score ``(v - median) / (1.4826 * MAD)`` exceeds
  ``z_threshold`` (MAD of 0 on a flat baseline falls back to a fraction
  of the median so a step change still scores),
- it exceeds ``min_abs_s`` absolutely (microsecond jitter never pages),
- it exceeds twice the median (the magnitude a human would call a blowup),
- the baseline holds at least ``min_baseline`` samples (cold series are
  unjudgeable),
- the series is outside its per-series cooldown (injected clock), so a
  sustained regression reads as one attributed event per cooldown window,
  not a firehose.

Detections emit ``AnomalyDetected`` ledger events carrying the
attribution a reader needs — which series/phase, baseline vs
observed, magnitude — so "catalog roll → compile storm → dispatch p99
blowup" is a ledger fact, and bump
``karpenter_anomaly_detected_total{series,phase}``.

The detector itself reads no wall clock (cooldowns ride the injected
Clock; determinism given a deterministic observation stream), but the
latency VALUES it watches are host wall time — so the simulator disables
it (``ScenarioRunner`` determinism knob) the same way it pins
launch concurrency: byte-identical traces cannot include judgments about
host speed.
"""

from __future__ import annotations

import statistics
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from karpenter_tpu_torch.metrics.registry import Registry
from karpenter_tpu_torch.utils.clock import Clock

# the latency families worth watching: solver phases, consolidation
# batch phases, whole-tick durations
WATCHED_FAMILIES = (
    "karpenter_solver_phase_seconds",
    "karpenter_consolidation_phase_seconds",
    "karpenter_consolidation_search_phase_seconds",
    "karpenter_reconcile_tick_duration_seconds",
    # device observatory: a compile-time blowup (recompile storm, a jit
    # suddenly retracing every tick) judges exactly like a phase blowup
    "karpenter_device_compile_seconds",
    # store plane: the client half's per-RPC latency (state/remote.py)
    # — a store server falling over shows up here first, per method
    "karpenter_store_rpc_seconds",
    # admission path split (controllers/provisioning.py): the fast
    # path's pod->nomination latency blowing up — or the batch series
    # absorbing traffic the fast path used to take — judges exactly
    # like a phase blowup, attributed per path label
    "karpenter_admission_latency_seconds",
    # solver service: per-tenant solve-wait blowing up (backpressure,
    # a noisy neighbor monopolizing the batch window) judges like a
    # phase blowup, attributed per tenant label
    "karpenter_service_solve_wait_seconds",
)

_MAD_SCALE = 1.4826  # MAD -> stddev-equivalent under normality


def robust_baseline(samples) -> Tuple[float, float]:
    """(median, scale) of a sample window: scale is the MAD-derived
    stddev equivalent, floored at 10% of the median so a perfectly flat
    baseline (MAD 0) still yields a finite z for a step change."""
    med = statistics.median(samples)
    mad = statistics.median(abs(x - med) for x in samples)
    return med, max(_MAD_SCALE * mad, 0.1 * abs(med), 1e-9)


class AnomalyDetector:
    def __init__(
        self,
        registry: Registry,
        clock: Clock,
        enabled: bool = True,
        window: int = 64,
        z_threshold: float = 6.0,
        min_abs_s: float = 0.01,
        min_baseline: int = 8,
        cooldown_s: float = 60.0,
    ):
        self.registry = registry
        self.clock = clock
        self.enabled = enabled
        self.window = window
        self.z_threshold = z_threshold
        self.min_abs_s = min_abs_s
        self.min_baseline = min_baseline
        self.cooldown_s = cooldown_s
        self._consumed: Dict[Tuple[str, Tuple], int] = {}
        self._baselines: Dict[Tuple[str, Tuple], Deque[float]] = {}
        self._last_emit: Dict[Tuple[str, Tuple], float] = {}

    def scan(self) -> List[dict]:
        """Judge every sample the watched series gained since the last
        scan; returns the detections (also emitted as ledger events)."""
        if not self.enabled:
            return []
        now = self.clock.now()
        out: List[dict] = []
        for name in WATCHED_FAMILIES:
            for labels, hist in self.registry.histograms.get(name, {}).items():
                key = (name, labels)
                seen = self._consumed.get(key, 0)
                fresh_n = hist.count - seen
                self._consumed[key] = hist.count
                if fresh_n <= 0:
                    continue
                # the sample window may have evicted very old entries;
                # everything still present and newer than `seen` is fresh
                samples = list(hist.samples)
                fresh = samples[-min(fresh_n, len(samples)):]
                baseline = self._baselines.setdefault(
                    key, deque(maxlen=self.window)
                )
                phase = labels[0][1] if labels else ""
                for v in fresh:
                    det = self._judge(key, name, phase, baseline, v, now)
                    if det is not None:
                        out.append(det)
                    baseline.append(v)
        return out

    def _judge(
        self, key, name: str, phase: str, baseline, v: float, now: float
    ) -> Optional[dict]:
        if len(baseline) < self.min_baseline:
            return None
        med, scale = robust_baseline(baseline)
        z = (v - med) / scale
        if z < self.z_threshold or v < self.min_abs_s or v < 2.0 * med:
            return None
        last = self._last_emit.get(key)
        if last is not None and now - last < self.cooldown_s:
            return None
        self._last_emit[key] = now
        magnitude = v / med if med > 0 else float(round(z, 1))
        det = {
            "series": name,
            "phase": phase,
            "baseline_s": round(med, 6),
            "observed_s": round(v, 6),
            "magnitude": round(magnitude, 2),
            "z": round(z, 2),
        }
        self.registry.inc(
            "karpenter_anomaly_detected_total",
            {"series": name, "phase": phase},
        )
        self.registry.event("AnomalyDetected", **det)
        return det
