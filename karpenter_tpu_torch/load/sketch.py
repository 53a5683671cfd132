"""Deterministic streaming percentile sketches for fleet-level reporting.

`Registry._Hist` keeps an exact sample window (1024 samples) and decays
to bucket interpolation past it — fine for operational quantiles, but
the fleet report wants p99/p99.9 over MILLIONS of observations with a
value that is a pure function of the observation multiset (replay must
reproduce it byte-for-byte, merge must be order-free).

`QuantileSketch` buckets positive values by (binary exponent, mantissa
sub-bucket) via `math.frexp` — exact float arithmetic, no logs, no
accumulation-order sensitivity.  With 64 sub-buckets per octave the
relative quantile error is bounded by ~0.8%, memory is O(octaves x 64)
regardless of stream length, and two sketches merge by adding counts.

Zero observations get their own bucket (time-to-schedule is frequently
exactly 0.0 in the sim: a pod nominated the tick it arrives), so p50 of
an idle fleet is exactly 0.0, not a bucket artifact.
"""

from __future__ import annotations

import math
from typing import Dict


class QuantileSketch:
    SUBBUCKETS = 64

    def __init__(self) -> None:
        self.count = 0
        self.vmax = 0.0
        self._zero = 0  # values <= 0.0
        self._counts: Dict[int, int] = {}  # (exponent, sub-bucket) key -> n

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            self._zero += 1
            return
        m, e = math.frexp(v)  # v = m * 2**e, m in [0.5, 1)
        sub = min(int((m - 0.5) * 2 * self.SUBBUCKETS), self.SUBBUCKETS - 1)
        key = e * self.SUBBUCKETS + sub
        self._counts[key] = self._counts.get(key, 0) + 1

    def merge(self, other: "QuantileSketch") -> None:
        self.count += other.count
        self._zero += other._zero
        if other.vmax > self.vmax:
            self.vmax = other.vmax
        for key, n in other._counts.items():
            self._counts[key] = self._counts.get(key, 0) + n

    @staticmethod
    def _bucket_value(key: int) -> float:
        e, sub = divmod(key, QuantileSketch.SUBBUCKETS)
        # bucket midpoint: exact float arithmetic (ldexp, no log/exp)
        return math.ldexp(0.5 + (sub + 0.5) / (2 * QuantileSketch.SUBBUCKETS), e)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile (same rank rule as sim/report.py's
        `percentile`), resolved to the bucket midpoint."""
        if self.count == 0:
            return 0.0
        rank = max(0, min(self.count - 1, int(round(q * (self.count - 1)))))
        if rank < self._zero:
            return 0.0
        seen = self._zero
        for key in sorted(self._counts):
            seen += self._counts[key]
            if rank < seen:
                return min(self._bucket_value(key), self.vmax)
        return self.vmax

    def section(self) -> dict:
        """The report-facing summary: deterministic, byte-comparable."""
        return {
            "count": self.count,
            "p50": round(self.quantile(0.50), 6),
            "p99": round(self.quantile(0.99), 6),
            "p999": round(self.quantile(0.999), 6),
            "max": round(self.vmax, 6),
        }
