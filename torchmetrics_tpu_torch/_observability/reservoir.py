"""Bounded host-side latency reservoirs.

A :class:`LatencyReservoir` keeps the most recent ``capacity`` samples in a
preallocated ring — O(1) push, fixed memory, no device interaction — plus
exact running totals (count / sum / min / max) over the reservoir's whole
life. Quantiles are computed over the retained window on demand (reads are
rare: reports and exports), so the hot path never sorts.
"""

from __future__ import annotations

import math
from typing import Dict, List

__all__ = ["LatencyReservoir", "nearest_rank"]


def nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile over pre-sorted samples (NaN when empty).

    The ONE quantile formula for the whole observability layer: reservoir
    stats, the Prometheus summary, and SLO probe numbers all call this, so
    they agree exactly on identical samples.
    """
    if not sorted_vals:
        return math.nan
    rank = min(len(sorted_vals) - 1, max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[rank]


class LatencyReservoir:
    """Fixed-capacity ring of float samples with lifetime totals."""

    __slots__ = ("capacity", "_ring", "_idx", "count", "total", "min", "max")

    def __init__(self, capacity: int = 128) -> None:
        if not (isinstance(capacity, int) and capacity >= 1):
            raise ValueError(f"`capacity` must be a positive integer, got {capacity!r}")
        self.capacity = capacity
        self._ring: List[float] = [0.0] * capacity
        self._idx = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def push(self, value: float) -> None:
        value = float(value)
        self._ring[self._idx] = value
        self._idx = (self._idx + 1) % self.capacity
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def __len__(self) -> int:
        return min(self.count, self.capacity)

    def values(self) -> List[float]:
        """Retained samples, oldest first."""
        n = len(self)
        if n < self.capacity:
            return self._ring[:n]
        return self._ring[self._idx :] + self._ring[: self._idx]

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the retained window (NaN when empty)."""
        return nearest_rank(sorted(self.values()), q)

    def stats(self) -> Dict[str, float]:
        """Summary for reports/exports.

        ``count``/``sum``/``min``/``max``/``mean`` are lifetime-exact;
        ``p50``/``p90``/``p99`` are over the retained window.
        """
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }
