"""Declarative SLOs: latency targets + error budgets over existing signals.

The telemetry layer already collects everything an availability story needs
— latency reservoirs per op and exact counter families per class — but
"what do the numbers *mean*" lived in people's heads. This module makes the
objectives declarative and the judgment mechanical:

- :class:`SLO` — one objective, in one of two shapes:

  * **latency**: "``objective`` of ``op`` calls complete within
    ``threshold_ms``" — evaluated over the pooled retained reservoir
    windows of every live instance (the recent-behavior window, exactly
    what a readiness probe should judge);
  * **error rate**: "at most ``1 - objective`` of ``total`` operations land
    in ``bad`` counters" — evaluated over a sliding wall-clock window of
    counter *deltas* (checkpointed per evaluation), so a burst burns the
    budget and then ages out instead of poisoning the lifetime ratio.

- **burn rate** — the classic error-budget consumption speed:
  ``burn = bad_fraction / (1 - objective)``. 1.0 means the budget is being
  consumed exactly at the sustainable rate; 14.4 is the canonical
  page-immediately threshold (a 30-day budget gone in ~2 days).

- :func:`health_report` / :meth:`SloTracker.health_report` — one snapshot
  (``healthy`` bool + per-SLO compliance/burn/status) suitable for a
  readiness probe; ``to_json()`` is guaranteed serializable at the source.

Nothing here touches a hot path: evaluation reads the registry aggregate on
demand (scrape-rate, not stream-rate).
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.reservoir import nearest_rank
from torchmetrics_tpu_torch._observability.state import OBS
from torchmetrics_tpu_torch._observability.telemetry import REGISTRY, _split_key

__all__ = [
    "SLO",
    "SloStatus",
    "SloTracker",
    "HealthReport",
    "DEFAULT_SLOS",
    "set_slos",
    "health_report",
    "FAST_BURN",
]

# burn rate above which the budget math says "page now, not at review time":
# at 14.4x a 30-day budget is gone in ~2 days (the SRE-workbook constant)
FAST_BURN = 14.4

# Checkpoint-count ceiling per tracker; interior thinning kicks in above it.
_MAX_CHECKPOINTS = 256


@dataclass(frozen=True)
class SLO:
    """One declarative objective over the telemetry the runtime already has.

    Exactly one mode must be configured:

    - latency: set ``op`` + ``threshold_ms`` (reservoir-backed);
    - error rate: set ``bad`` (+ optionally ``total``) counter families.

    ``objective`` is the good fraction (0.99 = "99% of calls good");
    ``window_s`` bounds the error-rate budget window (checkpointed counter
    deltas older than this age out of the burn computation).
    """

    name: str
    objective: float = 0.99
    # latency mode
    op: Optional[str] = None
    threshold_ms: Optional[float] = None
    # error-rate mode: counter FAMILY names (labels are summed away)
    bad: Tuple[str, ...] = ()
    total: Tuple[str, ...] = ("update_calls",)
    window_s: float = 300.0

    def __post_init__(self) -> None:
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"`objective` must be in (0, 1), got {self.objective!r}")
        latency_mode = self.op is not None or self.threshold_ms is not None
        error_mode = bool(self.bad)
        if latency_mode == error_mode:
            raise ValueError(
                f"SLO {self.name!r} must configure exactly one mode: latency"
                " (op + threshold_ms) or error rate (bad counter families)"
            )
        if latency_mode and (self.op is None or self.threshold_ms is None or self.threshold_ms <= 0):
            raise ValueError(f"latency SLO {self.name!r} needs both `op` and a positive `threshold_ms`")
        if self.window_s <= 0:
            raise ValueError(f"`window_s` must be positive, got {self.window_s!r}")

    @property
    def kind(self) -> str:
        return "latency" if self.op is not None else "error_rate"

    @property
    def budget(self) -> float:
        """The error budget: the tolerated bad fraction."""
        return 1.0 - self.objective


@dataclass(frozen=True)
class SloStatus:
    """One SLO's judgment at evaluation time."""

    name: str
    kind: str
    objective: float
    compliance: float  # observed good fraction (NaN-free: 1.0 when no traffic)
    burn_rate: float  # bad_fraction / budget; 0 when no traffic
    status: str  # "ok" | "at_risk" | "violated"
    observed: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "kind": self.kind,
            "objective": self.objective,
            "compliance": self.compliance,
            "burn_rate": self.burn_rate,
            "status": self.status,
            "observed": dict(self.observed),
        }


@dataclass(frozen=True)
class HealthReport:
    """Readiness-probe snapshot: overall verdict + per-SLO detail."""

    healthy: bool
    slos: Tuple[SloStatus, ...]
    generated_at: float
    generated_mono: float
    telemetry_enabled: bool

    def status_of(self, name: str) -> Optional[SloStatus]:
        return next((s for s in self.slos if s.name == name), None)

    def to_json(self) -> Dict[str, Any]:
        payload = {
            "healthy": self.healthy,
            "telemetry_enabled": self.telemetry_enabled,
            "generated_at": self.generated_at,
            "generated_mono": self.generated_mono,
            "slos": [s.to_json() for s in self.slos],
        }
        json.dumps(payload)  # serializability guaranteed at the source
        return payload


def _judge(burn: float) -> str:
    # burn <= 1.0 is exactly compliance >= objective (budget consumed no
    # faster than sustainable); FAST_BURN is the page-now line
    if burn <= 1.0:
        return "ok"
    return "at_risk" if burn <= FAST_BURN else "violated"


class SloTracker:  # concurrency: shared probe threads evaluate while ingestion mutates telemetry
    """Evaluate a set of SLOs against the process-wide telemetry registry.

    Error-rate SLOs need *windows*, not lifetime ratios: every
    :meth:`health_report` call checkpoints the summed counter totals and
    computes deltas against the oldest checkpoint still inside each SLO's
    ``window_s`` — so :meth:`health_report` is the probe entry point; the
    lower-level :meth:`evaluate` judges without advancing the window. The
    first report (no prior checkpoint) judges the lifetime totals —
    conservative, and correct for fresh processes.
    """

    def __init__(self, slos: Optional[List[SLO]] = None, registry: Any = None) -> None:
        self.slos: Tuple[SLO, ...] = tuple(slos if slos is not None else DEFAULT_SLOS)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(n for n in names if names.count(n) > 1)}")
        self._registry = registry if registry is not None else REGISTRY
        self._lock = _san_lock("SloTracker._lock")
        max_window = max((s.window_s for s in self.slos), default=300.0)
        self._max_window = max_window
        # (mono, {family: summed total}) checkpoints, oldest first; bounded
        # by time-based pruning + interior thinning in health_report — a
        # deque maxlen would evict the oldest entry under frequent probes
        # and silently shrink the effective error-budget window
        self._checkpoints: "deque[Tuple[float, Dict[str, float]]]" = deque()

    # ------------------------------------------------------------ counter math
    def _family_totals(self) -> Dict[str, float]:
        """Counter totals summed over classes AND labels, keyed by family."""
        totals: Dict[str, float] = {}
        for key, val in self._registry.counter_totals().items():
            family, _labels = _split_key(key)
            totals[family] = totals.get(family, 0.0) + float(val)
        return totals

    def _window_delta(
        self, slo: SLO, now: float, totals: Dict[str, float]
    ) -> Tuple[float, float, float]:
        """(bad_delta, total_delta, window_span_s) for one error-rate SLO.

        The base is the OLDEST checkpoint still inside ``window_s`` (so the
        budget judges the whole window, not just the last probe interval);
        when every checkpoint has aged past the window, the newest one is
        used instead — "since the previous evaluation" beats falling back to
        the lifetime ratio, which would let ancient good traffic mask a
        current burn.
        """
        base: Optional[Dict[str, float]] = None
        base_t = now
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_checkpoints")
            for t, snap in self._checkpoints:
                if now - t <= slo.window_s:
                    base, base_t = snap, t
                    break
            if base is None and self._checkpoints:
                base_t, base = self._checkpoints[-1]
        bad_now = sum(totals.get(f, 0.0) for f in slo.bad)
        total_now = sum(totals.get(f, 0.0) for f in slo.total)
        if base is None:
            return bad_now, total_now, slo.window_s
        bad_then = sum(base.get(f, 0.0) for f in slo.bad)
        total_then = sum(base.get(f, 0.0) for f in slo.total)
        # counters are monotonic per process; a registry reset mid-window
        # makes deltas negative — clamp rather than report a negative burn
        return max(0.0, bad_now - bad_then), max(0.0, total_now - total_then), max(1e-9, now - base_t)

    def _pooled_latency(self, op: str) -> List[float]:
        values: List[float] = []
        for telem in self._registry.telemetries():
            res = dict(telem.reservoirs).get(op)
            if res is not None:
                values.extend(res.values())
        return values

    # -------------------------------------------------------------- evaluation
    def evaluate(self, slo: SLO, totals: Optional[Dict[str, float]] = None) -> SloStatus:
        """Judge one SLO WITHOUT advancing the error-budget window (only
        :meth:`health_report` checkpoints — wire probes to it, not here).

        ``totals`` lets :meth:`health_report` share ONE registry-aggregate
        walk across every error-rate SLO and the window checkpoint (also
        keeping the judged totals and the checkpointed totals identical — a
        counter advancing mid-report would otherwise be judged in neither
        window or both)."""
        if slo.kind == "latency":
            values = self._pooled_latency(slo.op)
            threshold_s = slo.threshold_ms / 1000.0
            if not values:
                return SloStatus(slo.name, slo.kind, slo.objective, 1.0, 0.0, "ok",
                                 observed={"samples": 0})
            good = sum(1 for v in values if v <= threshold_s)
            compliance = good / len(values)
            burn = (1.0 - compliance) / slo.budget
            svals = sorted(values)
            observed = {
                "samples": len(values),
                "threshold_ms": slo.threshold_ms,
                # nearest_rank is the one quantile formula shared with the
                # Prometheus summary, so probe and scrape agree exactly
                "p50_ms": nearest_rank(svals, 0.50) * 1000.0,
                "p99_ms": nearest_rank(svals, 0.99) * 1000.0,
                "worst_ms": svals[-1] * 1000.0,
            }
            return SloStatus(slo.name, slo.kind, slo.objective, compliance, burn,
                             _judge(burn), observed)
        if totals is None:
            totals = self._family_totals()
        bad, total, span = self._window_delta(slo, time.monotonic(), totals)
        if total <= 0:
            if bad > 0:
                # bad events with zero denominator traffic (e.g. restore
                # fallbacks while ingestion is paused): every observed
                # operation in the window failed — full burn, never "ok"
                burn = 1.0 / slo.budget
                return SloStatus(slo.name, slo.kind, slo.objective, 0.0, burn, _judge(burn),
                                 observed={"bad": bad, "total": 0.0, "window_s": span})
            return SloStatus(slo.name, slo.kind, slo.objective, 1.0, 0.0, "ok",
                             observed={"bad": bad, "total": 0.0, "window_s": span})
        bad_frac = min(1.0, bad / total)
        compliance = 1.0 - bad_frac
        burn = bad_frac / slo.budget
        observed = {"bad": bad, "total": total, "window_s": span,
                    "families": {"bad": list(slo.bad), "total": list(slo.total)}}
        return SloStatus(slo.name, slo.kind, slo.objective, compliance, burn,
                         _judge(burn), observed)

    def health_report(self) -> HealthReport:
        """Evaluate every SLO and checkpoint the counters for the next window."""
        totals = self._family_totals()  # ONE aggregate walk shared by all
        statuses = tuple(self.evaluate(slo, totals) for slo in self.slos)
        now = time.monotonic()
        with self._lock:
            self._checkpoints.append((now, totals))
            # age out checkpoints no SLO's window can reach anymore
            while self._checkpoints and now - self._checkpoints[0][0] > self._max_window * 2:
                self._checkpoints.popleft()
            # memory bound for fast probes: thin every other INTERIOR entry
            # (oldest anchors the window base, newest is the latest delta)
            if len(self._checkpoints) > _MAX_CHECKPOINTS:
                entries = list(self._checkpoints)
                self._checkpoints = deque([entries[0]] + entries[1:-1][::2] + [entries[-1]])
        return HealthReport(
            healthy=all(s.status != "violated" for s in statuses),
            slos=statuses,
            generated_at=time.time(),
            generated_mono=now,
            telemetry_enabled=OBS.enabled,
        )


# Sensible defaults for the serving runtime: ingest latency on the two
# batched hot paths + quarantine/degradation error budgets. Deployments
# replace these with set_slos([...]) sized to their own targets.
DEFAULT_SLOS: List[SLO] = [
    SLO(name="ingest_p99", op="stream_step", threshold_ms=50.0, objective=0.99),
    SLO(name="update_p99", op="update_compiled", threshold_ms=50.0, objective=0.99),
    # the serving runtime's two request-facing ops: enqueue-to-ack for
    # updates, dispatch-to-value for reads (MetricServer observes both)
    SLO(name="serve_ingest_p99", op="ingest", threshold_ms=250.0, objective=0.99),
    SLO(name="serve_compute_p99", op="serve_compute", threshold_ms=250.0, objective=0.99),
    SLO(
        name="quarantine_budget",
        bad=("quarantined_batches",),
        total=("update_calls",),
        objective=0.999,
    ),
    SLO(
        name="degradation_budget",
        bad=("degradations",),
        total=("sync_calls", "update_calls"),
        objective=0.999,
    ),
]


_tracker_lock = _san_lock("slo._tracker_lock")
_tracker: List[SloTracker] = []  # 0 or 1 process-wide tracker (lock-scoped swap)


def set_slos(slos: Optional[List[SLO]] = None) -> SloTracker:
    """Install the process-wide SLO set (None restores the defaults)."""
    tracker = SloTracker(slos)
    with _tracker_lock:
        _tracker[:] = [tracker]
    return tracker


def health_report() -> HealthReport:
    """Readiness snapshot from the process-wide tracker (defaults on first use)."""
    with _tracker_lock:
        tracker = _tracker[0] if _tracker else None
    if tracker is None:
        tracker = set_slos(None)
    return tracker.health_report()
