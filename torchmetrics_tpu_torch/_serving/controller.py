"""SLO-closed-loop micro-batch sizing: burn-rate in, batch target out.

Port of ``torchmetrics_tpu/_serving/controller.py`` (its lock is a plain
``threading.Lock``). The control loop, in its simplest correct shape —
AIMD (additive increase, multiplicative decrease) keyed off the declarative
SLO machinery instead of ad-hoc latency thresholds:

- **Signal.** A private :class:`~torchmetrics_tpu_torch._observability.slo.
  SloTracker` judges one latency SLO over the ``ingest`` op (enqueue-to-ack
  seconds, observed by the server on every acknowledgement). The reservoir
  behind it retains the most recent ~128 samples, so the burn rate *is* the
  recent-window signal a control loop needs — no separate estimator.
- **Law.** ``burn <= OK_BURN`` (headroom) and a standing backlog → grow the
  micro-batch target additively (amortize per-dispatch overhead over more
  rows). ``burn > 1.0`` (budget burning) → shrink multiplicatively (smaller
  batches finish sooner; queue latency falls). ``burn > FAST_BURN``
  (page-now) → also shed load at the ingress edge until the burn recovers.
  Growth is capped by the bucket ladder's top rung so sizing never forces a
  novel executable shape.
- **Journal.** Every decision that changes state publishes one
  ``controller_decision`` bus event (burn, old → new target, queue depth)
  — the flight recorder's event window then shows the loop's recent
  history in any dump — and updates the ``serving_batch_target`` /
  ``serving_ingest_burn`` gauges for scrapes. ``hold`` decisions are
  counted but not published (a quiet loop must not flood the bus).

The controller never touches the pool or the queue: it returns a
:class:`Decision` and the server applies it (batch target at drain time,
shedding via ``IngressQueue.set_shedding``). That keeps the lock graph
acyclic by construction — controller lock, queue lock, and pool lock are
never held together.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._observability.slo import FAST_BURN, SLO, SloTracker
from torchmetrics_tpu_torch._observability.state import OBS as _OBS
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as _telemetry_for

__all__ = ["BatchController", "ControllerConfig", "Decision", "OK_BURN"]

# burn below which the budget has real headroom and growth is safe; between
# OK_BURN and 1.0 the loop holds (hysteresis band — prevents grow/shrink
# oscillation around the objective)
OK_BURN = 0.5

_DECISION_WINDOW = 256  # recent decisions retained for reports/tests


@dataclass(frozen=True)
class ControllerConfig:
    """Loop constants (the defaults suit the CPU test container)."""

    min_batch: int = 1
    max_batch: int = 64
    grow_step: int = 4  # additive increase per decision
    shrink_factor: float = 0.5  # multiplicative decrease per decision
    interval_s: float = 0.05  # min seconds between evaluations
    target_ms: float = 50.0  # the ingest latency objective the loop defends
    objective: float = 0.9  # good fraction within target_ms

    def __post_init__(self) -> None:
        if not (1 <= self.min_batch <= self.max_batch):
            raise ValueError(
                f"need 1 <= min_batch <= max_batch, got {self.min_batch}/{self.max_batch}"
            )
        if not (0.0 < self.shrink_factor < 1.0):
            raise ValueError(f"`shrink_factor` must be in (0, 1), got {self.shrink_factor!r}")
        if self.grow_step < 1:
            raise ValueError(f"`grow_step` must be >= 1, got {self.grow_step!r}")


@dataclass(frozen=True)
class Decision:
    """One evaluation's outcome (``action`` in grow|shrink|shed|hold)."""

    action: str
    burn: float
    target: int  # batch target AFTER this decision
    previous: int
    shed: bool
    queue_depth: int
    mono: float

    def to_json(self) -> Dict[str, Any]:
        return {
            "action": self.action,
            "burn": self.burn,
            "target": self.target,
            "previous": self.previous,
            "shed": self.shed,
            "queue_depth": self.queue_depth,
        }


class BatchController:  # concurrency: shared probe/test threads read while the ingest worker decides
    """AIMD batch-target governor driven by SLO burn rates."""

    def __init__(self, config: Optional[ControllerConfig] = None, registry: Any = None) -> None:
        self.config = config or ControllerConfig()
        self._lock = _san_lock("BatchController._lock")
        self._target = self.config.min_batch
        self._shed = False
        self._last_eval = 0.0
        self._decisions: Deque[Decision] = deque(maxlen=_DECISION_WINDOW)
        self.evaluations = 0
        self._tracker = SloTracker(
            [
                SLO(
                    name="serving_ingest",
                    op="ingest",
                    threshold_ms=self.config.target_ms,
                    objective=self.config.objective,
                )
            ],
            registry=registry,
        )

    # --------------------------------------------------------------- the loop
    def maybe_decide(self, queue_depth: int, source: str = "BatchController") -> Optional[Decision]:
        """Evaluate at most once per ``interval_s``; None between intervals.

        Called by the ingest worker after every drained micro-batch — the
        interval gate keeps SLO evaluation at probe rate, not batch rate.
        """
        now = time.monotonic()
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_target,_shed")
            if now - self._last_eval < self.config.interval_s:
                return None
            self._last_eval = now
        # the tracker takes its own lock — evaluate OUTSIDE ours (acyclic)
        status = self._tracker.health_report().status_of("serving_ingest")
        burn = float(status.burn_rate) if status is not None else 0.0
        cfg = self.config
        with self._lock:
            previous = self._target
            if burn > FAST_BURN:
                action, shed = "shed", True
                self._target = max(cfg.min_batch, int(previous * cfg.shrink_factor))
            elif burn > 1.0:
                # once shedding, stay shedding until the burn is back under
                # 1.0 (exit hysteresis: re-admitting at page-now-adjacent
                # burn would flap the ingress edge)
                action, shed = "shrink", self._shed
                self._target = max(cfg.min_batch, int(previous * cfg.shrink_factor))
            elif burn <= OK_BURN and queue_depth > previous and previous < cfg.max_batch:
                action, shed = "grow", False
                self._target = min(cfg.max_batch, previous + cfg.grow_step)
            else:
                action, shed = "hold", False
            self._shed = shed
            self.evaluations += 1
            decision = Decision(
                action=action, burn=burn, target=self._target, previous=previous,
                shed=shed, queue_depth=int(queue_depth), mono=now,
            )
            self._decisions.append(decision)
        if _OBS.enabled:
            telem = _telemetry_for(self)
            telem.set_gauge("serving_batch_target", decision.target)
            telem.set_gauge("serving_ingest_burn", burn)
            telem.inc(f"serving_controller_decisions|action={action}")
            if action != "hold":
                _BUS.publish(
                    "controller_decision",
                    source,
                    f"{action}: burn={burn:.2f} target {previous} -> {decision.target}"
                    f" (queue depth {queue_depth})",
                    data={
                        "seam": "serving.controller",
                        "action": action,
                        "burn": burn,
                        "target": decision.target,
                        "previous": previous,
                        "shed": shed,
                        "queue_depth": int(queue_depth),
                    },
                )
        return decision

    # --------------------------------------------------------------- queries
    @property
    def target(self) -> int:
        return self._target

    @property
    def shedding(self) -> bool:
        return self._shed

    def decisions(self) -> List[Decision]:
        """Recent decisions, oldest first (bounded window)."""
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_decisions")
            return list(self._decisions)

    def burn_rate(self) -> float:
        """The loop's current signal (for probes/tests; takes no decision)."""
        status = self._tracker.health_report().status_of("serving_ingest")
        return float(status.burn_rate) if status is not None else 0.0
