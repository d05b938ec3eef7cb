"""Unified runtime event bus.

One process-wide, bounded, thread-safe stream for every *discrete* runtime
occurrence the telemetry layer observes: resilience degradations (previously
siloed in ``Metric.resilience_report()``), snapshot writes/restores,
auto-compile path disablement, recompile churn, sustained latency
regressions, and harness progress heartbeats. Counters answer "how many"; the bus
answers "what happened, in what order".

Publishing honors the global telemetry switch (``state.OBS.enabled``) so the
kill switch silences the whole layer at once; subscribers are invoked inline
on the publishing thread (keep them cheap — a failing subscriber is dropped
after warning once rather than breaking the runtime path that published).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.state import OBS

__all__ = ["TelemetryEvent", "EventBus", "BUS"]

DEFAULT_BUS_CAPACITY = 256


@dataclass(frozen=True)
class TelemetryEvent:
    """One runtime occurrence on the bus.

    ``seq`` is a process-wide monotonically increasing ordinal (gaps mean
    eviction happened between reads); ``ts`` is ``time.time()`` at publish
    (wall clock — human-readable, but steppable by NTP) and ``mono`` is
    ``time.monotonic()`` at publish — the same clock spans are stamped with
    (``tracing.Span.t0_mono``), so flight-recorder dumps interleave events
    and spans from different components on ONE un-steppable axis;
    ``source`` names the emitting object (usually a metric class name);
    ``data`` carries small host-side payload values (must stay
    JSON-serializable — exports embed it verbatim).
    """

    seq: int
    ts: float
    kind: str
    source: str
    detail: str
    data: Dict[str, Any] = field(default_factory=dict)
    mono: float = 0.0


class EventBus:
    """Bounded multi-reader event stream with inline subscribers."""

    def __init__(self, capacity: int = DEFAULT_BUS_CAPACITY) -> None:
        self._lock = _san_lock("EventBus._lock")
        self._events: "deque[TelemetryEvent]" = deque(maxlen=capacity)
        self._seq = 0
        self.dropped = 0
        # lifetime per-kind publish counts: the monotonic series exports
        # need (window counts would DECREASE as events evict, which a
        # Prometheus counter consumer reads as a reset)
        self._kind_totals: Dict[str, int] = {}
        self._subscribers: List[Callable[[TelemetryEvent], None]] = []
        self._warned_subscribers = False

    def publish(
        self,
        kind: str,
        source: str,
        detail: str = "",
        *,
        data: Optional[Dict[str, Any]] = None,
        force: bool = False,
    ) -> Optional[TelemetryEvent]:
        """Append one event; no-op (returns None) while telemetry is disabled.

        ``force=True`` bypasses the switch — reserved for harness heartbeats
        (multi-card progress) whose whole purpose is post-mortem diagnosis.
        """
        if not (OBS.enabled or force):
            return None
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_events,_kind_totals,_subscribers")
            self._seq += 1
            event = TelemetryEvent(
                seq=self._seq, ts=time.time(), mono=time.monotonic(),
                kind=kind, source=source, detail=detail, data=dict(data or {}),
            )
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)
            self._kind_totals[kind] = self._kind_totals.get(kind, 0) + 1
            subscribers = list(self._subscribers)
        dead = []
        for fn in subscribers:
            try:
                fn(event)
            except Exception:  # noqa: BLE001 - a bad subscriber must not break the runtime
                dead.append(fn)
        if dead:
            with self._lock:
                for fn in dead:
                    if fn in self._subscribers:
                        self._subscribers.remove(fn)
            if not self._warned_subscribers:
                self._warned_subscribers = True
                from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

                rank_zero_warn(
                    f"{len(dead)} telemetry event-bus subscriber(s) raised and were dropped"
                    " (subscribers run inline on the publishing thread and must not fail).",
                    UserWarning,
                )
        return event

    def subscribe(self, fn: Callable[[TelemetryEvent], None]) -> Callable[[], None]:
        """Register an inline subscriber; returns an unsubscribe callable."""
        with self._lock:
            self._subscribers.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)

        return unsubscribe

    def events(self, kind: Optional[str] = None, source: Optional[str] = None) -> Tuple[TelemetryEvent, ...]:
        with self._lock:
            evs = tuple(self._events)
        if kind is not None:
            evs = tuple(e for e in evs if e.kind == kind)
        if source is not None:
            evs = tuple(e for e in evs if e.source == source)
        return evs

    def kind_counts(self) -> Dict[str, int]:
        """Event count per kind over the retained window (diagnostics)."""
        counts: Dict[str, int] = {}
        for e in self.events():
            counts[e.kind] = counts.get(e.kind, 0) + 1
        return counts

    def kind_totals(self) -> Dict[str, int]:
        """Lifetime publish count per kind — monotonic, safe to export as a
        Prometheus counter (unlike the bounded retained window)."""
        with self._lock:
            return dict(self._kind_totals)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._kind_totals.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# the process-wide bus every runtime seam publishes to
BUS = EventBus()
