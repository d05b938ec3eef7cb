"""Flight recorder: automatic post-mortem artifacts for runtime faults.

When a production fault fires today, the artifacts are a one-line event and
some counters — the context (*what led up to it, on which request*) is gone
by the time anyone looks. The flight recorder fixes that: it rides the two
bounded rings the runtime already keeps — the span ring (:data:`tracing.TRACER`)
and the event bus window (:data:`events.BUS`) — and on every *trigger* event
it freezes a self-contained post-mortem JSON dump:

- the **trigger** (kind, source, detail, data, wall + monotonic timestamps);
- the **failing seam** (``guard.sync``, ``metric.update``, ``spmd.step``,
  ``snapshot.restore``, ...) — from the event's ``data["seam"]`` when the
  publisher names it, else from the kind → seam table below;
- the **trace id of the failing request** — the span ambient on the
  publishing thread (bus subscribers run inline, so the degradation's own
  request context is still live), else the most recent completed span's;
- the last N completed **spans** and last M bus **events**, merged and
  ordered on the shared monotonic clock (the reason ``TelemetryEvent.mono``
  exists) so cross-component causality reads top-to-bottom.

Triggers: ``degradation`` events (covers quarantined batches, degraded
syncs/handshakes, SPMD fallbacks, restore fallbacks — every
``DegradationEvent`` is bus-published), ``recompile_churn``, failed
``snapshot_restore``, ``chaos_fault`` (the chaos harness names each
injected fault), and ``perf_regression`` (the cost ledger's sustained
latency-baseline breach — see ``profiling.py``). Each trigger produces
exactly ONE dump (deduped on the bus seq); dumps are retained in memory
(last ``keep``) and, with a directory armed, written as
``flight_<seq>_<kind>.json`` files. On-disk retention is bounded: at most
``max_files`` dumps (env ``TM_TPU_FLIGHT_MAX_FILES``, default 64) are kept,
oldest-first eviction by bus seq — a trigger flood cannot fill the disk.

``perf_regression`` dumps additionally carry a ``profiling`` section: the
cost ledger snapshot (per-seam buckets, MFU, baselines, regressions) and
the per-tenant ``pool_cost_*`` counter slice at dump time, so the
post-mortem shows WHERE the device time was going when the seam slowed.

Hot-path cost: zero — the recorder is a bus subscriber, so nothing runs
until an (already rare, already telemetry-gated) trigger event publishes.
Arm with :func:`arm_flight_recorder` (or env ``TM_TPU_FLIGHT_DIR``), disarm
with :func:`disarm_flight_recorder`.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch._observability.events import BUS, TelemetryEvent
from torchmetrics_tpu_torch._observability.tracing import TRACER, current_span

__all__ = [
    "FlightRecorder",
    "arm_flight_recorder",
    "disarm_flight_recorder",
    "get_flight_recorder",
    "FLIGHT_DUMP_VERSION",
]

FLIGHT_DUMP_VERSION = 1

DEFAULT_KEEP = 32  # dumps retained in memory
DEFAULT_SPAN_WINDOW = 32  # spans per dump
DEFAULT_EVENT_WINDOW = 64  # bus events per dump
DEFAULT_MAX_FILES = 64  # dumps retained on disk (oldest evicted first)

# event kinds that freeze a dump. `snapshot_restore` is conditional: only
# failed outcomes are faults (`fallback` restores additionally publish a
# degradation event, which IS a trigger — one dump, not two). `load_shed`
# fires on shed-episode TRANSITIONS only (the ingress queue rate-limits the
# publishes), so a shedding server freezes one dump per episode with the
# controller's recent decisions in the event window, not one per rejection.
_TRIGGER_KINDS = frozenset(
    {
        "degradation",
        "recompile_churn",
        "chaos_fault",
        "snapshot_restore",
        "perf_regression",
        "load_shed",
    }
)

# kind (and, for degradations, DegradationEvent kind) -> failing seam.
# A publisher that knows better ships `data["seam"]`, which always wins.
_SEAM_FOR_KIND = {
    "recompile_churn": "compile",
    "snapshot_restore": "snapshot.restore",
    "perf_regression": "metric.update",
    "load_shed": "serving.ingress",
}
_SEAM_FOR_DEGRADATION = {
    "nan_quarantine": "metric.update",
    "sync_degraded": "guard.sync",
    "handshake_degraded": "guard.sync",
    "spmd_degraded": "spmd.step",
    "snapshot_restore": "snapshot.restore",
    "snapshot_degraded": "snapshot.write",
    "fleet_partial": "fleet.rollup",
    "fleet_corrupt": "fleet.fold",
    "fleet_publish_degraded": "fleet.publish",
}


def _seam_of(event: TelemetryEvent) -> str:
    seam = event.data.get("seam")
    if seam:
        return str(seam)
    if event.kind == "degradation":
        return _SEAM_FOR_DEGRADATION.get(str(event.data.get("kind")), "metric")
    return _SEAM_FOR_KIND.get(event.kind, event.kind)


class FlightRecorder:  # concurrency: shared bus publisher threads dump while tests/scrapes read
    """Bounded ring of post-mortem dumps, fed inline by the event bus."""

    def __init__(
        self,
        directory: Optional[str] = None,
        keep: int = DEFAULT_KEEP,
        span_window: int = DEFAULT_SPAN_WINDOW,
        event_window: int = DEFAULT_EVENT_WINDOW,
        max_files: Optional[int] = None,
    ) -> None:
        self.directory = str(directory) if directory is not None else None
        self.span_window = int(span_window)
        self.event_window = int(event_window)
        if max_files is None:
            try:
                max_files = int(os.environ.get("TM_TPU_FLIGHT_MAX_FILES", DEFAULT_MAX_FILES))
            except ValueError:
                max_files = DEFAULT_MAX_FILES
        self.max_files = max(1, int(max_files))
        self._lock = _san_lock("FlightRecorder._lock")
        self._dumps: "deque[Dict[str, Any]]" = deque(maxlen=max(1, int(keep)))
        self._seen: "deque[int]" = deque(maxlen=512)  # trigger seqs already dumped
        self._unsubscribe: Optional[Callable[[], None]] = None
        self.dump_count = 0
        self.write_errors = 0

    # --------------------------------------------------------------- lifecycle
    def arm(self) -> "FlightRecorder":
        """Subscribe to the bus; idempotent."""
        with self._lock:
            if self._unsubscribe is None:
                self._unsubscribe = BUS.subscribe(self._on_event)
        return self

    def disarm(self) -> None:
        with self._lock:
            unsub, self._unsubscribe = self._unsubscribe, None
        if unsub is not None:
            unsub()

    @property
    def armed(self) -> bool:
        return self._unsubscribe is not None

    # ----------------------------------------------------------------- dumping
    def _on_event(self, event: TelemetryEvent) -> None:
        if event.kind not in _TRIGGER_KINDS:
            return
        if event.kind == "snapshot_restore" and event.data.get("outcome") != "failed":
            return
        self.dump(event)

    def dump(self, trigger: TelemetryEvent) -> Optional[Dict[str, Any]]:
        """Freeze one post-mortem for ``trigger``; dedup on its bus seq."""
        with self._lock:
            if _SAN.enabled:
                _san_check(self, "_dumps,_seen")
            if trigger.seq in self._seen:
                return None
            self._seen.append(trigger.seq)
        # the dump is assembled OUTSIDE the lock: span/event reads take their
        # own ring locks, and a slow disk write must not block a concurrent
        # trigger on another thread from recording its seq
        dump, text = self._build(trigger)
        with self._lock:
            self._dumps.append(dump)
            self.dump_count += 1
        if self.directory is not None:
            self._write(dump, text)
        return dump

    def _build(self, trigger: TelemetryEvent) -> "Tuple[Dict[str, Any], str]":
        span = current_span()
        spans = TRACER.recent(self.span_window)
        if span is None:
            # no ambient request context on the publishing thread: attribute
            # to the most recently completed span (best-effort, flagged)
            trace_id = spans[-1].trace_id if spans else None
            trace_attribution = "last_completed" if spans else "none"
        else:
            trace_id = span.trace_id
            trace_attribution = "ambient"
        events = BUS.events()[-self.event_window :]
        timeline: List[Dict[str, Any]] = [
            {"type": "span", "mono": s.t0_mono, **s.to_json()} for s in spans
        ] + [
            {
                "type": "event",
                "mono": e.mono,
                "seq": e.seq,
                "ts": e.ts,
                "kind": e.kind,
                "source": e.source,
                "detail": e.detail,
                "data": e.data,
            }
            for e in events
            if e.seq != trigger.seq
        ]
        # the shared monotonic clock is what makes this ordering meaningful
        # across components (spans from one seam, events from another)
        timeline.sort(key=lambda r: r["mono"])
        dump = {
            "version": FLIGHT_DUMP_VERSION,
            "dumped_at": time.time(),
            "dumped_mono": time.monotonic(),
            "seam": _seam_of(trigger),
            "trace_id": trace_id,
            "trace_attribution": trace_attribution,
            "trigger": {
                "seq": trigger.seq,
                "ts": trigger.ts,
                "mono": trigger.mono,
                "kind": trigger.kind,
                "source": trigger.source,
                "detail": trigger.detail,
                "data": trigger.data,
            },
            "timeline": timeline,
            "spans_dropped": TRACER.dropped,
            "events_dropped": BUS.dropped,
        }
        if trigger.kind == "perf_regression":
            dump["profiling"] = self._profiling_section()
        # self-contained = serializable, guaranteed at the source. The
        # recorder runs inside a bus subscriber: an exception here would get
        # the subscriber silently dropped (one warning, then no post-mortems
        # ever again while `armed` still reads True), so a user span attr or
        # event payload that json can't represent is coerced via repr()
        # rather than allowed to escape — and anything beyond that (circular
        # refs) degrades to a trigger-only dump instead of raising. The
        # serialized text travels with the dict so the disk write pays no
        # second encode of the full timeline.
        try:
            text = json.dumps(dump, default=repr)
        except (TypeError, ValueError):
            text = json.dumps(
                {
                    **{k: dump[k] for k in ("version", "dumped_at", "dumped_mono",
                                            "seam", "trace_id", "trace_attribution")},
                    "trigger": {**dump["trigger"], "data": repr(trigger.data)},
                    "timeline": [],
                    "degraded": "timeline not serializable",
                }
            )
        return json.loads(text), text

    def _profiling_section(self) -> Dict[str, Any]:
        """Cost-ledger snapshot + per-tenant cost counters for perf dumps."""
        from torchmetrics_tpu_torch._observability.profiling import LEDGER
        from torchmetrics_tpu_torch._observability.telemetry import REGISTRY

        tenants = {
            key: val
            for key, val in REGISTRY.counter_totals().items()
            if key.startswith("pool_cost_")
        }
        return {"ledger": LEDGER.snapshot(), "tenant_costs": tenants}

    def _write(self, dump: Dict[str, Any], text: str) -> None:
        try:
            os.makedirs(self.directory, exist_ok=True)
            name = f"flight_{dump['trigger']['seq']:06d}_{dump['trigger']['kind']}.json"
            tmp = os.path.join(self.directory, name + ".tmp")
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(text)
            os.replace(tmp, os.path.join(self.directory, name))
            self._evict()
        except OSError:
            # a post-mortem writer must never break the runtime path that
            # published the trigger; the in-memory dump ring still has it
            with self._lock:
                self.write_errors += 1

    def _evict(self) -> None:
        """Drop oldest on-disk dumps beyond ``max_files`` (by bus seq).

        Disk retention is a cap, not an archive: a trigger flood (churn
        storm, chaos soak) must converge to bounded disk, with the newest
        post-mortems — the ones an on-call will actually open — surviving.
        """
        names = []
        for fname in os.listdir(self.directory):
            if not (fname.startswith("flight_") and fname.endswith(".json")):
                continue
            parts = fname[len("flight_") :].split("_", 1)
            try:
                names.append((int(parts[0]), fname))
            except (ValueError, IndexError):
                continue  # foreign file in the dump dir: never delete it
        if len(names) <= self.max_files:
            return
        names.sort()
        for _, fname in names[: len(names) - self.max_files]:
            try:
                os.remove(os.path.join(self.directory, fname))
            except OSError:
                pass  # already gone (concurrent eviction) — the cap still holds

    # ----------------------------------------------------------------- reading
    def dumps(self) -> List[Dict[str, Any]]:
        """Retained dumps, oldest first."""
        with self._lock:
            return list(self._dumps)

    def clear(self) -> None:
        with self._lock:
            self._dumps.clear()
            self._seen.clear()
            self.dump_count = 0


_active_lock = _san_lock("flight._active_lock")
_active: List[FlightRecorder] = []  # 0 or 1 armed recorder (list for lock-scoped swap)


def arm_flight_recorder(
    directory: Optional[str] = None, **kwargs: Any
) -> FlightRecorder:
    """Arm the process-wide flight recorder (replacing any armed one).

    ``directory`` defaults to env ``TM_TPU_FLIGHT_DIR`` (in-memory only when
    neither is set). Returns the armed recorder.
    """
    if directory is None:
        directory = os.environ.get("TM_TPU_FLIGHT_DIR") or None
    from torchmetrics_tpu_torch._observability.state import OBS

    if not OBS.enabled:
        # every trigger kind reaches the recorder through BUS.publish, which
        # no-ops while the telemetry switch is off — an armed-but-silent
        # recorder discovered after the incident is the worst failure mode
        from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

        rank_zero_warn(
            "arm_flight_recorder() called with telemetry disabled: trigger events"
            " (degradations, recompile churn, chaos faults) are only published while"
            " the telemetry switch is on, so no post-mortem dumps will be produced."
            " Enable with TM_TPU_TELEMETRY=1 or set_telemetry_enabled(True).",
            UserWarning,
        )
    recorder = FlightRecorder(directory=directory, **kwargs)
    with _active_lock:
        old = _active[:]
        _active[:] = [recorder]
    for r in old:
        r.disarm()
    recorder.arm()
    return recorder


def disarm_flight_recorder() -> None:
    with _active_lock:
        old = _active[:]
        _active[:] = []
    for r in old:
        r.disarm()


def get_flight_recorder() -> Optional[FlightRecorder]:
    with _active_lock:
        return _active[0] if _active else None
