"""Runtime telemetry & trace attribution for the port.

Port of ``torchmetrics_tpu/_observability/`` (same module names, same
public surface, same switches). The runtime's execution regimes, the eager
update, the compiled update and forward on CUDA graphs (``_compile.py``),
``jit_update``/``scan_update`` and the captured trunks, record here:

- **Per-metric counters + latency reservoirs** (:class:`MetricTelemetry`),
  recorded at the runtime's seams: which path every update took (eager /
  auto-compiled / ``jit_update`` / ``scan_update``), fingerprint guard
  outcomes, deferred violations, compute cache hits, sync calls.
- **Recompile-churn detection**: every compiled-path cache key (an argument
  signature of a CUDA graph) is tracked; churn raises a rate-limited
  :class:`RecompileChurnWarning` naming the differing component(s).
- **A unified event bus** (:data:`BUS`) carrying path disablements, churn
  and latency regressions as one ordered stream.
- **Profiler scopes**: ``torch.profiler.record_function`` (and NVTX on the
  card) around eager and compiled work, so host and Nsight profiles
  attribute time to ``ClassName.method``.
- **Export surfaces**: ``Metric.telemetry_report()``,
  ``MetricCollection.telemetry_report()``, and process-wide
  :meth:`TelemetryRegistry.render_prometheus` /
  :meth:`TelemetryRegistry.render_openmetrics` /
  :meth:`TelemetryRegistry.to_json`, with the JAX package's families
  (``export.EXPORT_SCHEMA``, frozen in ``perf_manifest.json``).
- **Request tracing** (``tracing.py``): context-var-propagated correlation
  ids with spans at every seam, exportable as Chrome trace-event JSON
  (:func:`trace_context`, :func:`export_chrome_trace`; ``TM_TPU_TRACING=1``).
- **Flight recorder** (``flight.py``): path disablements, degradations,
  recompile churn and latency regressions freeze a post-mortem JSON dump
  naming the failing seam, trace id, and the last N spans/events
  (:func:`arm_flight_recorder`; ``TM_TPU_FLIGHT_DIR``).
- **SLOs** (``slo.py``): declarative latency/error-budget objectives with
  burn-rate evaluation and a readiness-probe :func:`health_report`.
- **Continuous profiling & cost attribution** (``profiling.py``,
  ``costs.py``): each compiled step's flops and bytes, counted once before
  its capture, with its replays timed by CUDA event pairs, in a device-time
  ledger (:data:`LEDGER`): per-seam/per-class buckets, live MFU and
  roofline gauges against the H100's ceilings, and a rolling EWMA+MAD
  latency baseline whose sustained regressions trigger ``perf_regression``
  dumps (``TM_TPU_PROFILING=1`` / :func:`set_profiling_enabled`).

Everything is **off by default**: the disabled hot path is one slot load
and one branch on ``state.OBS`` per seam, with no dict lookup and no
allocation. Enable with ``TM_TPU_TELEMETRY=1`` or
:func:`set_telemetry_enabled`; all recording mutates host state at eager
boundaries, never inside a captured graph (a replay runs no Python, so its
counts are kept on the host side of the replay).
"""

from torchmetrics_tpu_torch._observability.costs import (
    Ceilings,
    ExecutableCost,
    extract_cost,
    get_ceilings,
    set_ceilings,
)
from torchmetrics_tpu_torch._observability.events import BUS, EventBus, TelemetryEvent
from torchmetrics_tpu_torch._observability.flight import (
    FlightRecorder,
    arm_flight_recorder,
    disarm_flight_recorder,
    get_flight_recorder,
)
from torchmetrics_tpu_torch._observability.profiling import (
    LEDGER,
    CostLedger,
    get_ledger,
    profiling_enabled,
    reset_ledger,
    set_profiling_enabled,
)
from torchmetrics_tpu_torch._observability.reservoir import LatencyReservoir
from torchmetrics_tpu_torch._observability.slo import (
    SLO,
    HealthReport,
    SloStatus,
    SloTracker,
    health_report,
    set_slos,
)
from torchmetrics_tpu_torch._observability.scopes import (
    annotation,
    named_scope,
    profiling_scopes_active,
    set_profile_scopes,
)
from torchmetrics_tpu_torch._observability.state import (
    OBS,
    set_telemetry_enabled,
    set_telemetry_sampling,
    telemetry_enabled,
)
from torchmetrics_tpu_torch._observability.telemetry import (
    REGISTRY,
    MetricTelemetry,
    RecompileChurnWarning,
    TelemetryRegistry,
    TelemetryReport,
    get_registry,
    report_for,
    telemetry_for,
)
from torchmetrics_tpu_torch._observability.tracing import (
    TRACER,
    Span,
    SpanRecorder,
    current_span,
    current_trace_id,
    export_chrome_trace,
    set_tracing_enabled,
    span_tree,
    trace_context,
    tracing_enabled,
)

__all__ = [
    "BUS",
    "Ceilings",
    "CostLedger",
    "EventBus",
    "ExecutableCost",
    "FlightRecorder",
    "HealthReport",
    "LEDGER",
    "LatencyReservoir",
    "MetricTelemetry",
    "OBS",
    "REGISTRY",
    "RecompileChurnWarning",
    "SLO",
    "SloStatus",
    "SloTracker",
    "Span",
    "SpanRecorder",
    "TRACER",
    "TelemetryEvent",
    "TelemetryRegistry",
    "TelemetryReport",
    "annotation",
    "arm_flight_recorder",
    "current_span",
    "current_trace_id",
    "disarm_flight_recorder",
    "export_chrome_trace",
    "extract_cost",
    "get_ceilings",
    "get_flight_recorder",
    "get_ledger",
    "get_registry",
    "health_report",
    "named_scope",
    "profiling_enabled",
    "profiling_scopes_active",
    "report_for",
    "reset_ledger",
    "set_ceilings",
    "set_profile_scopes",
    "set_profiling_enabled",
    "set_slos",
    "set_telemetry_enabled",
    "set_telemetry_sampling",
    "set_tracing_enabled",
    "span_tree",
    "telemetry_enabled",
    "telemetry_for",
    "trace_context",
    "tracing_enabled",
]
