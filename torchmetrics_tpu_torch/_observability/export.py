"""Export surfaces: Prometheus text exposition, OpenMetrics + JSON.

:func:`render_prometheus` emits the classic text exposition format
(``text/plain; version=0.0.4``): one ``# HELP``/``# TYPE`` header per metric
family, all samples of a family contiguous, label values escaped per the
spec (backslash, double-quote, newline). The output is validated against
``prometheus_client.parser`` in the test suite.

:func:`render_openmetrics` emits the same families in OpenMetrics syntax
(``application/openmetrics-text``): counter families are declared WITHOUT
the ``_total`` suffix (samples keep it), latency histogram buckets carry
trace-id **exemplars** (``# {trace_id="..."} value ts``) when tracing was
active at observation time, and the exposition terminates with ``# EOF``.
Classic Prometheus text format has no exemplar syntax — that is the whole
reason this second renderer exists.

Counter keys arrive in the registry's flat ``"family|label=value"``
convention and are re-expanded into label sets here; every sample
additionally carries a ``metric="<ClassName>"`` label identifying the
aggregated metric class.

:data:`EXPORT_SCHEMA` declares every family this module may emit — name,
sample kind, and the complete allowed label set. It is the source of truth
for the checked-in perf manifest (``tools/perf_manifest.py`` /
``_analysis/perf_manifest.json``): adding or relabeling a family without
regenerating the manifest fails tier-1, exactly like the compile golden.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch._observability.telemetry import _BUCKET_LABELS, _split_key

__all__ = [
    "render_prometheus",
    "render_openmetrics",
    "to_json",
    "EXPORT_VERSION",
    "EXPORT_SCHEMA",
]

EXPORT_VERSION = 2

_PREFIX = "tmtpu"

# family -> help text; families not listed get a generic line. Counter
# families (monotonic) are exported with the `_total` suffix per convention.
_HELP: Dict[str, str] = {
    "update_calls": "Metric update/forward executions by path taken.",
    "scan_steps": "Individual batches consumed through scan_update streams.",
    "fingerprint": "Host-attribute fingerprint guard outcomes on eager updates.",
    "quarantined_batches": "Batches dropped by the nan_policy='quarantine' sentinel.",
    "deferred_violations": "Compiled validate_args violations surfaced at host sync points.",
    "compute_calls": "compute() invocations by cache outcome.",
    "compiles": "Compiled-executable cache keys built, by compile kind.",
    "recompiles": "Additional cache keys beyond the first per compile kind (churn).",
    "churn_warnings": "Recompile-churn warnings emitted.",
    "churn_suppressed": "Recompile-churn warnings suppressed by rate limiting.",
    "trace_seconds": "Wall-clock seconds spent in first-call trace+lower+execute of compiled paths.",
    "sync_calls": "Distributed state synchronizations started, by guard mode.",
    "sync_attempts": "Guarded-sync collective attempts (includes retries).",
    "sync_retries": "Guarded-sync attempts beyond the first.",
    "degradations": "Recorded degradation events by kind (also on the event bus).",
    "snapshot_writes": "Snapshot generations written by the durability layer.",
    "snapshot_bytes": "Serialized snapshot payload bytes written.",
    "journal_entries": "Update-journal frames appended.",
    "journal_bytes": "Update-journal bytes appended.",
    "restores": "Snapshot restore outcomes.",
    "restore_replayed_updates": "Journaled updates replayed during restores.",
    "events": "Event-bus publishes by kind (lifetime, monotonic).",
    "uncompiled_signatures": "Distinct signatures streamed eagerly past the saturated auto cache.",
    "events_dropped": "Event-bus entries evicted by the capacity bound.",
    "latency_samples": "Lifetime latency samples recorded per op reservoir (monotonic).",
    "latency_sum_seconds": "Lifetime sum of sampled latency seconds per op (monotonic).",
    "latency_seconds": (
        "Sampled operation latency as a Prometheus summary: quantiles over the retained"
        " reservoir window, count/sum lifetime-monotonic."
    ),
    "latency_hist_seconds": (
        "Sampled operation latency as a cumulative histogram (lifetime-monotonic"
        " buckets; carries trace-id exemplars in the OpenMetrics exposition)."
    ),
    "telemetry_enabled": "1 while the telemetry layer is collecting.",
    "profiling_enabled": "1 while the continuous-profiling cost ledger is recording.",
    "pool_stream_updates": "Per-tenant applied StreamPool rows (bounded stream= label dimension).",
    "pool_quarantined": "Per-tenant StreamPool rows dropped by the NaN quarantine.",
    "pool_violations": "Per-tenant StreamPool rows dropped by error-severity validation flags.",
    "pool_attach": "StreamPool attach() calls.",
    "pool_detach": "StreamPool detach() calls.",
    "pool_growths": "StreamPool capacity-doubling growth events.",
    "pool_computes": "StreamPool compute dispatches by kind (cache misses only).",
    "serving_requests": "MetricServer requests by outcome (accepted/rejected/shed/served/failed).",
    "serving_batches": "Micro-batches dispatched by the ingest worker.",
    "serving_batch_rows": "Live rows dispatched across all micro-batches (excludes bucket padding).",
    "serving_controller_decisions": "SLO control-loop decisions by action (grow/shrink/shed/hold).",
    "serving_shed_episodes": "Load-shedding episodes entered at the ingress edge.",
    "serving_recoveries": "Preemption kill/restore cycles completed by the serving runtime.",
    "serving_batch_target": "Current micro-batch size target chosen by the SLO control loop.",
    "serving_ingest_burn": "Latest ingest-latency SLO burn rate seen by the control loop.",
    "serving_queue_depth": "Current bounded ingress-queue depth.",
    "pool_cost_device_seconds": (
        "Per-tenant apportioned micro-batch device seconds (equal share per applied row;"
        " bounded stream= label dimension)."
    ),
    "pool_cost_flops": (
        "Per-tenant apportioned XLA cost_analysis flops for executed stream steps."
    ),
    "pool_cost_state_byte_updates": (
        "Per-tenant predicted state bytes touched (closed-form per-row footprint x"
        " applied row updates)."
    ),
    "predicted_state_bytes": (
        "Closed-form predicted metric-state bytes from the static memory cost model"
        " (memory.json), summed over live instances; per-device for SPMD engines."
    ),
    "memory_model_drift": "Memory sanitizer drift findings (predicted vs live bytes).",
    "profile_device_seconds": "Measured wall seconds of profiled steps per (seam, class).",
    "profile_flops": "XLA cost_analysis flops accrued by profiled steps per (seam, class).",
    "profile_steps": "Profiled step executions per (seam, class).",
    "profile_unattributed_steps": (
        "Profiled steps with no executable cost claim (flops unattributed) per (seam, class)."
    ),
    "profile_mfu": (
        "Cumulative model-flops-utilization per (seam, class): accrued flops /"
        " (device seconds x peak flops)."
    ),
    "profile_roofline_ceiling": (
        "Roofline MFU ceiling per (seam, class) from the executable's arithmetic"
        " intensity and the active bandwidth/peak ceilings."
    ),
    "profile_compile_seconds": "Trace+lower+compile wall seconds per executable digest.",
    "aot_cache": "AOT executable cache load outcomes.",
    "fleet_rollups": (
        "Fleet aggregation-tree rollups completed per region, by outcome"
        " (full/partial; bounded region= label dimension)."
    ),
    "fleet_contributions": "Child contributions folded by fleet rollups per region.",
    "fleet_late_arrivals": (
        "Straggler contributions folded after their epoch's deadline per region."
    ),
    "fleet_duplicates_dropped": (
        "Redelivered/zombie contributions dropped by the epoch fence per region."
    ),
    "fleet_corrupt_quarantined": (
        "Contributions quarantined by integrity verification at fold time per region."
    ),
    "fleet_publish_attempts": "Guarded fleet publish attempts (includes retries) per region.",
    "fleet_rollup_staleness_ms": (
        "Age of the oldest contribution folded by the latest rollup per region."
    ),
}

# Every family the exporters may emit: sample kind + complete allowed label
# set. `metric` is the aggregation class label; histogram/summary synthetic
# labels (`le`, `quantile`) are listed explicitly. tools/perf_manifest.py
# freezes this table into _analysis/perf_manifest.json and tier-1 asserts
# the two stay identical AND that rendered output never strays outside it.
EXPORT_SCHEMA: Dict[str, Dict[str, Any]] = {
    "telemetry_enabled": {"kind": "gauge", "labels": ()},
    "profiling_enabled": {"kind": "gauge", "labels": ()},
    "update_calls": {"kind": "counter", "labels": ("metric", "path")},
    "scan_steps": {"kind": "counter", "labels": ("metric",)},
    "fingerprint": {"kind": "counter", "labels": ("metric", "outcome")},
    "quarantined_batches": {"kind": "counter", "labels": ("metric",)},
    "deferred_violations": {"kind": "counter", "labels": ("metric", "severity")},
    "compute_calls": {"kind": "counter", "labels": ("metric", "outcome")},
    "compiles": {"kind": "counter", "labels": ("metric", "kind")},
    "recompiles": {"kind": "counter", "labels": ("metric", "kind")},
    "uncompiled_signatures": {"kind": "counter", "labels": ("metric", "kind")},
    "churn_warnings": {"kind": "counter", "labels": ("metric",)},
    "churn_suppressed": {"kind": "counter", "labels": ("metric",)},
    "trace_seconds": {"kind": "counter", "labels": ("metric",)},
    "auto_path_disabled": {"kind": "counter", "labels": ("metric",)},
    "signature_overflow": {"kind": "counter", "labels": ("metric",)},
    "sync_calls": {"kind": "counter", "labels": ("metric", "mode")},
    "sync_attempts": {"kind": "counter", "labels": ("metric",)},
    "sync_retries": {"kind": "counter", "labels": ("metric",)},
    "degradations": {"kind": "counter", "labels": ("metric", "kind")},
    "snapshot_writes": {"kind": "counter", "labels": ("metric",)},
    "snapshot_bytes": {"kind": "counter", "labels": ("metric",)},
    "journal_entries": {"kind": "counter", "labels": ("metric",)},
    "journal_bytes": {"kind": "counter", "labels": ("metric",)},
    "restores": {"kind": "counter", "labels": ("metric", "outcome")},
    "restore_replayed_updates": {"kind": "counter", "labels": ("metric",)},
    "aot_cache": {"kind": "counter", "labels": ("metric", "result")},
    "memory_model_drift": {"kind": "counter", "labels": ("metric",)},
    "pool_stream_updates": {"kind": "counter", "labels": ("metric", "stream")},
    "pool_quarantined": {"kind": "counter", "labels": ("metric", "stream")},
    "pool_violations": {"kind": "counter", "labels": ("metric", "stream")},
    "pool_attach": {"kind": "counter", "labels": ("metric",)},
    "pool_detach": {"kind": "counter", "labels": ("metric",)},
    "pool_growths": {"kind": "counter", "labels": ("metric",)},
    "pool_computes": {"kind": "counter", "labels": ("metric", "kind")},
    "pool_cost_device_seconds": {"kind": "counter", "labels": ("metric", "stream")},
    "pool_cost_flops": {"kind": "counter", "labels": ("metric", "stream")},
    "pool_cost_state_byte_updates": {"kind": "counter", "labels": ("metric", "stream")},
    "predicted_state_bytes": {"kind": "gauge", "labels": ("metric", "scope")},
    "events": {"kind": "counter", "labels": ("kind",)},
    "events_dropped": {"kind": "counter", "labels": ()},
    "latency_seconds": {"kind": "summary", "labels": ("metric", "op", "quantile")},
    "latency_hist_seconds": {"kind": "histogram", "labels": ("metric", "op", "le")},
    "profile_device_seconds": {"kind": "counter", "labels": ("seam", "class")},
    "profile_flops": {"kind": "counter", "labels": ("seam", "class")},
    "profile_steps": {"kind": "counter", "labels": ("seam", "class")},
    "profile_unattributed_steps": {"kind": "counter", "labels": ("seam", "class")},
    "profile_mfu": {"kind": "gauge", "labels": ("seam", "class")},
    "profile_roofline_ceiling": {"kind": "gauge", "labels": ("seam", "class")},
    "profile_compile_seconds": {"kind": "counter", "labels": ("digest", "kind", "class")},
    "serving_requests": {"kind": "counter", "labels": ("metric", "outcome")},
    "serving_batches": {"kind": "counter", "labels": ("metric",)},
    "serving_batch_rows": {"kind": "counter", "labels": ("metric",)},
    "serving_controller_decisions": {"kind": "counter", "labels": ("metric", "action")},
    "serving_shed_episodes": {"kind": "counter", "labels": ("metric",)},
    "serving_recoveries": {"kind": "counter", "labels": ("metric",)},
    "serving_batch_target": {"kind": "gauge", "labels": ("metric",)},
    "serving_ingest_burn": {"kind": "gauge", "labels": ("metric",)},
    "serving_queue_depth": {"kind": "gauge", "labels": ("metric",)},
    "fleet_rollups": {"kind": "counter", "labels": ("metric", "region", "outcome")},
    "fleet_contributions": {"kind": "counter", "labels": ("metric", "region")},
    "fleet_late_arrivals": {"kind": "counter", "labels": ("metric", "region")},
    "fleet_duplicates_dropped": {"kind": "counter", "labels": ("metric", "region")},
    "fleet_corrupt_quarantined": {"kind": "counter", "labels": ("metric", "region")},
    "fleet_publish_attempts": {"kind": "counter", "labels": ("metric", "region")},
    "fleet_rollup_staleness_ms": {"kind": "gauge", "labels": ("metric", "region")},
}

# reservoir quantiles exported as summary lines (satellite: p50/p90/p99 per op)
_SUMMARY_QUANTILES = (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99"))

# counter families that ride a synthetic family (summary/histogram) instead
# of exporting standalone — re-emitting them would double every sample
_SYNTHETIC_SOURCES = frozenset({"latency_samples", "latency_sum_seconds", "latency_bucket"})


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(value: float) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int) or (isinstance(value, float) and value.is_integer()):
        return str(int(value))
    return repr(float(value))


def _sample(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


# one exposition sample: (name suffix, labels, value, exemplar-or-None);
# exemplars are (observed value, unix ts, trace id) and only the
# OpenMetrics serializer renders them
_Sample = Tuple[str, Dict[str, str], float, Optional[Tuple[float, float, int]]]


def _build_families(
    aggregate: Dict[str, Dict[str, Any]],
    bus: Any,
    enabled: bool,
    ledger: Any = None,
) -> Dict[str, Tuple[str, str, List[_Sample]]]:
    """Renderer-neutral exposition model: family -> (kind, help, samples).

    Family keys are the BASE name (``tmtpu_update_calls``) — suffixes
    (``_total``/``_sum``/``_count``/``_bucket``) live on the samples, so the
    classic and OpenMetrics serializers can each apply their own naming
    convention without re-walking the aggregate.
    """
    families: Dict[str, Tuple[str, str, List[_Sample]]] = {}

    def emit(
        family: str,
        labels: Dict[str, str],
        value: float,
        kind: str = "counter",
        suffix: str = "",
        exemplar: Optional[Tuple[float, float, int]] = None,
    ) -> None:
        name = f"{_PREFIX}_{family}"
        entry = families.get(name)
        if entry is None:
            help_text = _HELP.get(family, f"torchmetrics_tpu runtime telemetry: {family}.")
            entry = families[name] = (kind, help_text, [])
        entry[2].append((suffix, labels, value, exemplar))

    emit("telemetry_enabled", {}, 1 if enabled else 0, kind="gauge")
    for cls_name in sorted(aggregate):
        entry = aggregate[cls_name]
        base = {"metric": cls_name}
        # ops with any latency evidence: a live retained window, or lifetime
        # counters left behind by retired instances (count/sum still export)
        summary_ops = set(entry["latency"])
        hist_ops: Dict[str, Dict[str, float]] = {}
        for key in sorted(entry["counters"]):
            family, labels = _split_key(key)
            if family in _SYNTHETIC_SOURCES:
                # these ride the latency summary/histogram below as
                # `_count`/`_sum`/`_bucket` series — standalone re-emission
                # would export every sample twice under two names
                if "op" in labels:
                    summary_ops.add(labels["op"])
                    if family == "latency_bucket":
                        hist_ops.setdefault(labels["op"], {})[labels["le"]] = entry[
                            "counters"
                        ][key]
                continue
            emit(family, {**base, **labels}, entry["counters"][key])
        for key in sorted(entry.get("gauges", ())):
            family, labels = _split_key(key)
            emit(family, {**base, **labels}, entry["gauges"][key], kind="gauge")
        exemplars = entry.get("exemplars", {})
        for op in sorted(summary_ops):
            # Prometheus summary: quantile-labelled samples over the retained
            # reservoir window + lifetime-monotonic `_sum`/`_count` drawn from
            # the regular counters (they survive instance GC; the window
            # doesn't). An op known only from retired counters emits sum/count
            # with no quantiles — a valid, honest summary.
            stats = entry["latency"].get(op, {})
            labels = {**base, "op": op}
            for stat, q in _SUMMARY_QUANTILES:
                if stat in stats:
                    emit(
                        "latency_seconds",
                        {**labels, "quantile": q},
                        stats[stat],
                        kind="summary",
                    )
            lifetime_sum = entry["counters"].get(f"latency_sum_seconds|op={op}", stats.get("sum", 0.0))
            lifetime_count = entry["counters"].get(f"latency_samples|op={op}", stats.get("count", 0))
            emit("latency_seconds", labels, lifetime_sum, kind="summary", suffix="_sum")
            emit("latency_seconds", labels, lifetime_count, kind="summary", suffix="_count")
            buckets = hist_ops.get(op)
            if buckets:
                # per-bucket counters are recorded non-cumulative; the
                # cumulative sum of monotonic counters is itself monotonic,
                # so the exposed `le` series can never regress between scrapes
                running = 0.0
                for le in _BUCKET_LABELS:
                    running += buckets.get(le, 0.0)
                    emit(
                        "latency_hist_seconds",
                        {**labels, "le": le},
                        running,
                        kind="histogram",
                        suffix="_bucket",
                        exemplar=exemplars.get(f"{op}|{le}"),
                    )
                emit("latency_hist_seconds", labels, lifetime_sum, kind="histogram", suffix="_sum")
                emit("latency_hist_seconds", labels, running, kind="histogram", suffix="_count")
    for kind_name, count in sorted(bus.kind_totals().items()):
        emit("events", {"kind": kind_name}, count)
    emit("events_dropped", {}, bus.dropped)
    if ledger is not None:
        snap = ledger.snapshot()
        emit("profiling_enabled", {}, 1 if snap.get("enabled") else 0, kind="gauge")
        for row in snap.get("seams", ()):
            labels = {"seam": row["seam"], "class": row["class"]}
            emit("profile_device_seconds", labels, row["device_seconds"])
            emit("profile_flops", labels, row["flops"])
            emit("profile_steps", labels, row["steps"])
            emit("profile_unattributed_steps", labels, row["unattributed_steps"])
            if row.get("mfu") is not None:
                emit("profile_mfu", labels, row["mfu"], kind="gauge")
            if row.get("roofline_ceiling") is not None:
                emit("profile_roofline_ceiling", labels, row["roofline_ceiling"], kind="gauge")
        for digest, rec in sorted(snap.get("executables", {}).items()):
            emit(
                "profile_compile_seconds",
                {"digest": digest, "kind": rec["kind"], "class": rec["class"]},
                rec["compile_seconds"],
            )
    return families


def render_prometheus(
    aggregate: Dict[str, Dict[str, Any]], bus: Any, enabled: bool, ledger: Any = None
) -> str:
    """Classic text exposition of the registry aggregate + event-bus counts."""
    families = _build_families(aggregate, bus, enabled, ledger)
    # classic convention: counter FAMILY names carry `_total`; exemplars are
    # not representable in this format and are dropped
    lines: List[str] = []
    renamed: Dict[str, Tuple[str, str, List[_Sample]]] = {}
    for name, (kind, help_text, samples) in families.items():
        renamed[f"{name}_total" if kind == "counter" else name] = (kind, help_text, samples)
    for name in sorted(renamed):
        kind, help_text, samples = renamed[name]
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for suffix, labels, value, _exemplar in samples:
            lines.append(_sample(f"{name}{suffix}" if kind != "counter" else name, labels, value))
    return "\n".join(lines) + "\n"


def render_openmetrics(
    aggregate: Dict[str, Dict[str, Any]], bus: Any, enabled: bool, ledger: Any = None
) -> str:
    """OpenMetrics exposition: counter samples get `_total`, histogram
    buckets carry trace-id exemplars, and the stream ends with `# EOF`."""
    families = _build_families(aggregate, bus, enabled, ledger)
    lines: List[str] = []
    for name in sorted(families):
        kind, help_text, samples = families[name]
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for suffix, labels, value, exemplar in samples:
            sample_suffix = "_total" if kind == "counter" else suffix
            line = _sample(f"{name}{sample_suffix}", labels, value)
            if exemplar is not None and suffix == "_bucket":
                obs_value, obs_ts, trace_id = exemplar
                line += (
                    f' # {{trace_id="{trace_id}"}}'
                    f" {_fmt_value(obs_value)} {_fmt_value(round(obs_ts, 3))}"
                )
            lines.append(line)
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def to_json(
    aggregate: Dict[str, Dict[str, Any]], bus: Any, enabled: bool, ledger: Any = None
) -> Dict[str, Any]:
    """JSON-serializable snapshot (validated round-trippable in tests)."""
    payload = {
        "version": EXPORT_VERSION,
        "enabled": bool(enabled),
        "metrics": {
            name: {
                "counters": {k: v for k, v in sorted(entry["counters"].items())},
                "gauges": {k: v for k, v in sorted(entry.get("gauges", {}).items())},
                "latency": entry["latency"],
                "exemplars": {
                    k: {"value": ex[0], "ts": ex[1], "trace_id": ex[2]}
                    for k, ex in sorted(entry.get("exemplars", {}).items())
                },
                "instances": entry["instances"],
                "retired_instances": entry["retired_instances"],
            }
            for name, entry in sorted(aggregate.items())
        },
        "events": [
            {
                "seq": e.seq,
                "ts": e.ts,
                "mono": e.mono,
                "kind": e.kind,
                "source": e.source,
                "detail": e.detail,
                "data": e.data,
            }
            for e in bus.events()
        ],
        "events_dropped": bus.dropped,
    }
    if ledger is not None:
        payload["profiling"] = ledger.snapshot()
    # guarantee serializability at the source rather than at the caller
    json.dumps(payload)
    return payload
