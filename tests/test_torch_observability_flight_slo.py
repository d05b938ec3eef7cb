"""The port's flight recorder and SLOs on the CPU: the JAX package's behaviour tests, ported.

From ``tests/unittests/observability/test_flight.py`` and ``test_slo.py``.
The triggers, the seam table, trace attribution, the merged timeline, the
bounded windows, the on-disk artifacts and their retention, the
``perf_regression`` dump with its profiling section; SLO validation,
latency SLOs over the pooled reservoirs, windowed error budgets and the
readiness report. Where the JAX tests drive a quarantine, the tests first
ported here publish the degradation event or bump the counter family that a
quarantine would; the ``*_real_quarantine`` tests beside them drive the
port's own ``nan_policy="quarantine"``.
"""

import json
import time
import warnings

import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch._observability import (
    BUS,
    REGISTRY,
    arm_flight_recorder,
    disarm_flight_recorder,
    get_flight_recorder,
    health_report,
    set_slos,
    set_telemetry_enabled,
    set_telemetry_sampling,
    telemetry_for,
)
from torchmetrics_tpu_torch._observability.flight import DEFAULT_MAX_FILES, FlightRecorder
from torchmetrics_tpu_torch._observability.slo import DEFAULT_SLOS, FAST_BURN, SLO, SloTracker
from torchmetrics_tpu_torch._observability.state import DEFAULT_SAMPLE_EVERY
from torchmetrics_tpu_torch._observability.tracing import TRACER, set_tracing_enabled, trace_context

CPU = {"device": "cpu"}


def mse():
    return tm.MeanSquaredError(**CPU)


@pytest.fixture()
def flight(tmp_path):
    """Telemetry + tracing on, recorder armed at a tmp dir; pristine after."""
    set_telemetry_enabled(True)
    set_tracing_enabled(True)
    TRACER.clear()
    BUS.clear()
    recorder = arm_flight_recorder(directory=str(tmp_path / "flight"))
    yield recorder
    disarm_flight_recorder()
    set_tracing_enabled(False)
    set_telemetry_enabled(False)
    TRACER.clear()
    BUS.clear()
    REGISTRY.reset()


# ----------------------------------------------------------------- triggers
def test_degradation_event_dumps_exactly_once(flight):
    event = BUS.publish("degradation", "MSE", "sync_degraded: x", data={"kind": "sync_degraded"})
    assert flight.dump_count == 1
    (dump,) = flight.dumps()
    assert dump["seam"] == "guard.sync"
    assert dump["trigger"]["seq"] == event.seq
    assert flight.dump(event) is None
    assert flight.dump_count == 1


def test_non_trigger_kinds_do_not_dump(flight):
    BUS.publish("snapshot_write", "MSE", "generation 3")
    BUS.publish("auto_path_disabled", "MSE", "reason")
    BUS.publish("snapshot_restore", "MSE", "ok", data={"outcome": "ok"})
    BUS.publish("snapshot_restore", "MSE", "fallback", data={"outcome": "fallback"})
    assert flight.dump_count == 0
    BUS.publish("snapshot_restore", "MSE", "failed", data={"outcome": "failed"})
    assert flight.dump_count == 1
    assert flight.dumps()[0]["seam"] == "snapshot.restore"


def test_seam_resolution_table(flight):
    BUS.publish("degradation", "M", "q", data={"kind": "nan_quarantine"})
    BUS.publish("degradation", "M", "h", data={"kind": "handshake_degraded"})
    BUS.publish("degradation", "M", "s", data={"kind": "spmd_degraded"})
    BUS.publish("recompile_churn", "M", "shapes changed")
    BUS.publish("chaos_fault", "M", "injected", data={"seam": "guard.sync", "fault": "stall"})
    seams = [d["seam"] for d in flight.dumps()]
    assert seams == ["metric.update", "guard.sync", "spmd.step", "compile", "guard.sync"]


def test_recompile_churn_from_a_metric_dumps_at_the_compile_seam(flight):
    metric = mse()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with trace_context("request") as root:
            metric.update(torch.ones(4), torch.zeros(4))
            metric.update(torch.ones(5), torch.zeros(5))
    (dump,) = flight.dumps()
    assert dump["trigger"]["kind"] == "recompile_churn" and dump["seam"] == "compile"
    assert dump["trace_attribution"] == "ambient" and dump["trace_id"] == root.trace_id


# --------------------------------------------------------------- correlation
def test_dump_carries_the_ambient_trace_id(flight):
    metric = mse()
    with trace_context("request") as root:
        metric.update(torch.ones(4), torch.zeros(4))
        BUS.publish("degradation", "MeanSquaredError", "quarantined", data={"kind": "nan_quarantine"})
    (dump,) = flight.dumps()
    assert dump["trigger"]["data"]["kind"] == "nan_quarantine"
    assert dump["seam"] == "metric.update"
    assert dump["trace_attribution"] == "ambient"
    assert dump["trace_id"] == root.trace_id


def test_dump_falls_back_to_last_completed_span(flight):
    with trace_context("earlier"):
        mse().update(torch.ones(4), torch.zeros(4))
    BUS.publish("degradation", "M", "outside any context", data={"kind": "sync_degraded"})
    (dump,) = flight.dumps()
    assert dump["trace_attribution"] == "last_completed"
    assert dump["trace_id"] is not None


# ------------------------------------------------------------------ timeline
def test_timeline_merges_spans_and_events_in_monotonic_order(flight):
    metric = mse()
    with trace_context("req"):
        metric.update(torch.ones(4), torch.zeros(4))
        BUS.publish("snapshot_write", "MSE", "generation 0")
        metric.compute()
    BUS.publish("degradation", "MSE", "boom", data={"kind": "sync_degraded"})
    (dump,) = flight.dumps()
    monos = [r["mono"] for r in dump["timeline"]]
    assert monos == sorted(monos)
    assert {r["type"] for r in dump["timeline"]} == {"span", "event"}
    assert all(r.get("seq") != dump["trigger"]["seq"] for r in dump["timeline"] if r["type"] == "event")
    json.dumps(dump)


def test_dump_windows_are_bounded():
    set_telemetry_enabled(True)
    set_tracing_enabled(True)
    recorder = FlightRecorder(span_window=4, event_window=3).arm()
    try:
        metric = mse()
        for _ in range(10):
            with trace_context("r"):
                metric.update(torch.ones(2), torch.zeros(2))
            BUS.publish("snapshot_write", "M", "noise")
        BUS.publish("degradation", "M", "boom", data={"kind": "sync_degraded"})
        (dump,) = recorder.dumps()
        spans = [r for r in dump["timeline"] if r["type"] == "span"]
        events = [r for r in dump["timeline"] if r["type"] == "event"]
        assert len(spans) <= 4 and len(events) <= 3
    finally:
        recorder.disarm()
        set_tracing_enabled(False)
        set_telemetry_enabled(False)
        TRACER.clear()
        BUS.clear()
        REGISTRY.reset()


# ----------------------------------------------------------------- artifacts
def test_on_disk_artifact_matches_the_in_memory_dump(flight, tmp_path):
    BUS.publish("degradation", "MSE", "boom", data={"kind": "sync_degraded"})
    (dump,) = flight.dumps()
    files = sorted((tmp_path / "flight").glob("flight_*.json"))
    assert len(files) == 1
    assert f"{dump['trigger']['seq']:06d}" in files[0].name
    assert json.loads(files[0].read_text(encoding="utf-8")) == json.loads(json.dumps(dump))


def test_unserializable_span_attrs_degrade_to_repr(flight):
    import numpy as np

    with trace_context("req", payload=np.int32(7)):
        mse().update(torch.ones(2), torch.zeros(2))
    BUS.publish("degradation", "M", "boom", data={"kind": "sync_degraded"})
    assert flight.dump_count == 1
    (dump,) = flight.dumps()
    json.dumps(dump)
    spans = [r for r in dump["timeline"] if r["type"] == "span" and r["name"] == "req"]
    assert spans and spans[0]["attrs"]["payload"] == repr(np.int32(7))
    BUS.publish("degradation", "M", "again", data={"kind": "sync_degraded"})
    assert flight.dump_count == 2


def test_in_memory_only_when_no_directory():
    set_telemetry_enabled(True)
    recorder = FlightRecorder().arm()
    try:
        BUS.publish("degradation", "M", "x", data={"kind": "sync_degraded"})
        assert recorder.dump_count == 1 and recorder.directory is None
    finally:
        recorder.disarm()
        set_telemetry_enabled(False)
        BUS.clear()


# ----------------------------------------------------------------- lifecycle
def test_arm_replaces_and_disarm_stops(flight):
    assert get_flight_recorder() is flight
    second = arm_flight_recorder()
    try:
        assert get_flight_recorder() is second
        assert not flight.armed and second.armed
        BUS.publish("degradation", "M", "x", data={"kind": "sync_degraded"})
        assert second.dump_count == 1 and flight.dump_count == 0
    finally:
        disarm_flight_recorder()
    assert get_flight_recorder() is None
    BUS.publish("degradation", "M", "y", data={"kind": "sync_degraded"})
    assert second.dump_count == 1


def test_disabled_telemetry_means_no_triggers(flight):
    set_telemetry_enabled(False)
    metric = mse()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in (4, 5, 6):
            metric.update(torch.ones(n), torch.zeros(n))  # churn, unpublished
    BUS.publish("degradation", "M", "x", data={"kind": "sync_degraded"})
    assert flight.dump_count == 0


def test_arming_with_telemetry_off_warns():
    set_telemetry_enabled(False)
    with pytest.warns(UserWarning, match="telemetry disabled"):
        recorder = arm_flight_recorder()
    recorder.disarm()
    disarm_flight_recorder()


def test_arming_reads_the_flight_dir_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("TM_TPU_FLIGHT_DIR", str(tmp_path / "from_env"))
    set_telemetry_enabled(True)
    try:
        recorder = arm_flight_recorder()
        assert recorder.directory == str(tmp_path / "from_env")
        BUS.publish("degradation", "M", "x", data={"kind": "sync_degraded"})
        assert len(list((tmp_path / "from_env").glob("flight_*.json"))) == 1
    finally:
        disarm_flight_recorder()
        set_telemetry_enabled(False)
        BUS.clear()


# ------------------------------------------------------------ disk retention
def test_disk_retention_cap_evicts_oldest_first(tmp_path):
    set_telemetry_enabled(True)
    dump_dir = tmp_path / "flight"
    recorder = arm_flight_recorder(directory=str(dump_dir), max_files=5)
    try:
        events = [BUS.publish("degradation", "M", f"boom {i}", data={"kind": "sync_degraded"}) for i in range(12)]
        assert recorder.dump_count == 12
        files = sorted(dump_dir.glob("flight_*.json"))
        assert len(files) == 5
        assert {int(f.name.split("_")[1]) for f in files} == {e.seq for e in events[-5:]}
    finally:
        disarm_flight_recorder()
        set_telemetry_enabled(False)
        BUS.clear()


def test_disk_retention_never_touches_foreign_files(tmp_path):
    set_telemetry_enabled(True)
    dump_dir = tmp_path / "flight"
    dump_dir.mkdir()
    (dump_dir / "notes.txt").write_text("keep me", encoding="utf-8")
    (dump_dir / "flight_report.json").write_text("{}", encoding="utf-8")
    (dump_dir / "flight_plan.md").write_text("# keep", encoding="utf-8")
    arm_flight_recorder(directory=str(dump_dir), max_files=2)
    try:
        for i in range(6):
            BUS.publish("degradation", "M", f"boom {i}", data={"kind": "sync_degraded"})
        assert (dump_dir / "notes.txt").exists()
        assert (dump_dir / "flight_report.json").exists()
        assert (dump_dir / "flight_plan.md").exists()
        assert len(list(dump_dir.glob("flight_0*.json"))) == 2
    finally:
        disarm_flight_recorder()
        set_telemetry_enabled(False)
        BUS.clear()


def test_max_files_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("TM_TPU_FLIGHT_MAX_FILES", "3")
    assert FlightRecorder(directory=str(tmp_path)).max_files == 3
    monkeypatch.setenv("TM_TPU_FLIGHT_MAX_FILES", "not-a-number")
    assert FlightRecorder(directory=str(tmp_path)).max_files == DEFAULT_MAX_FILES
    monkeypatch.setenv("TM_TPU_FLIGHT_MAX_FILES", "0")
    assert FlightRecorder(directory=str(tmp_path)).max_files == 1
    assert FlightRecorder(directory=str(tmp_path), max_files=9).max_files == 9


# ------------------------------------------------------------ perf regression
def test_perf_regression_dump_carries_profiling_section(flight, tmp_path):
    from torchmetrics_tpu_torch._observability.profiling import LEDGER, reset_ledger, set_profiling_enabled

    reset_ledger()
    set_profiling_enabled(True)
    try:
        with trace_context("soak"):
            for _ in range(200):
                LEDGER.record_step("update_compiled", "MeanMetric", 0.001)
            for _ in range(10):
                LEDGER.record_step("update_compiled", "MeanMetric", 0.010)
        assert flight.dump_count == 1
        (dump,) = flight.dumps()
        assert dump["trigger"]["kind"] == "perf_regression"
        assert dump["seam"] == "update_compiled"
        assert dump["trigger"]["data"]["trace_id"] == dump["trace_id"]
        prof = dump["profiling"]
        assert "update_compiled" in {r["seam"] for r in prof["ledger"]["seams"]}
        assert prof["ledger"]["regressions"] == {"update_compiled": 1}
        assert isinstance(prof["tenant_costs"], dict)
        (path,) = (tmp_path / "flight").glob("flight_*_perf_regression.json")
        on_disk = json.loads(path.read_text(encoding="utf-8"))
        assert on_disk["profiling"]["ledger"]["regressions"] == {"update_compiled": 1}
    finally:
        set_profiling_enabled(False)
        reset_ledger()


def test_ordinary_dumps_carry_no_profiling_section(flight):
    BUS.publish("degradation", "M", "boom", data={"kind": "sync_degraded"})
    (dump,) = flight.dumps()
    assert "profiling" not in dump


# ======================================================================= SLOs
@pytest.fixture()
def telemetry():
    set_telemetry_enabled(True)
    set_telemetry_sampling(1)
    yield REGISTRY
    set_telemetry_enabled(False)
    set_telemetry_sampling(DEFAULT_SAMPLE_EVERY)
    REGISTRY.reset()
    BUS.clear()
    set_slos(None)


class _Source:
    """A stand-in counter owner: the registry aggregates telemetry by class name."""


def test_slo_must_pick_exactly_one_mode():
    with pytest.raises(ValueError, match="exactly one mode"):
        SLO(name="neither")
    with pytest.raises(ValueError, match="exactly one mode"):
        SLO(name="both", op="compute", threshold_ms=1.0, bad=("degradations",))
    with pytest.raises(ValueError, match="objective"):
        SLO(name="bad", op="compute", threshold_ms=1.0, objective=1.0)
    with pytest.raises(ValueError, match="threshold_ms"):
        SLO(name="half", op="compute")
    with pytest.raises(ValueError, match="window_s"):
        SLO(name="w", bad=("degradations",), window_s=0)
    with pytest.raises(ValueError, match="duplicate"):
        SloTracker([SLO(name="x", bad=("a",)), SLO(name="x", bad=("b",))])


def test_budget_and_kind_properties():
    lat = SLO(name="l", op="compute", threshold_ms=5.0, objective=0.99)
    err = SLO(name="e", bad=("degradations",), objective=0.999)
    assert lat.kind == "latency" and err.kind == "error_rate"
    assert lat.budget == pytest.approx(0.01)
    assert err.budget == pytest.approx(0.001)


def test_latency_slo_judges_the_pooled_reservoirs(telemetry):
    metric = mse()
    for _ in range(8):
        metric.update(torch.ones(16), torch.zeros(16))
    ok = SloTracker([SLO(name="lat", op="update_compiled", threshold_ms=60_000.0)])
    status = ok.health_report().status_of("lat")
    assert status.status == "ok" and status.compliance == 1.0 and status.burn_rate == 0.0
    assert status.observed["samples"] >= 4
    assert status.observed["p99_ms"] <= status.observed["worst_ms"]
    bad = SloTracker([SLO(name="lat", op="update_compiled", threshold_ms=1e-9)])
    status = bad.health_report().status_of("lat")
    assert status.compliance == 0.0
    assert status.burn_rate == pytest.approx(1.0 / 0.01)
    assert status.burn_rate > FAST_BURN and status.status == "violated"


def test_latency_slo_with_no_samples_is_ok(telemetry):
    tracker = SloTracker([SLO(name="lat", op="never_recorded", threshold_ms=1.0)])
    status = tracker.health_report().status_of("lat")
    assert status.status == "ok" and status.observed["samples"] == 0


def test_error_rate_slo_lifetime_then_windowed(telemetry):
    metric, source = mse(), _Source()
    bad = telemetry_for(source)
    for _ in range(9):
        metric.update(torch.ones(8), torch.zeros(8))
    metric.update(torch.ones(8), torch.zeros(8))
    bad.inc("quarantined_batches")  # 1 bad of 10 updates
    slo = SLO(name="q", bad=("quarantined_batches",), total=("update_calls",), objective=0.8)
    tracker = SloTracker([slo])
    status = tracker.health_report().status_of("q")
    assert status.compliance == pytest.approx(0.9)
    assert status.burn_rate == pytest.approx(0.1 / 0.2)
    assert status.status == "ok"
    for _ in range(5):
        metric.update(torch.ones(8), torch.zeros(8))
    status = tracker.health_report().status_of("q")
    assert status.observed["bad"] == 0.0
    assert status.compliance == 1.0 and status.burn_rate == 0.0
    metric.update(torch.ones(8), torch.zeros(8))
    bad.inc("quarantined_batches")
    status = tracker.health_report().status_of("q")
    assert status.compliance == pytest.approx(5.0 / 6.0)
    assert status.burn_rate == pytest.approx((1.0 / 6.0) / 0.2)
    assert status.status == "ok"


def test_error_rate_burst_after_window_expiry_is_at_risk(telemetry):
    metric, source = mse(), _Source()
    for _ in range(50):
        metric.update(torch.ones(8), torch.zeros(8))
    slo = SLO(name="q", bad=("quarantined_batches",), total=("update_calls",), objective=0.8, window_s=0.01)
    tracker = SloTracker([slo])
    tracker.health_report()
    time.sleep(0.05)
    metric.update(torch.ones(8), torch.zeros(8))
    telemetry_for(source).inc("quarantined_batches")
    status = tracker.health_report().status_of("q")
    assert status.compliance == pytest.approx(0.0)
    assert status.burn_rate == pytest.approx(1.0 / 0.2)
    assert status.status == "at_risk"


def test_error_rate_slo_with_no_traffic_is_ok(telemetry):
    tracker = SloTracker([SLO(name="e", bad=("degradations",), total=("update_calls",))])
    status = tracker.health_report().status_of("e")
    assert status.status == "ok" and status.compliance == 1.0
    assert status.observed["total"] == 0.0


def test_bad_events_with_zero_denominator_traffic_never_read_ok(telemetry):
    source = _Source()
    telemetry_for(source).inc("degradations|kind=nan_quarantine")
    tracker = SloTracker([SLO(name="d", bad=("degradations",), total=("sync_calls",), objective=0.9)])
    status = tracker.health_report().status_of("d")
    assert status.observed["bad"] >= 1 and status.observed["total"] == 0.0
    assert status.compliance == 0.0
    assert status.burn_rate == pytest.approx(1.0 / 0.1)
    assert status.status == "at_risk"


def test_health_report_shape_and_serializability(telemetry):
    mse().update(torch.ones(4), torch.zeros(4))
    report = health_report()
    assert {s.name for s in report.slos} == {s.name for s in DEFAULT_SLOS}
    assert report.healthy is True
    assert report.telemetry_enabled is True
    payload = report.to_json()
    assert json.loads(json.dumps(payload)) == payload
    assert report.status_of("nope") is None


def test_health_report_goes_unhealthy_on_violation(telemetry):
    metric = mse()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the shapes churn on purpose
        for n in range(1, 5):
            metric.update(torch.ones(n), torch.zeros(n))  # four first calls: four eager updates
    tracker = set_slos([SLO(name="impossible", op="update_eager", threshold_ms=1e-9)])
    report = tracker.health_report()
    assert not report.healthy
    assert report.status_of("impossible").status == "violated"
    assert health_report().healthy is False


# ------------------------------------------------- on a real quarantine
def _quarantining():
    return tm.MeanSquaredError(nan_policy="quarantine", **CPU)


def _nan(n):
    return torch.full((n,), float("nan")), torch.zeros(n)


def test_dump_carries_the_ambient_trace_id_real_quarantine(flight):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric = _quarantining()
        with trace_context("request") as root:
            metric.update(*_nan(4))
    (dump,) = flight.dumps()
    assert dump["trigger"]["data"]["kind"] == "nan_quarantine"
    assert dump["seam"] == "metric.update"
    assert dump["trace_attribution"] == "ambient"
    assert dump["trace_id"] == root.trace_id
    assert metric.resilience_report().quarantined_updates == 1


def test_disabled_telemetry_means_no_triggers_real_quarantine(flight):
    set_telemetry_enabled(False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric = _quarantining()
        metric.update(*_nan(4))
    # recorded on the metric, never published: the recorder (a bus subscriber) has nothing
    assert flight.dump_count == 0 and metric.resilience_report().quarantined_updates == 1


def test_error_rate_slo_lifetime_then_windowed_real_quarantine(telemetry):
    good = torch.ones(8), torch.zeros(8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric = _quarantining()
        for _ in range(9):
            metric.update(*good)
        metric.update(*_nan(8))  # 1 quarantined of 10 updates
    tracker = SloTracker([SLO(name="q", bad=("quarantined_batches",), total=("update_calls",), objective=0.8)])
    status = tracker.health_report().status_of("q")
    assert status.compliance == pytest.approx(0.9)
    assert status.burn_rate == pytest.approx(0.1 / 0.2)
    assert status.status == "ok"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(5):
            metric.update(*good)
    status = tracker.health_report().status_of("q")
    assert status.observed["bad"] == 0.0 and status.compliance == 1.0 and status.burn_rate == 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric.update(*_nan(8))
    status = tracker.health_report().status_of("q")
    assert status.compliance == pytest.approx(5.0 / 6.0)
    assert status.burn_rate == pytest.approx((1.0 / 6.0) / 0.2)
    assert status.status == "ok"


def test_error_rate_burst_after_window_expiry_is_at_risk_real_quarantine(telemetry):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric = _quarantining()
        for _ in range(50):
            metric.update(torch.ones(8), torch.zeros(8))
    tracker = SloTracker([SLO(name="q", bad=("quarantined_batches",), total=("update_calls",), objective=0.8,
                              window_s=0.01)])
    tracker.health_report()
    time.sleep(0.05)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric.update(*_nan(8))
    status = tracker.health_report().status_of("q")
    assert status.compliance == pytest.approx(0.0)
    assert status.burn_rate == pytest.approx(1.0 / 0.2)
    assert status.status == "at_risk"


def test_bad_events_with_zero_denominator_traffic_never_read_ok_real_quarantine(telemetry):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _quarantining().update(*_nan(4))
    tracker = SloTracker([SLO(name="d", bad=("degradations",), total=("sync_calls",), objective=0.9)])
    status = tracker.health_report().status_of("d")
    assert status.observed["bad"] >= 1 and status.observed["total"] == 0.0
    assert status.compliance == 0.0
    assert status.burn_rate == pytest.approx(1.0 / 0.1)
    assert status.status == "at_risk"
