"""Span tracing and recompile churn in the port, on the CPU: the JAX package's behaviour tests, ported.

From ``tests/unittests/observability/test_tracing.py`` and ``test_churn.py``:
span lifecycle and contextvar parentage, the update/compute/forward seams
and a collection's fan-out, the bounded recorder ring, the Chrome
trace-event export, the disabled path, the guarded sync's attempts and the
snapshot write and restore spans; churn warnings naming the changed
cache-key components, the bus events, the signature overflow. The span
tests through the stream pool wait for ``_streams/`` (ROADMAP item 7). Added for the port: a
signature on another layout is a component of its own (``layouts``).
"""

import json
import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch._observability import BUS, REGISTRY, RecompileChurnWarning, set_telemetry_enabled
from torchmetrics_tpu_torch._observability.state import OBS
from torchmetrics_tpu_torch._observability.tracing import (
    NULL_SPAN,
    TRACER,
    SpanRecorder,
    begin_span,
    current_span,
    current_trace_id,
    end_span,
    export_chrome_trace,
    set_tracing_enabled,
    span_tree,
    trace_context,
    tracing_enabled,
)

CPU = {"device": "cpu"}


@pytest.fixture()
def tracing():
    """Enable span collection for one test; restore the pristine state."""
    set_tracing_enabled(True)
    TRACER.clear()
    yield TRACER
    set_tracing_enabled(False)
    TRACER.clear()
    REGISTRY.reset()
    BUS.clear()


@pytest.fixture()
def telemetry():
    set_telemetry_enabled(True)
    yield
    set_telemetry_enabled(False)
    REGISTRY.reset()
    BUS.clear()


def mse():
    return tm.MeanSquaredError(**CPU)


# ----------------------------------------------------------------- lifecycle
def test_spans_link_parent_child_via_contextvar(tracing):
    with trace_context("request") as root:
        assert current_span() is root
        assert current_trace_id() == root.trace_id
        child = begin_span("inner", "X", foo=1)
        assert child.parent_id == root.span_id
        assert child.trace_id == root.trace_id
        grandchild = begin_span("leaf", "X")
        assert grandchild.parent_id == child.span_id
        end_span(grandchild)
        assert current_span() is child
        end_span(child)
        assert current_span() is root
    assert current_span() is None
    names = [s.name for s in TRACER.spans(trace_id=root.trace_id)]
    assert names == ["leaf", "inner", "request"]


def test_error_spans_carry_status_and_message(tracing):
    with pytest.raises(RuntimeError):
        with trace_context("failing"):
            raise RuntimeError("boom")
    span = TRACER.spans(name="failing")[-1]
    assert span.status == "error"
    assert "RuntimeError: boom" in span.error


def test_error_in_an_update_marks_its_span(tracing):
    metric = tm.classification.MulticlassAccuracy(num_classes=3, **CPU)
    with pytest.raises(RuntimeError):
        metric.update(torch.zeros(4, 3), torch.tensor([0, 1, 2, 7]))
    (span,) = TRACER.spans(name="update")
    assert span.status == "error" and span.attrs["path"] == "eager"


def test_disabled_path_records_nothing():
    set_tracing_enabled(False)
    TRACER.clear()
    assert not tracing_enabled()
    with trace_context("request") as sp:
        assert sp is NULL_SPAN
        sp.attrs["tenant"] = "42"
        assert sp.attrs == {} and sp.trace_id is None
        assert current_trace_id() is None
        m = mse()
        m.update(torch.ones(4), torch.zeros(4))
        m.compute()
    assert len(TRACER) == 0


def test_recorder_ring_is_bounded():
    rec = SpanRecorder(capacity=4)
    set_tracing_enabled(True)
    try:
        for i in range(7):
            s = begin_span(f"s{i}")
            end_span(s)
            rec.record(s)
    finally:
        set_tracing_enabled(False)
    assert len(rec) == 4
    assert rec.dropped == 3
    assert rec.recorded == 7
    assert [s.name for s in rec.recent(2)] == ["s5", "s6"]
    TRACER.clear()


def test_distinct_requests_get_distinct_trace_ids(tracing):
    with trace_context("a") as a:
        pass
    with trace_context("b") as b:
        pass
    assert a.trace_id != b.trace_id


# ----------------------------------------------------------------- the seams
def test_metric_update_compute_tree(tracing):
    metric = mse()
    with trace_context("eval") as root:
        metric.update(torch.ones(4), torch.zeros(4))
        metric.update(torch.ones(4), torch.zeros(4))
        metric.compute()
        metric.compute()
    (tree,) = span_tree(root.trace_id)
    assert tree["name"] == "eval"
    names = [c["name"] for c in tree["children"]]
    assert names == ["update", "update", "compute", "compute"]
    paths = [c["attrs"].get("path") for c in tree["children"][:2]]
    assert paths == ["eager", "auto"]
    assert tree["children"][3]["attrs"]["outcome"] == "cache_hit"
    assert tree["children"][0]["t1_mono"] <= tree["children"][2]["t0_mono"]


def test_metric_update_sync_compute_tree(tracing):
    """The guarded path's tree: update and compute under the request, the guarded sync and its attempts under compute."""
    from torchmetrics_tpu_torch._resilience.faultinject import simulated_world
    from torchmetrics_tpu_torch._resilience.policy import RetryPolicy, SyncPolicy

    with simulated_world(2):
        metric = tm.MeanSquaredError(sync_policy=SyncPolicy(retry=RetryPolicy(max_retries=1)), **CPU)
        with trace_context("eval") as root:
            metric.update(torch.ones(4), torch.zeros(4))
            metric.compute()
    (tree,) = span_tree(root.trace_id)
    assert tree["name"] == "eval"
    children = {c["name"]: c for c in tree["children"]}
    assert set(children) == {"update", "compute"}
    assert children["update"]["attrs"]["path"] == "eager"
    (sync,) = children["compute"]["children"]
    assert sync["name"] == "sync" and sync["attrs"]["mode"] == "guarded"
    attempts = [c for c in sync["children"] if c["name"] == "sync_attempt"]
    assert len(attempts) == 2  # the handshake and the state gather, one attempt each
    assert all(a["parent_id"] == sync["span_id"] for a in attempts)
    assert children["update"]["t1_mono"] <= children["compute"]["t0_mono"]


def test_snapshot_write_and_restore_spans(tracing, tmp_path):
    from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy

    metric = mse()
    with SnapshotManager(metric, tmp_path, SnapshotPolicy(every_n_updates=10, async_write=False)):
        with trace_context("ingest") as root:
            # the first update anchors the base snapshot; the next two journal
            for i in range(3):
                metric.update(torch.ones(4) * i, torch.zeros(4))
    writes = [s for s in TRACER.spans(trace_id=root.trace_id) if s.name == "snapshot.write"]
    assert writes and writes[0].source == "MeanSquaredError"
    assert writes[0].attrs["generation"] == 0
    fresh = mse()
    with SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False)) as mgr:
        with trace_context("recover") as root2:
            mgr.restore_latest()
    restores = [s for s in TRACER.spans(trace_id=root2.trace_id) if s.name == "snapshot.restore"]
    assert restores and restores[0].attrs["replayed"] == 2
    # the restore replays through the real update path, inside the same recovery trace
    assert [s for s in TRACER.spans(trace_id=root2.trace_id) if s.name == "update"]


def test_forward_parents_the_inner_dance(tracing):
    metric = mse()
    with trace_context("step") as root:
        metric.forward(torch.ones(4), torch.zeros(4))
    (tree,) = span_tree(root.trace_id)
    (fwd,) = tree["children"]
    assert fwd["name"] == "forward"
    inner = {c["name"] for c in fwd["children"]}
    assert "update" in inner


def test_collection_update_parents_member_updates(tracing):
    mc = tm.MetricCollection({"mse": mse(), "mae": tm.MeanAbsoluteError(**CPU)}, compute_groups=False)
    with trace_context("fanout") as root:
        mc.update(torch.ones(4), torch.zeros(4))
    (tree,) = span_tree(root.trace_id)
    (coll,) = tree["children"]
    assert coll["name"] == "update" and coll["source"] == "MetricCollection"
    member_sources = sorted(c["source"] for c in coll["children"] if c["name"] == "update")
    assert member_sources == ["MeanAbsoluteError", "MeanSquaredError"]


def test_seam_spans_are_roots_outside_any_context(tracing):
    metric = mse()
    metric.update(torch.ones(4), torch.zeros(4))
    span = TRACER.spans(name="update")[-1]
    assert span.parent_id == 0


# ----------------------------------------------------------------- exports
def test_chrome_export_is_loadable_without_a_trace_filter(tracing, tmp_path):
    with trace_context("one"):
        mse().update(torch.ones(4), torch.zeros(4))
    out = tmp_path / "trace.json"
    payload = export_chrome_trace(path=str(out))
    assert json.loads(out.read_text(encoding="utf-8")) == payload
    assert payload["displayTimeUnit"] == "ms"
    events = payload["traceEvents"]
    assert [e["name"] for e in events] == ["MeanSquaredError.update", "one"]
    for ev in events:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        for key in ("name", "cat", "ts", "dur", "pid", "tid", "args"):
            assert key in ev
    ids = {ev["args"]["span_id"] for ev in events}
    assert [ev["name"] for ev in events if ev["args"]["parent_id"] not in ids] == ["one"]


def test_chrome_export_coerces_unserializable_attrs(tracing):
    with trace_context("req", payload=np.int32(7)) as root:
        pass
    payload = export_chrome_trace(trace_id=root.trace_id)
    json.dumps(payload)
    (ev,) = payload["traceEvents"]
    assert ev["args"]["payload"] == repr(np.int32(7))


def test_span_tree_survives_evicted_roots(tracing):
    with trace_context("root") as root:
        for i in range(3):
            end_span(begin_span(f"c{i}"))
    orphans = tuple(s for s in TRACER.spans(trace_id=root.trace_id) if s.name != "root")
    trees = span_tree(root.trace_id, spans=orphans)
    assert len(trees) == 3


def test_telemetry_and_tracing_switch_independently(tracing):
    assert tracing_enabled() and not OBS.enabled
    set_telemetry_enabled(True)
    try:
        m = mse()
        m.update(torch.ones(4), torch.zeros(4))
        assert m.telemetry_report().total_updates == 1
        assert TRACER.spans(name="update")
    finally:
        set_telemetry_enabled(False)
        REGISTRY.reset()


# ----------------------------------------------------------------- churn
def _churn_warnings(record):
    return [w for w in record if issubclass(w.category, RecompileChurnWarning)]


def test_shape_variation_fires_exactly_one_warning_naming_shapes(telemetry):
    metric = mse()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        for n in (8, 9, 10, 11):
            for _ in range(2):  # each signature: one eager warm-up + one compiled step
                metric.update(torch.ones(n), torch.zeros(n))
    churn = _churn_warnings(record)
    assert len(churn) == 1, [str(w.message) for w in churn]
    message = str(churn[0].message)
    assert "shapes" in message
    assert "(8,)" in message and "(9,)" in message
    rep = metric.telemetry_report()
    assert rep.churn["warnings"] == 1
    assert rep.churn["suppressed"] == 2
    assert rep.counter("recompiles|kind=auto_update") == 3
    assert rep.counter("compiles|kind=auto_update") == 4


def test_dtype_variation_names_dtypes_component(telemetry):
    metric = mse()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        metric.update(torch.ones(8, dtype=torch.float32), torch.zeros(8, dtype=torch.float32))
        metric.update(torch.ones(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32))
    churn = _churn_warnings(record)
    assert len(churn) == 1
    assert "dtypes" in str(churn[0].message)
    assert "shapes" not in str(churn[0].message).split("changed (")[1].split(")")[0]


def test_layout_variation_names_the_layouts_component(telemetry):
    """A graph reads its batch in the layout the eager update read: a new layout is a new signature."""
    metric = tm.classification.MulticlassAccuracy(num_classes=4, **CPU)
    p = torch.rand(8, 4)
    t = torch.randint(0, 4, (8,))
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        metric.update(p, t)
        metric.update(p.t().contiguous().t(), t)  # the same values, column-major
    (warning,) = _churn_warnings(record)
    (event,) = BUS.events(kind="recompile_churn")
    assert event.data["changed"] == ["layouts"] and "layouts" in str(warning.message)


def test_stable_shapes_never_warn(telemetry):
    metric = mse()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        for _ in range(10):
            metric.update(torch.ones(8), torch.zeros(8))
    assert not _churn_warnings(record)
    rep = metric.telemetry_report()
    assert rep.counter("compiles|kind=auto_update") == 1
    assert rep.counter("recompiles|kind=auto_update") == 0


def test_churn_events_reach_the_bus(telemetry):
    metric = mse()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in (8, 9):
            metric.update(torch.ones(n), torch.zeros(n))
    events = BUS.events(kind="recompile_churn", source="MeanSquaredError")
    assert len(events) == 1
    assert events[0].data["changed"] == ["shapes"]


def test_signature_overflow_counts_under_relentless_churn(telemetry):
    metric = mse()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in range(4, 4 + metric._AUTO_MAX_SIGNATURES + 3):
            metric.update(torch.ones(n), torch.zeros(n))
    rep = metric.telemetry_report()
    assert rep.counter("signature_overflow") == 3
    assert rep.counter("uncompiled_signatures|kind=auto_update") == 3
    assert rep.counter("compiles|kind=auto_update") == metric._AUTO_MAX_SIGNATURES
    assert rep.path_counts.get("auto_compiled") is None


def test_disabled_telemetry_never_warns_on_churn():
    metric = mse()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        for n in (8, 9, 10):
            for _ in range(2):
                metric.update(torch.ones(n), torch.zeros(n))
    assert not _churn_warnings(record)
