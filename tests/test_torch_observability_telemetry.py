"""The port's telemetry layer on the CPU: the JAX package's behaviour tests, ported.

From ``tests/unittests/observability/test_telemetry.py`` and
``test_telemetry_e2e.py``: the reservoir and event-bus building blocks, the
counters each runtime seam records, the kill switches, the registry and its
retirement of collected metrics, the exports (checked with
``prometheus_client``'s parser), a collection's report, and the counters of
``nan_policy``, guarded sync and snapshots (``_resilience/``). Added for the port: a metric's telemetry stays out of
``state_dict``, ``.to()``, ``clone`` and pickling, and the metrics that
wrappers and ``FeatureShare`` hold retire from the registry when collected.
"""

import gc
import json
import math
import pickle
import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch import MetricCollection, aggregation
from torchmetrics_tpu_torch._compile import eligibility_verdict
from torchmetrics_tpu_torch._observability import (
    BUS,
    REGISTRY,
    EventBus,
    LatencyReservoir,
    TelemetryReport,
    set_telemetry_enabled,
    set_telemetry_sampling,
    telemetry_enabled,
)
from torchmetrics_tpu_torch._observability.state import DEFAULT_SAMPLE_EVERY

CPU = {"device": "cpu"}


@pytest.fixture()
def telemetry():
    """Enable collection for one test; restore the pristine disabled state."""
    set_telemetry_enabled(True)
    set_telemetry_sampling(1)  # deterministic reservoirs in tests
    yield REGISTRY
    set_telemetry_enabled(False)
    set_telemetry_sampling(DEFAULT_SAMPLE_EVERY)
    REGISTRY.reset()
    BUS.clear()


def ones(n=8):
    return torch.ones(n), torch.zeros(n)


# --------------------------------------------------------------- reservoir
def test_reservoir_ring_and_stats():
    res = LatencyReservoir(capacity=4)
    assert res.stats() == {"count": 0}
    assert math.isnan(res.quantile(0.5))
    for v in (1.0, 2.0, 3.0):
        res.push(v)
    assert res.values() == [1.0, 2.0, 3.0]
    for v in (4.0, 5.0):  # wraps: retains the most recent 4
        res.push(v)
    assert res.values() == [2.0, 3.0, 4.0, 5.0]
    stats = res.stats()
    assert stats["count"] == 5  # lifetime-exact even after eviction
    assert stats["min"] == 1.0 and stats["max"] == 5.0
    assert stats["sum"] == pytest.approx(15.0)
    assert stats["p50"] == 3.0  # over the retained window
    assert LatencyReservoir(capacity=1).capacity == 1
    with pytest.raises(ValueError):
        LatencyReservoir(capacity=0)


# --------------------------------------------------------------- event bus
def test_event_bus_publish_subscribe_and_bounds(telemetry):
    bus = EventBus(capacity=3)
    seen = []
    unsubscribe = bus.subscribe(seen.append)
    for i in range(5):
        bus.publish("k", "src", f"event {i}")
    assert len(bus) == 3 and bus.dropped == 2
    assert [e.detail for e in bus.events()] == ["event 2", "event 3", "event 4"]
    assert len(seen) == 5  # subscribers see every publish, eviction or not
    seqs = [e.seq for e in bus.events()]
    assert seqs == sorted(seqs)
    unsubscribe()
    bus.publish("k", "src", "after unsubscribe")
    assert len(seen) == 5
    assert bus.kind_counts() == {"k": 3}


def test_event_bus_lifetime_totals_survive_eviction(telemetry):
    bus = EventBus(capacity=3)
    for i in range(5):
        bus.publish("k", "src", f"event {i}")
    assert bus.kind_counts() == {"k": 3}
    assert bus.kind_totals() == {"k": 5}
    bus.clear()
    assert bus.kind_totals() == {}


def test_event_bus_disabled_is_silent():
    set_telemetry_enabled(False)
    bus = EventBus()
    assert bus.publish("k", "src", "dropped") is None
    assert len(bus) == 0
    # force=True bypasses the switch (harness heartbeats)
    assert bus.publish("k", "src", "forced", force=True) is not None
    assert len(bus) == 1


def test_event_bus_bad_subscriber_dropped(telemetry):
    bus = EventBus()

    def bad(_e):
        raise RuntimeError("boom")

    bus.subscribe(bad)
    with pytest.warns(UserWarning, match="subscriber"):
        bus.publish("k", "src", "first")
    bus.publish("k", "src", "second")  # must not raise
    assert len(bus) == 2


# ----------------------------------------------------------- path counters
def test_update_path_counters_eager_then_compiled(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    for _ in range(4):
        metric.update(*ones())
    rep = metric.telemetry_report()
    assert rep.enabled
    # the first occurrence of a signature runs eagerly, the repeats run the compiled step
    assert rep.path_counts == {"eager": 1, "auto_compiled": 3}
    assert rep.total_updates == 4
    assert rep.counter("compiles|kind=auto_update") == 1
    assert rep.counter("trace_seconds") > 0
    # MeanSquaredError is certified R1-clean, so its eager update skips the fingerprint, as in the JAX package
    assert rep.counter("fingerprint|outcome=skip") == 1 and rep.counter("fingerprint|outcome=check") == 0


def test_jit_and_scan_path_counters(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    metric.jit_update(*ones())
    metric.jit_update(*ones())
    metric.scan_update(torch.ones((3, 8)), torch.zeros((3, 8)))
    rep = metric.telemetry_report()
    assert rep.path_counts["jit"] == 2
    assert rep.path_counts["scan"] == 1
    assert rep.counter("scan_steps") == 3
    assert rep.counter("compiles|kind=jit_update") == 1
    assert rep.counter("compiles|kind=scan_update") == 1


def test_compute_cache_hit_counter(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    metric.update(*ones(4))
    metric.compute()
    metric.compute()  # cached
    rep = metric.telemetry_report()
    assert rep.counter("compute_calls|outcome=computed") == 1
    assert rep.counter("compute_calls|outcome=cache_hit") == 1


def test_deferred_violation_counters(telemetry):
    # MeanMetric's NaN check runs as a warn-severity flag inside the compiled step
    metric = aggregation.MeanMetric(nan_strategy="warn", **CPU)
    good = torch.ones(8)
    metric.update(good)  # eager first pass
    metric.update(good)  # compiled step
    bad = torch.tensor([1.0, float("nan"), 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
    metric.update(bad)  # the violation ORs into the device flags
    with pytest.warns(UserWarning, match="surfaced asynchronously"):
        metric.compute()  # the next host sync point surfaces it
    rep = metric.telemetry_report()
    assert rep.counter("deferred_violations|severity=warn") >= 1


def test_latency_reservoirs_sampled(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    for _ in range(5):
        metric.update(*ones())
    metric.compute()
    rep = metric.telemetry_report()
    assert rep.latency["update_eager"]["count"] == 1
    assert rep.latency["update_compiled"]["count"] == 4
    assert rep.latency["compute"]["count"] == 1
    assert rep.latency["update_compiled"]["p50"] > 0
    assert rep.latency["trace"]["count"] == 1  # the step's first run


def test_sampling_rate_bounds_reservoir_growth(telemetry):
    set_telemetry_sampling(4)
    metric = tm.MeanSquaredError(**CPU)
    for _ in range(9):
        metric.update(*ones())
    rep = metric.telemetry_report()
    # counters stay exact; latency samples are 1-in-4 (the step's first run is always timed)
    assert rep.total_updates == 9
    sampled = sum(r["count"] for op, r in rep.latency.items() if r and op != "trace")
    assert sampled <= 3


# ------------------------------------------------------------ kill switches
def test_disabled_records_nothing():
    assert not telemetry_enabled()  # the shipped default
    metric = tm.MeanSquaredError(**CPU)
    metric.update(*ones(4))
    rep = metric.telemetry_report()
    assert rep.counters == {} and not rep.enabled
    assert "_telem" not in metric.__dict__  # no allocation on the disabled path


def test_runtime_toggle_stops_and_resumes_counting(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    metric.update(*ones(4))
    set_telemetry_enabled(False)
    metric.update(*ones(4))
    set_telemetry_enabled(True)
    metric.update(*ones(4))
    assert metric.telemetry_report().total_updates == 2


def test_env_kill_switch_shape():
    from torchmetrics_tpu_torch._observability import state

    assert state.OBS.sample_every >= 1
    with pytest.raises(ValueError):
        set_telemetry_sampling(0)
    # the JAX package's switch names: a deployment's settings carry over
    src = open(state.__file__, encoding="utf-8").read()
    for name in ("TM_TPU_TELEMETRY", "TM_TPU_TRACING", "TM_TPU_PROFILING"):
        assert f'"{name}"' in src


# ---------------------------------------------------------------- registry
def test_registry_retires_collected_metrics(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    metric.update(*ones(4))
    metric.update(*ones(4))
    del metric
    gc.collect()
    agg = REGISTRY.aggregate()
    entry = agg["MeanSquaredError"]
    assert entry["retired_instances"] == 1
    assert entry["counters"]["update_calls|path=eager"] == 1
    assert entry["counters"]["update_calls|path=auto_compiled"] == 1


def test_registry_aggregates_across_instances(telemetry):
    a, b = tm.MeanSquaredError(**CPU), tm.MeanSquaredError(**CPU)
    a.update(*ones(4))
    b.update(*ones(4))
    agg = REGISTRY.aggregate()
    assert agg["MeanSquaredError"]["instances"] == 2
    assert agg["MeanSquaredError"]["counters"]["update_calls|path=eager"] == 2


def test_clone_starts_a_fresh_telemetry_stream(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    metric.update(*ones(4))
    clone = metric.clone()
    assert clone.telemetry_report().counters == {}
    clone.update(*ones(4))
    assert clone.telemetry_report().total_updates == 1
    assert metric.telemetry_report().total_updates == 1


def test_telemetry_stays_out_of_state_dict_device_moves_and_pickles(telemetry):
    """A metric is an ``nn.Module``: its telemetry is a plain attribute, not a buffer, module or parameter."""
    metric = tm.MeanSquaredError(**CPU)
    for _ in range(3):
        metric.update(*ones(4))
    telem = metric.__dict__["_telem"]
    assert "_telem" not in dict(metric.named_buffers()) and "_telem" not in metric._modules
    assert set(metric.state_dict(all_states=True)) == {"sum_squared_error", "total"}
    metric.to("cpu")
    assert metric.__dict__["_telem"] is telem  # a move keeps the stream
    restored = pickle.loads(pickle.dumps(metric))
    assert "_telem" not in restored.__dict__ and "_obs_seen_sigs" not in restored.__dict__
    restored.update(*ones(4))
    assert restored.telemetry_report().total_updates == 1
    assert metric.telemetry_report().total_updates == 3


def test_metrics_held_by_wrappers_and_feature_share_retire_when_collected(telemetry):
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance, KernelInceptionDistance
    from torchmetrics_tpu_torch.wrappers import BootStrapper, FeatureShare, MetricTracker

    class Trunk(torch.nn.Module):
        num_features = 4

        def forward(self, imgs):
            return imgs.reshape(len(imgs), -1)[:, :4].float()

    boot = BootStrapper(tm.MeanSquaredError(**CPU), num_bootstraps=3)
    tracker = MetricTracker(tm.MeanSquaredError(**CPU))
    tracker.increment()
    trunk = Trunk()
    share = FeatureShare([FrechetInceptionDistance(feature=trunk, **CPU),
                          KernelInceptionDistance(feature=trunk, subsets=2, subset_size=4, **CPU)])
    imgs = torch.randint(0, 255, (8, 3, 4, 4), dtype=torch.uint8)
    for _ in range(2):
        boot.update(*ones(4))
        tracker.update(*ones(4))
        share.update(imgs, real=True)
    live = {t.name for t in REGISTRY.telemetries()}
    assert {"MeanSquaredError", "FrechetInceptionDistance", "KernelInceptionDistance"} <= live
    # FeatureShare's members stay eager, and say so on the bus
    assert REGISTRY.aggregate()["FrechetInceptionDistance"]["counters"]["auto_path_disabled"] == 1
    del boot, tracker, share, trunk
    gc.collect()
    assert REGISTRY.telemetries() == []
    agg = REGISTRY.aggregate()
    assert agg["FrechetInceptionDistance"]["retired_instances"] == 1
    assert agg["MeanSquaredError"]["retired_instances"] >= 2


# ----------------------------------------------------------------- exports
def test_prometheus_output_parses_with_standard_parser(telemetry):
    parser = pytest.importorskip("prometheus_client.parser")
    metric = tm.MeanSquaredError(**CPU)
    for _ in range(3):
        metric.update(*ones())
    metric.compute()
    BUS.publish("degradation", "MeanSquaredError", "synthetic")
    text = REGISTRY.render_prometheus()
    families = {f.name: f for f in parser.text_string_to_metric_families(text)}
    assert "tmtpu_update_calls" in families
    samples = {tuple(sorted(s.labels.items())): s.value for s in families["tmtpu_update_calls"].samples}
    assert samples[(("metric", "MeanSquaredError"), ("path", "auto_compiled"))] == 2
    assert samples[(("metric", "MeanSquaredError"), ("path", "eager"))] == 1
    assert "tmtpu_telemetry_enabled" in families
    assert "tmtpu_events" in families
    assert text.endswith("\n")
    for family in families.values():
        assert family.documentation
    latency = families["tmtpu_latency_seconds"]
    assert latency.type == "summary"
    by_suffix_op: dict = {}
    for s in latency.samples:
        by_suffix_op.setdefault((s.name, s.labels.get("op")), []).append(s)
    ops = {op for (_n, op) in by_suffix_op}
    assert "update_eager" in ops and "compute" in ops
    for op in ops:
        quant = by_suffix_op.get(("tmtpu_latency_seconds", op), [])
        assert {s.labels["quantile"] for s in quant} == {"0.5", "0.9", "0.99"}
        (count,) = by_suffix_op[("tmtpu_latency_seconds_count", op)]
        (total,) = by_suffix_op[("tmtpu_latency_seconds_sum", op)]
        assert "quantile" not in count.labels and "quantile" not in total.labels
        assert count.value >= 1 and total.value > 0
    assert "tmtpu_latency_samples" not in families
    assert "tmtpu_latency_sum_seconds" not in families


def test_prometheus_label_escaping(telemetry):
    from torchmetrics_tpu_torch._observability.export import _escape_label

    assert _escape_label('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


def test_json_export_round_trips(telemetry):
    metric = tm.MeanSquaredError(**CPU)
    metric.update(*ones(4))
    BUS.publish("degradation", "MeanSquaredError", "synthetic", data={"kind": "x"})
    payload = REGISTRY.to_json()
    rehydrated = json.loads(json.dumps(payload))
    assert rehydrated == payload
    assert rehydrated["enabled"] is True
    counters = rehydrated["metrics"]["MeanSquaredError"]["counters"]
    assert counters["update_calls|path=eager"] == 1
    (event,) = rehydrated["events"]
    assert event["ts"] > 0 and event["mono"] > 0


def test_event_records_carry_monotonic_timestamps(telemetry):
    import time as _time

    before = _time.monotonic()
    e1 = BUS.publish("k", "src", "first")
    e2 = BUS.publish("k", "src", "second")
    assert before <= e1.mono <= e2.mono <= _time.monotonic()
    assert e1.ts > 0


def test_auto_path_disabled_counter_and_event(telemetry):
    class Counting(tm.Metric):
        def __init__(self):
            super().__init__(**CPU)
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
            self.calls = 0

        def update(self, x):
            self.total += x.sum()
            self.calls += 1

        def compute(self):
            return self.total

    metric = Counting()
    metric.update(torch.ones(3))
    metric.update(torch.ones(3))
    assert metric._auto_disabled and metric.telemetry_report().counter("auto_path_disabled") == 1
    (event,) = BUS.events(kind="auto_path_disabled")
    assert event.source == "Counting" and "unregistered" in event.detail
    assert event.data == {"seam": "metric.update"}
    assert metric.precompile(torch.ones(3))["reason"] == "auto path disabled for this instance"


# --------------------------------------------------------------- collection
def test_collection_telemetry_report_and_aggregation(telemetry):
    mc = MetricCollection({"mse": tm.MeanSquaredError(**CPU), "mae": tm.MeanAbsoluteError(**CPU)}, compute_groups=False)
    for _ in range(3):
        mc.update(*ones())
    reports = mc.telemetry_report()
    assert set(reports) == {"mse", "mae"}
    assert all(rep.total_updates == 3 for rep in reports.values())
    merged = mc.telemetry_report(aggregate=True)
    assert isinstance(merged, TelemetryReport)
    assert merged.total_updates == 6


def test_report_merged_sums_counters():
    a = TelemetryReport(metric="A", enabled=True, counters={"update_calls|path=eager": 2, "x": 1},
                        churn={"warnings": 1, "suppressed": 2})
    b = TelemetryReport(metric="B", enabled=False, counters={"update_calls|path=eager": 3},
                        churn={"warnings": 0, "suppressed": 1})
    merged = TelemetryReport.merged([a, b], name="all")
    assert merged.metric == "all" and merged.enabled
    assert merged.counters == {"update_calls|path=eager": 5, "x": 1}
    assert merged.churn == {"warnings": 1, "suppressed": 3, "last_diff": None}
    assert merged.total_updates == 5


# ------------------------------------------------- the compiled default path
RNG = np.random.default_rng(4321)
N = 32


def _bin():
    return torch.from_numpy(RNG.random(N).astype(np.float32)), torch.from_numpy(RNG.integers(0, 2, N))


def _mc(c=4):
    p = RNG.random((N, c)).astype(np.float32)
    return torch.from_numpy(p / p.sum(1, keepdims=True)), torch.from_numpy(RNG.integers(0, c, N))


def _reg():
    return (torch.from_numpy(RNG.standard_normal(N).astype(np.float32)),
            torch.from_numpy(RNG.standard_normal(N).astype(np.float32)))


def _agg():
    return (torch.from_numpy(RNG.random(N).astype(np.float32)),)


COMPILED_CASES = {
    "MeanMetric": (lambda: aggregation.MeanMetric(**CPU), _agg),
    "MaxMetric": (lambda: aggregation.MaxMetric(**CPU), _agg),
    "BinaryAccuracy": (lambda: tm.classification.BinaryAccuracy(**CPU), _bin),
    "MulticlassAccuracy": (lambda: tm.classification.MulticlassAccuracy(num_classes=4, **CPU), _mc),
    "BinaryStatScores": (lambda: tm.classification.BinaryStatScores(**CPU), _bin),
    "MulticlassConfusionMatrix": (lambda: tm.classification.MulticlassConfusionMatrix(num_classes=4, **CPU), _mc),
    "MeanSquaredError": (lambda: tm.MeanSquaredError(**CPU), _reg),
}

HOST_BOUND_CASES = {
    "BinaryAUROC": (lambda: tm.classification.BinaryAUROC(**CPU), _bin),
    "BinaryPrecisionRecallCurve": (lambda: tm.classification.BinaryPrecisionRecallCurve(**CPU), _bin),
    "MulticlassAUROC": (lambda: tm.classification.MulticlassAUROC(num_classes=4, **CPU), _mc),
}


@pytest.mark.parametrize("name", sorted(COMPILED_CASES))
def test_certified_classes_report_compiled_updates(name, telemetry):
    ctor, maker = COMPILED_CASES[name]
    metric = ctor()
    assert eligibility_verdict(type(metric)) in ("metadata_only", "value_flags")
    batch = maker()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(4):
            metric.update(*batch)
    paths = metric.telemetry_report().path_counts
    assert paths.get("auto_compiled", 0) >= 3, paths
    assert paths.get("eager", 0) == 1  # the signature's warm-up pass


@pytest.mark.parametrize("name", sorted(HOST_BOUND_CASES))
def test_host_bound_classes_report_eager_only(name, telemetry):
    ctor, maker = HOST_BOUND_CASES[name]
    metric = ctor()
    assert eligibility_verdict(type(metric)) == "host_bound"
    batch = maker()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(4):
            metric.update(*batch)
    paths = metric.telemetry_report().path_counts
    assert paths.get("auto_compiled", 0) == 0, paths
    assert paths.get("eager", 0) == 4


def test_sweep_totals_match_update_counts(telemetry):
    """Every update is attributed to exactly one path: no double counting."""
    metric = tm.classification.MulticlassAccuracy(num_classes=4, **CPU)
    batch = _mc()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(6):
            metric.update(*batch)
        metric.jit_update(*batch)
    rep = metric.telemetry_report()
    assert rep.total_updates == 7
    assert rep.total_updates == metric.update_count


# ------------------------------------------------- resilience + durability
def test_quarantine_counter_and_degradation_on_bus(telemetry):
    metric = tm.MeanSquaredError(nan_policy="quarantine", **CPU)
    metric.update(torch.ones(4), torch.zeros(4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric.update(torch.tensor([1.0, float("nan")]), torch.zeros(2))
    rep = metric.telemetry_report()
    assert rep.counter("quarantined_batches") == 1
    assert rep.counter("degradations|kind=nan_quarantine") == 1
    events = BUS.events(kind="degradation", source="MeanSquaredError")
    assert events and events[-1].data["kind"] == "nan_quarantine"


def test_cloned_collection_telemetry_reaches_the_registry(telemetry, tmp_path):
    from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy

    mc = MetricCollection({"mse": tm.MeanSquaredError(**CPU)}, compute_groups=False)
    mgr = SnapshotManager(mc, tmp_path, SnapshotPolicy(every_n_updates=2, async_write=False))
    mc.update(torch.ones(4), torch.zeros(4))  # registers the collection-level telemetry
    mgr.close()
    clone = mc.clone()
    assert clone.__dict__.get("_telem") is None  # not a registry-invisible copy
    mgr2 = SnapshotManager(clone, tmp_path / "clone", SnapshotPolicy(every_n_updates=1, async_write=False))
    clone.update(torch.ones(4), torch.zeros(4))
    clone.update(torch.ones(4), torch.zeros(4))
    mgr2.close()
    agg = REGISTRY.aggregate()["MetricCollection"]
    assert agg["instances"] == 2
    assert agg["counters"]["snapshot_writes"] >= 2


def test_collection_level_snapshot_telemetry_surfaces(telemetry, tmp_path):
    from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy

    mc = MetricCollection({"mse": tm.MeanSquaredError(**CPU)}, compute_groups=False)
    mgr = SnapshotManager(mc, tmp_path, SnapshotPolicy(every_n_updates=2, async_write=False))
    for _ in range(4):
        mc.update(torch.ones(4), torch.zeros(4))
    mgr.close()
    reports = mc.telemetry_report()
    assert reports["__collection__"].counter("snapshot_writes") >= 1
    merged = mc.telemetry_report(aggregate=True)
    assert merged.counter("snapshot_writes") >= 1
    assert merged.counter("journal_entries") >= 1


def test_guarded_sync_attempt_and_retry_counters(telemetry):
    from torchmetrics_tpu_torch._resilience.faultinject import inject_collective_failure, simulated_world
    from torchmetrics_tpu_torch._resilience.policy import RetryPolicy, SyncPolicy

    with simulated_world(2):
        metric = tm.MeanSquaredError(sync_policy=SyncPolicy(retry=RetryPolicy(max_retries=1, backoff_base=0.0)), **CPU)
        metric.update(torch.ones(4), torch.zeros(4))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with inject_collective_failure(first_n=10):
                metric.compute()
    rep = metric.telemetry_report()
    assert rep.counter("sync_calls|mode=guarded") == 1
    assert rep.counter("sync_attempts") == 2
    assert rep.counter("sync_retries") == 1
    assert rep.counter("degradations|kind=handshake_degraded") == 1
    assert BUS.events(kind="degradation")


def test_snapshot_and_restore_counters(telemetry, tmp_path):
    from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy

    metric = tm.MeanSquaredError(**CPU)
    mgr = SnapshotManager(metric, tmp_path, SnapshotPolicy(every_n_updates=2, async_write=False))
    for i in range(5):
        metric.update(torch.ones(4) * i, torch.zeros(4))
    mgr.close()
    rep = metric.telemetry_report()
    assert rep.counter("snapshot_writes") >= 2
    assert rep.counter("snapshot_bytes") > 0
    assert rep.counter("journal_entries") >= 1
    assert rep.counter("journal_bytes") > 0
    assert BUS.events(kind="snapshot_write")
    fresh = tm.MeanSquaredError(**CPU)
    mgr2 = SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False))
    mgr2.restore_latest()
    mgr2.close()
    assert fresh.telemetry_report().counter("restores|outcome=ok") == 1
    restore_events = BUS.events(kind="snapshot_restore")
    assert restore_events and restore_events[-1].data["outcome"] == "ok"
    assert torch.allclose(fresh.compute(), metric.compute())


def test_resilience_counters_export_under_their_families(telemetry, tmp_path):
    """The six families declared for the resilience layer carry its counts in the exposition."""
    from torchmetrics_tpu_torch._observability import export
    from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy
    from torchmetrics_tpu_torch._resilience.faultinject import inject_collective_failure, simulated_world
    from torchmetrics_tpu_torch._resilience.policy import RetryPolicy, SyncPolicy

    metric = tm.MeanSquaredError(nan_policy="quarantine", **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with SnapshotManager(metric, tmp_path, SnapshotPolicy(every_n_updates=1, async_write=False)):
            metric.update(torch.ones(4), torch.zeros(4))
            metric.update(torch.tensor([float("nan")] * 4), torch.zeros(4))
            metric.update(torch.ones(4), torch.zeros(4))
        metric.set_resilience_policy(sync_policy=SyncPolicy(retry=RetryPolicy(max_retries=1, backoff_base=0.0)))
        with simulated_world(2), inject_collective_failure(first_n=1):
            metric.compute()
    text = REGISTRY.render_prometheus()
    for family in ("quarantined_batches", "sync_attempts", "sync_retries", "degradations", "snapshot_writes",
                   "snapshot_bytes"):
        assert export.EXPORT_SCHEMA[family]["kind"] == "counter"
        lines = [line for line in text.splitlines()
                 if line.startswith(f"tmtpu_{family}_total") and 'metric="MeanSquaredError"' in line]
        assert lines and all(float(line.rsplit(" ", 1)[1]) > 0 for line in lines), family
