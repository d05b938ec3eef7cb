"""The port's cost ledger, counted costs, exports and manifest on the CPU: the JAX tests, ported.

From ``tests/unittests/observability/test_profiling.py``,
``test_exposition.py`` and ``test_perf_manifest.py``: cost normalization and
the roofline math, the ceilings' resolution order, the ledger's buckets and
gauges, the EWMA+MAD regression detector, the metric seams feeding the
ledger; the classic and OpenMetrics expositions (checked with
``prometheus_client``'s parsers), exemplars, histograms, the export schema;
the frozen manifest; a stream pool's tenant cost apportionment (the
``pool_cost_*`` families from the ledger's ``stream_step`` seam), and the
pool's traffic in the expositions. ``tools/perf_report.py`` waits for the
port's tools (ROADMAP item 7).

Added for the port: the ceilings are the H100's (the figures ``chip_smoke.py``
divides by); a step's cost is counted once, on its first run
(``FlopCounterMode`` for library ops, the kernels' ``*_cost`` functions for
the hand-written ones, bytes from the step's inputs, states and outputs); a
graph replay's device seconds come from a CUDA event pair that the ledger
resolves without waiting on the hot path (here with stand-in events, since
the CPU has none; ``chip_smoke.py``'s ``observability`` phase holds the real
ones against an outer pair).
"""

import json
import re
from pathlib import Path

import pytest
import torch

import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch._observability import (
    BUS,
    REGISTRY,
    Ceilings,
    ExecutableCost,
    extract_cost,
    get_ceilings,
    set_ceilings,
    set_profiling_enabled,
    set_telemetry_enabled,
    set_telemetry_sampling,
    set_tracing_enabled,
)
from torchmetrics_tpu_torch._observability import costs as obs_costs
from torchmetrics_tpu_torch._observability.costs import (
    DEFAULT_HBM_BYTES_PER_S,
    DEFAULT_PEAK_FLOPS,
    count_costs,
    load_measured_ceilings,
    tally_kernel,
    tallying,
)
from torchmetrics_tpu_torch._observability.export import EXPORT_SCHEMA, _escape_label
from torchmetrics_tpu_torch._observability.manifest import (
    MANIFEST_PATH,
    MANIFEST_VERSION,
    check_schema,
    load_manifest,
    schema_to_json,
    write_manifest,
)
from torchmetrics_tpu_torch._observability.profiling import (
    LEDGER,
    SEAM_KINDS,
    CostLedger,
    owner_class,
    profiling_enabled,
    reset_ledger,
)
from torchmetrics_tpu_torch._observability.state import DEFAULT_SAMPLE_EVERY
from torchmetrics_tpu_torch._observability.telemetry import _BUCKET_LABELS, LATENCY_BUCKETS, telemetry_for
from torchmetrics_tpu_torch._observability.tracing import TRACER, trace_context

REPO_ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}


@pytest.fixture()
def profiling():
    """Profiling on, ledger + registry pristine before and after."""
    reset_ledger()
    REGISTRY.reset()
    BUS.clear()
    set_profiling_enabled(True)
    yield LEDGER
    set_profiling_enabled(False)
    set_telemetry_enabled(False)
    reset_ledger()
    REGISTRY.reset()
    BUS.clear()
    set_ceilings(None)


# ------------------------------------------------------------------ cost model
class _FakeCompiled:
    def __init__(self, analysis):
        self._analysis = analysis

    def cost_analysis(self):
        if isinstance(self._analysis, Exception):
            raise self._analysis
        return self._analysis


def test_extract_cost_accepts_dict_and_list_shapes():
    want = ExecutableCost(flops=10.0, bytes_accessed=4.0)
    assert extract_cost(_FakeCompiled({"flops": 10.0, "bytes accessed": 4.0})) == want
    assert extract_cost(_FakeCompiled([{"flops": 10.0, "bytes accessed": 4.0}])) == want


def test_extract_cost_degrades_to_none():
    assert extract_cost(_FakeCompiled(RuntimeError("no analysis"))) is None
    assert extract_cost(_FakeCompiled(None)) is None
    assert extract_cost(_FakeCompiled([])) is None
    assert extract_cost(_FakeCompiled({"flops": 0.0, "bytes accessed": 0.0})) is None
    assert extract_cost(_FakeCompiled({"flops": "garbage"})) is None
    assert extract_cost(object()) is None


def test_roofline_math():
    ceil = Ceilings(peak_flops=100.0, hbm_bytes_per_s=10.0, source="test")
    cost = ExecutableCost(flops=20.0, bytes_accessed=4.0)
    assert cost.arithmetic_intensity == pytest.approx(5.0)
    assert cost.roofline_ceiling(ceil) == pytest.approx(0.5)
    fat = ExecutableCost(flops=1000.0, bytes_accessed=1.0)
    assert fat.roofline_ceiling(ceil) == 1.0
    assert cost.mfu(1.0, ceil) == pytest.approx(0.2)
    assert cost.mfu(0.0, ceil) == 0.0


def test_ceilings_resolution_order(monkeypatch, tmp_path):
    monkeypatch.setenv("TM_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("TM_TPU_HBM_BW", "1e11")
    set_ceilings(None)
    ceil = get_ceilings()
    assert ceil.source == "env"
    assert ceil.peak_flops == pytest.approx(1e12)
    monkeypatch.delenv("TM_TPU_PEAK_FLOPS")
    monkeypatch.delenv("TM_TPU_HBM_BW")
    blob = {"version": 1, "peak_flops": 2e12, "hbm_bytes_per_s": 3e11}
    path = tmp_path / "ceilings.json"
    path.write_text(json.dumps(blob), encoding="utf-8")
    monkeypatch.setenv("TM_TPU_CEILINGS_JSON", str(path))
    set_ceilings(None)
    ceil = get_ceilings()
    assert ceil.source.startswith("measured:")
    assert ceil.peak_flops == pytest.approx(2e12)
    path.write_text("not json", encoding="utf-8")
    set_ceilings(None)
    assert get_ceilings().source == "default"
    set_ceilings(None)


def test_default_ceilings_are_the_h100_figures_chip_smoke_divides_by(monkeypatch):
    """No TPU figure: the port ships no measured-ceilings file, and its defaults are the card's datasheet's."""
    for name in ("TM_TPU_PEAK_FLOPS", "TM_TPU_HBM_BW", "TM_TPU_CEILINGS_JSON"):
        monkeypatch.delenv(name, raising=False)
    set_ceilings(None)
    try:
        assert get_ceilings() == Ceilings(peak_flops=989e12, hbm_bytes_per_s=3.35e12, source="default")
    finally:
        set_ceilings(None)
    assert obs_costs.CEILINGS_PATH is None and load_measured_ceilings() is None
    src = (REPO_ROOT / "chip_smoke.py").read_text(encoding="utf-8")
    peak = float(re.search(r"^BF16_FLOPS_PER_S\s*=\s*([\d.e]+)", src, re.M).group(1))
    hbm = float(re.search(r"^HBM_BYTES_PER_S\s*=\s*([\d.e]+)", src, re.M).group(1))
    assert (peak, hbm) == (DEFAULT_PEAK_FLOPS, DEFAULT_HBM_BYTES_PER_S)


def test_owner_class_parsing():
    assert owner_class("StreamPool[BinaryAccuracy]") == "BinaryAccuracy"
    assert owner_class("CapturedForward[InceptionFeatureExtractor]") == "InceptionFeatureExtractor"
    assert owner_class("torchmetrics_tpu_torch.aggregation.MeanMetric") == "MeanMetric"
    assert owner_class("MeanMetric") == "MeanMetric"


# ---------------------------------------------------------------------- ledger
def test_ledger_buckets_and_attribution(profiling):
    led = profiling
    led.note_executable(owner="m.MeanMetric", kind="auto_update", digest="abc123def456789",
                        cost=ExecutableCost(flops=100.0, bytes_accessed=50.0), compile_seconds=0.5)
    for _ in range(4):
        led.record_step("update_compiled", "MeanMetric", 0.01)
    led.record_step("update_jit", "MeanMetric", 0.02)
    snap = led.snapshot()
    rows = {(r["seam"], r["class"]): r for r in snap["seams"]}
    auto = rows[("update_compiled", "MeanMetric")]
    assert auto["steps"] == 4
    assert auto["device_seconds"] == pytest.approx(0.04)
    assert auto["flops"] == pytest.approx(400.0)
    assert auto["unattributed_steps"] == 0
    jit = rows[("update_jit", "MeanMetric")]
    assert jit["unattributed_steps"] == 1
    assert jit["flops"] == 0.0
    assert snap["executables"]["abc123def456"]["compile_seconds"] == pytest.approx(0.5)
    assert led.total_device_seconds() == pytest.approx(0.06)


def test_ledger_mfu_gauge_closed_form(profiling):
    led = profiling
    set_ceilings(Ceilings(peak_flops=1000.0, hbm_bytes_per_s=100.0, source="test"))
    led.note_executable(owner="m.M", kind="auto_update", digest="d1", cost=ExecutableCost(flops=50.0, bytes_accessed=10.0))
    led.record_step("update_compiled", "M", 0.5)
    entry = led.gauges()["update_compiled|M"]
    assert entry["mfu"] == pytest.approx(0.1)
    assert entry["roofline_ceiling"] == pytest.approx(0.5)
    row = next(r for r in led.snapshot()["seams"] if r["seam"] == "update_compiled")
    assert row["mfu"] == pytest.approx(0.1)
    assert row["roofline_ceiling"] == pytest.approx(0.5)


def test_ledger_executable_cap(profiling):
    for i in range(300):
        profiling.note_executable(owner="m.M", kind="auto_update", digest=f"{i:015d}", cost=None)
    assert len(profiling.snapshot()["executables"]) <= 256


def test_seam_kinds_cover_every_profiled_seam():
    # the JAX package's six, and the trunks' own graphs
    assert set(SEAM_KINDS) == {"update_compiled", "forward_compiled", "update_jit", "update_scan", "spmd_step",
                               "stream_step", "trunk_forward"}


class _Event:
    """A stand-in CUDA timing event: done once ``at`` (ms) is set; ``synchronize`` waits for ``later``."""

    def __init__(self, at=None, later=None):
        self.at, self.later = at, later
        self.synced = 0

    def query(self):
        return self.at is not None

    def synchronize(self):
        self.synced += 1
        if self.at is None:
            self.at = self.later

    def elapsed_time(self, end):
        return end.at - self.at


def _pair(start_ms, end_ms, done=True):
    """A recorded pair; where not ``done`` the card has not reached its end yet."""
    return _Event(at=start_ms), _Event(at=end_ms if done else None, later=end_ms)


def test_event_pairs_resolve_without_waiting_and_in_order(profiling):
    led = CostLedger()
    p1, p2, p3 = _pair(0.0, 2.0), _pair(2.0, 4.5, done=False), _pair(5.0, 9.0, done=False)
    led.record_event_pair("update_compiled", "M", *p1)
    assert len(led._pending) == 0  # its end had completed: resolved at once
    led.record_event_pair("update_compiled", "M", *p2)
    led.record_event_pair("update_compiled", "M", *p3)
    assert len(led._pending) == 2  # p2 not done: p3 waits behind it, nothing is synchronized
    assert p2[1].synced == p3[1].synced == 0
    p3[1].at = 9.0  # the later pair finishes first: order still holds
    p4 = _pair(9.0, 10.0, done=False)
    led.record_event_pair("update_jit", "M", *p4)
    assert len(led._pending) == 3 and p4[1].synced == 0
    # a read of the ledger waits for every pending pair, in order
    snap = led.snapshot()
    assert len(led._pending) == 0 and p2[1].synced == 1 and p4[1].synced == 1
    rows = {(r["seam"], r["class"]): r for r in snap["seams"]}
    assert rows[("update_compiled", "M")]["steps"] == 3
    assert rows[("update_compiled", "M")]["device_seconds"] == pytest.approx((2.0 + 2.5 + 4.0) / 1e3)
    assert rows[("update_jit", "M")]["steps"] == 1
    assert led.total_device_seconds() == pytest.approx(9.5e-3)
    # resolved pairs' events are reused
    reused = led.event_pair()
    assert any(reused[0] is p[0] and reused[1] is p[1] for p in (p1, p2, p3, p4))
    led.record_event_pair("update_compiled", "M", *_pair(0.0, 1.0, done=False))
    led.reset()  # tests and tools: pending pairs go with the rest
    assert len(led._pending) == 0 and led.snapshot()["seams"] == []


def test_event_pairs_feed_the_regression_detector_in_order(profiling):
    set_telemetry_enabled(True)
    led = CostLedger()
    led.warmup, led.sustain = 16, 4
    for i in range(30):
        led.record_event_pair("update_compiled", "M", *_pair(float(i), float(i) + 1.0))
    for i in range(5):
        led.record_event_pair("update_compiled", "M", *_pair(100.0 + i, 150.0 + i, done=False))
    assert not BUS.events(kind="perf_regression")  # nothing resolved yet, nothing waited for
    led.flush()
    (event,) = BUS.events(kind="perf_regression")
    assert event.data["observed_seconds"] == pytest.approx(0.05)


def test_pool_tenant_cost_apportionment(profiling):
    """Each replayed step's seconds (host-timed here; a CUDA event pair on the card) split equally across its rows.

    The JAX test also expects ``pool_cost_flops``: XLA's cost analysis counts
    the elementwise flops of MeanMetric's update. The port counts a step's
    flops with ``FlopCounterMode``, which counts none for elementwise ops, so
    this step claims 0 flops and writes no ``pool_cost_flops`` family; the
    flops split is checked on a step that claims some (a matmul in the update).
    """
    set_telemetry_enabled(True)
    pool = tm.aggregation.MeanMetric(**CPU).to_stream_pool(capacity=8)
    ids = [pool.attach() for _ in range(4)]
    for step in range(6):
        pool.update(ids, torch.ones((4, 3)) * step)
    totals = REGISTRY.counter_totals()
    per_stream = {k.partition("=")[2]: v for k, v in totals.items() if k.startswith("pool_cost_device_seconds|")}
    assert set(per_stream) == {str(s) for s in ids}
    # equal-share apportionment: every tenant in a uniform batch pays the same
    vals = list(per_stream.values())
    assert all(v == pytest.approx(vals[0]) for v in vals)
    # the metered seconds reconcile with the ledger's stream_step bucket (the first step is the build)
    row = next(r for r in LEDGER.snapshot()["seams"] if r["seam"] == "stream_step")
    assert row["steps"] == 5 and row["unattributed_steps"] == 0
    assert sum(vals) == pytest.approx(row["device_seconds"], rel=1e-6)
    assert not [k for k in totals if k.startswith("pool_cost_flops|")]
    # predicted state bytes metered per applied row (MeanMetric has an exact claim: value and weight)
    sbytes = [v for k, v in totals.items() if k.startswith("pool_cost_state_byte_updates|")]
    assert sbytes == [pytest.approx(5 * 8.0)] * 4
    assert owner_class("StreamPool[MeanMetric]") == "MeanMetric"
    assert any(rec["kind"] == "stream_step" for rec in LEDGER.snapshot()["executables"].values())

    class _Projected(tm.Metric):
        """A pooled update with a matmul in it, so its step claims flops."""

        full_state_update = False

        def __init__(self):
            super().__init__(**CPU)
            self.add_state("s", torch.zeros(2), dist_reduce_fx="sum")

        def update(self, x):
            self.s += (x @ torch.ones((3, 2))).sum(0)

        def compute(self):
            return self.s

    proj = _Projected().to_stream_pool(capacity=4, enforce_manifest=False)
    pids = [proj.attach() for _ in range(2)]
    for _ in range(3):
        proj.update(pids, torch.ones((2, 5, 3)))
    cost = LEDGER.cost_for("stream_step", "_Projected")
    assert cost is not None and cost.flops == 2 * 2 * 5 * 3 * 2  # two lanes' (5, 3) @ (3, 2)
    flops = {k: v for k, v in REGISTRY.counter_totals().items() if k.startswith("pool_cost_flops|")}
    assert sorted(flops) == [f"pool_cost_flops|stream={s}" for s in pids]
    assert all(v == pytest.approx(2 * cost.flops / 2) for v in flops.values())  # two steps, two rows each


# ------------------------------------------------------------ anomaly detector
def _fresh_ledger(warmup=16, sustain=4):
    led = CostLedger()
    led.warmup = warmup
    led.sustain = sustain
    return led


def test_regression_triggers_after_sustained_run(profiling):
    set_telemetry_enabled(True)
    led = _fresh_ledger()
    for _ in range(30):
        led.record_step("update_compiled", "M", 0.001)
    BUS.clear()
    led.record_step("update_compiled", "M", 0.05)
    assert not [e for e in BUS.events() if e.kind == "perf_regression"]
    for _ in range(4):
        led.record_step("update_compiled", "M", 0.05)
    events = [e for e in BUS.events() if e.kind == "perf_regression"]
    assert len(events) == 1
    data = events[0].data
    assert data["seam"] == "update_compiled"
    assert data["class"] == "M"
    assert data["observed_seconds"] == pytest.approx(0.05)
    assert data["baseline_seconds"] == pytest.approx(0.001, rel=0.5)
    assert data["threshold_seconds"] < 0.05
    for _ in range(20):
        led.record_step("update_compiled", "M", 0.05)
    assert len([e for e in BUS.events() if e.kind == "perf_regression"]) == 1
    assert led.snapshot()["regressions"] == {"update_compiled": 1}


def test_regression_baseline_frozen_during_high_run(profiling):
    set_telemetry_enabled(True)
    led = _fresh_ledger()
    for _ in range(30):
        led.record_step("update_compiled", "M", 0.001)
    ewma_before = led.snapshot()["baselines"]["update_compiled"]["ewma_seconds"]
    for _ in range(3):
        led.record_step("update_compiled", "M", 0.05)
    ewma_after = led.snapshot()["baselines"]["update_compiled"]["ewma_seconds"]
    assert ewma_after == pytest.approx(ewma_before)


def test_regression_detector_needs_no_warmup_violation(profiling):
    set_telemetry_enabled(True)
    led = _fresh_ledger(warmup=50)
    for i in range(49):
        led.record_step("update_compiled", "M", 0.001 if i % 2 else 10.0)
    assert not [e for e in BUS.events() if e.kind == "perf_regression"]


def test_regression_bus_event_requires_telemetry_switch(profiling):
    set_telemetry_enabled(False)
    assert profiling_enabled()
    led = _fresh_ledger()
    for _ in range(30):
        led.record_step("update_compiled", "M", 0.001)
    for _ in range(10):
        led.record_step("update_compiled", "M", 0.05)
    assert not [e for e in BUS.events() if e.kind == "perf_regression"]
    assert led.snapshot()["regressions"] == {"update_compiled": 1}


# ------------------------------------------------------------------ seam wiring
def test_metric_auto_update_feeds_ledger(profiling):
    from torchmetrics_tpu_torch.aggregation import MeanMetric

    m = MeanMetric(**CPU)
    for i in range(5):
        m.update(torch.ones((4,)) * i)
    snap = LEDGER.snapshot()
    rows = {(r["seam"], r["class"]): r for r in snap["seams"]}
    row = rows[("update_compiled", "MeanMetric")]
    # the first call is eager, the second builds the step (its first run), three more are steps
    assert row["steps"] == 3
    assert row["device_seconds"] > 0
    assert row["unattributed_steps"] == 0  # the step's bytes were counted
    (exe,) = snap["executables"].values()
    assert exe["kind"] == "auto_update" and exe["class"] == "MeanMetric" and exe["source"] == "compiled"
    assert exe["bytes_accessed"] > 0 and exe["compile_seconds"] > 0


class Gram(tm.Metric):
    """``x.T @ x`` summed over batches: one library matmul a step, of known flops."""

    full_state_update = False

    def __init__(self, d):
        super().__init__(**CPU)
        self.add_state("gram", torch.zeros(d, d), dist_reduce_fx="sum")

    def update(self, x):
        self.gram += x.T @ x

    def compute(self):
        return self.gram


@pytest.mark.parametrize("path", ["update", "jit_update", "scan_update"])
def test_counted_step_cost_is_the_closed_form(profiling, path):
    n, d, steps = 6, 5, 3
    metric = Gram(d)
    x = torch.randn(n, d)
    for _ in range(4):
        if path == "scan_update":
            metric.scan_update(torch.stack([x] * steps))
        else:
            getattr(metric, path)(x)
    snap = LEDGER.snapshot()
    (exe,) = snap["executables"].values()
    k = steps if path == "scan_update" else 1
    # FlopCounterMode's matmul count; the input read, the state read and written
    assert exe["flops"] == 2.0 * n * d * d * k
    assert exe["bytes_accessed"] == 4.0 * (n * d * k + 2 * d * d)
    seam = {"update": "update_compiled", "jit_update": "update_jit", "scan_update": "update_scan"}[path]
    (row,) = snap["seams"]
    assert row["seam"] == seam and row["flops"] == exe["flops"] * row["steps"]
    assert row["mfu"] > 0 and row["roofline_ceiling"] <= 1


def test_profiling_off_records_nothing():
    reset_ledger()
    set_profiling_enabled(False)
    from torchmetrics_tpu_torch.aggregation import MeanMetric

    m = MeanMetric(**CPU)
    for i in range(3):
        m.update(torch.ones((4,)) * i)
    assert LEDGER.snapshot()["seams"] == [] and LEDGER.snapshot()["executables"] == {}


def test_kernel_tallies_count_only_inside_a_count():
    assert not tallying()
    tally_kernel(ExecutableCost(flops=1.0, bytes_accessed=1.0))  # no count open: dropped
    with count_costs(torch.ones(4)) as outer:
        assert tallying()
        tally_kernel(ExecutableCost(flops=10.0, bytes_accessed=20.0))
        with count_costs() as inner:
            tally_kernel(ExecutableCost(flops=1.0, bytes_accessed=2.0))
            torch.ones(3, 4) @ torch.ones(4, 2)
    assert not tallying()
    assert (outer.kernel_flops, inner.kernel_flops) == (11.0, 1.0)
    assert outer.library_flops == inner.library_flops == 2.0 * 3 * 4 * 2
    assert outer.cost() == ExecutableCost(flops=11.0 + 48.0, bytes_accessed=16.0)
    with count_costs() as empty:
        pass
    assert empty.cost() is None


def test_the_kernels_cost_functions_return_the_one_cost_type():
    from torchmetrics_tpu_torch import _kernels as K

    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    costs = [
        K.conv_bias_act_cost(meta(2, 8, 5, 5), meta(16, 8, 3, 3), meta(16)),
        K.bias_relu_cost(meta(50, 16), meta(16)),
        K.lpips_head_cost(meta(2, 5, 5, 8), meta(2, 5, 5, 8), meta(8)),
        K.attention_cost(meta(2, 8, 64), meta(2, 8, 64), meta(2, 8, 64), meta(2, 8), num_heads=2),
        K.layernorm_residual_cost(meta(2, 8, 64), meta(2, 8, 64), meta(64), meta(64)),
        K.biquad_bank_cost(2, 23, 1000, 4),
    ]
    assert all(type(c) is ExecutableCost and c.flops > 0 and c.bytes_accessed > 0 for c in costs)
    assert not hasattr(K, "KernelCost")


# ===================================================================== exports
@pytest.fixture()
def full_surface():
    """Telemetry + tracing + profiling on: the widest export surface."""
    reset_ledger()
    REGISTRY.reset()
    BUS.clear()
    TRACER.clear()
    set_telemetry_enabled(True)
    set_telemetry_sampling(1)
    set_tracing_enabled(True)
    set_profiling_enabled(True)
    yield
    set_profiling_enabled(False)
    set_tracing_enabled(False)
    set_telemetry_sampling(DEFAULT_SAMPLE_EVERY)
    set_telemetry_enabled(False)
    TRACER.clear()
    reset_ledger()
    REGISTRY.reset()
    BUS.clear()


def _drive_traffic():
    """Counters, gauges, summaries, histograms, exemplars and ledger rows from a metric and a collection."""
    metric = tm.MeanSquaredError(**CPU)
    mc = tm.MetricCollection({"acc": tm.classification.MulticlassAccuracy(num_classes=3, **CPU),
                              "cm": tm.classification.MulticlassConfusionMatrix(num_classes=3, **CPU)})
    p, t = torch.rand(8, 3), torch.randint(0, 3, (8,))
    with trace_context("exposition-test"):
        for _ in range(4):
            metric.update(torch.ones(8), torch.zeros(8))
            mc.update(p, t)
        metric.compute()
        mc.compute()
    telemetry_for(metric).set_gauge("predicted_state_bytes|scope=replica", 8.0)
    # and a stream pool's tenants (the JAX helper's traffic)
    pool = tm.aggregation.MeanMetric(**CPU).to_stream_pool(capacity=4)
    ids = [pool.attach() for _ in range(2)]
    for step in range(3):
        pool.update(ids, torch.ones((2, 3)) * step)
    BUS.publish("degradation", "MeanSquaredError", "synthetic")
    return metric, mc


_HELP_RE = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* \S.*$")
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|summary|histogram)$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{([a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\""
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\")*)\})?"
    r" (-?(?:[0-9]+(?:\.[0-9]+)?(?:e[+-]?[0-9]+)?|[0-9.]+e[+-]?[0-9]+))$"
)
_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_base(sample_name, declared):
    if sample_name in declared:
        return sample_name
    for suffix in _SUFFIXES:
        if sample_name.endswith(suffix) and sample_name[: -len(suffix)] in declared:
            return sample_name[: -len(suffix)]
    return sample_name


def test_classic_exposition_strict_line_format(full_surface):
    _drive_traffic()
    text = REGISTRY.render_prometheus()
    assert text.endswith("\n") and not text.endswith("\n\n")
    declared, seen_order, current = set(), [], ""
    for line in text.splitlines():
        assert line == line.rstrip()
        if line.startswith("# HELP "):
            assert _HELP_RE.match(line), line
            continue
        if line.startswith("# TYPE "):
            m = _TYPE_RE.match(line)
            assert m, line
            name, kind = m.group(1), m.group(2)
            assert name not in declared
            declared.add(name)
            seen_order.append(name)
            current = name
            if kind == "counter":
                assert name.endswith("_total")
            continue
        m = _SAMPLE_RE.match(line)
        assert m, line
        assert _family_base(m.group(1), declared) == current
    assert seen_order == sorted(seen_order)
    assert "# EOF" not in text and " # {" not in text


def test_classic_parses_and_counter_samples_carry_total(full_surface):
    parser = pytest.importorskip("prometheus_client.parser")
    _drive_traffic()
    families = {f.name: f for f in parser.text_string_to_metric_families(REGISTRY.render_prometheus())}
    assert "tmtpu_profile_device_seconds" in families
    assert families["tmtpu_profiling_enabled"].samples[0].value == 1
    for fam in families.values():
        assert fam.documentation
        for s in fam.samples:
            if fam.type == "counter":
                assert s.name == f"{fam.name}_total"
            assert s.value >= 0 or fam.type == "gauge"


def test_label_escaping_round_trips_through_parser(full_surface):
    parser = pytest.importorskip("prometheus_client.parser")
    hostile = 'he said "hi"\\path\nnewline'
    assert _escape_label(hostile) == 'he said \\"hi\\"\\\\path\\nnewline'
    metric = tm.MeanSquaredError(**CPU)
    metric.update(torch.ones(4), torch.zeros(4))
    telemetry_for(metric).inc(f"degradations|kind={hostile}")
    families = {f.name: f for f in parser.text_string_to_metric_families(REGISTRY.render_prometheus())}
    assert hostile in {s.labels["kind"] for s in families["tmtpu_degradations"].samples if "kind" in s.labels}


def test_openmetrics_ends_with_eof_and_parses(full_surface):
    _drive_traffic()
    text = REGISTRY.render_openmetrics()
    assert text.endswith("# EOF\n") and text.count("# EOF") == 1
    om_parser = pytest.importorskip("prometheus_client.openmetrics.parser")
    families = {f.name: f for f in om_parser.text_string_to_metric_families(text)}
    assert {"tmtpu_update_calls", "tmtpu_latency_hist_seconds", "tmtpu_profile_device_seconds"} <= set(families)
    assert "tmtpu_update_calls_total" not in families
    for s in families["tmtpu_update_calls"].samples:
        assert s.name == "tmtpu_update_calls_total"


def test_openmetrics_exemplars_carry_trace_ids(full_surface):
    _drive_traffic()
    text = REGISTRY.render_openmetrics()
    exemplar_re = re.compile(r"^(tmtpu_latency_hist_seconds_bucket\{[^}]*\}) ([0-9.e+-]+)"
                             r" # \{trace_id=\"([0-9]+)\"\} ([0-9.e+-]+) ([0-9.]+)$")
    matched = [m for m in map(exemplar_re.match, text.splitlines()) if m]
    assert matched
    for m in matched:
        series, _, trace_id, obs_val, ts = m.groups()
        assert int(trace_id) >= 1 and float(obs_val) >= 0.0 and float(ts) > 1.5e9
        le = re.search(r'le="([^"]+)"', series).group(1)
        if le != "+Inf":
            assert float(obs_val) <= float(le)
    for line in text.splitlines():
        if " # {" in line:
            assert "_bucket{" in line
    om_parser = pytest.importorskip("prometheus_client.openmetrics.parser")
    fams = {f.name: f for f in om_parser.text_string_to_metric_families(text)}
    with_ex = [s for s in fams["tmtpu_latency_hist_seconds"].samples if s.exemplar is not None]
    assert with_ex and all(s.exemplar.labels.get("trace_id") for s in with_ex)


def test_classic_drops_exemplars_but_keeps_buckets(full_surface):
    _drive_traffic()
    assert " # {" in REGISTRY.render_openmetrics()
    classic = REGISTRY.render_prometheus()
    assert " # {" not in classic and "tmtpu_latency_hist_seconds_bucket" in classic


def _hist_series(text):
    parser = pytest.importorskip("prometheus_client.parser")
    families = {f.name: f for f in parser.text_string_to_metric_families(text)}
    by_series: dict = {}
    for s in families["tmtpu_latency_hist_seconds"].samples:
        entry = by_series.setdefault((s.labels.get("metric"), s.labels.get("op")), {"buckets": {}})
        if s.name.endswith("_bucket"):
            entry["buckets"][s.labels["le"]] = s.value
        elif s.name.endswith("_count"):
            entry["count"] = s.value
        elif s.name.endswith("_sum"):
            entry["sum"] = s.value
    return by_series


def test_histogram_buckets_cumulative_and_complete(full_surface):
    _drive_traffic()
    by_series = _hist_series(REGISTRY.render_prometheus())
    assert by_series and len(LATENCY_BUCKETS) + 1 == len(_BUCKET_LABELS)
    for key, series in by_series.items():
        assert set(series["buckets"]) == set(_BUCKET_LABELS), key
        ordered = [series["buckets"][le] for le in _BUCKET_LABELS]
        assert ordered == sorted(ordered)
        assert series["buckets"]["+Inf"] == series["count"] >= 1
        assert series["sum"] >= 0


def test_histogram_monotonic_across_scrapes(full_surface):
    metric, _ = _drive_traffic()

    def buckets():
        return {(k, le): v for k, s in _hist_series(REGISTRY.render_prometheus()).items() for le, v in s["buckets"].items()}

    first = buckets()
    with trace_context("second-wave"):
        for _ in range(3):
            metric.update(torch.ones(8), torch.zeros(8))
    second = buckets()
    assert set(first) <= set(second)
    assert all(second[k] >= v for k, v in first.items())


def test_rendered_output_stays_inside_export_schema(full_surface):
    parser = pytest.importorskip("prometheus_client.parser")
    _drive_traffic()
    prefixed = {f"tmtpu_{family}": spec for family, spec in EXPORT_SCHEMA.items()}
    for fam in parser.text_string_to_metric_families(REGISTRY.render_prometheus()):
        assert fam.name in prefixed, fam.name
        spec = prefixed[fam.name]
        assert fam.type == spec["kind"], fam.name
        for s in fam.samples:
            assert not set(s.labels) - set(spec["labels"]), fam.name


def test_schema_kinds_are_valid():
    assert all(spec["kind"] in {"counter", "gauge", "summary", "histogram"} for spec in EXPORT_SCHEMA.values())
    for family, spec in EXPORT_SCHEMA.items():
        assert len(set(spec["labels"])) == len(spec["labels"]), family


def test_json_export_round_trips_with_exemplars_and_profiling(full_surface):
    _drive_traffic()
    blob = json.loads(json.dumps(REGISTRY.to_json()))
    assert blob["version"] == 2
    assert blob["profiling"]["enabled"] and blob["profiling"]["seams"]
    exemplars = {k: v for entry in blob["metrics"].values() for k, v in entry.get("exemplars", {}).items()}
    assert exemplars
    for ex in exemplars.values():
        assert set(ex) == {"value", "ts", "trace_id"} and ex["trace_id"] >= 1


# ==================================================================== manifest
def test_manifest_file_is_checked_in_and_current():
    assert check_schema(load_manifest()) == []


def test_manifest_file_shape():
    blob = json.loads(MANIFEST_PATH.read_text(encoding="utf-8"))
    assert blob["version"] == MANIFEST_VERSION
    assert blob["families"] == schema_to_json()
    fams = list(blob["families"])
    assert fams == sorted(fams)
    for spec in blob["families"].values():
        assert spec["labels"] == sorted(spec["labels"])


def test_write_manifest_reproduces_the_checked_in_file(tmp_path):
    out = tmp_path / "perf_manifest.json"
    write_manifest(out)
    assert out.read_text(encoding="utf-8") == MANIFEST_PATH.read_text(encoding="utf-8")


def test_check_schema_detects_drift():
    manifest = schema_to_json()
    assert check_schema(manifest) == []
    assert check_schema({}) != []
    broken = dict(manifest)
    removed = broken.pop(sorted(broken)[0])
    assert any("absent from the manifest" in p for p in check_schema(broken))
    broken = {**manifest, "zz_ghost": removed}
    assert any("no longer exported" in p for p in check_schema(broken))
    fam = sorted(manifest)[0]
    broken = {**manifest, fam: {**manifest[fam], "kind": "weird"}}
    assert any("kind changed" in p for p in check_schema(broken))
    broken = {**manifest, fam: {**manifest[fam], "labels": ["rogue"]}}
    assert any("label schema changed" in p for p in check_schema(broken))


def test_manifest_covers_every_profiling_family():
    families = load_manifest()
    for expected in ("profiling_enabled", "profile_device_seconds", "profile_flops", "profile_steps",
                     "profile_unattributed_steps", "profile_mfu", "profile_roofline_ceiling", "profile_compile_seconds",
                     "pool_cost_device_seconds", "pool_cost_flops", "pool_cost_state_byte_updates",
                     "latency_hist_seconds"):
        assert families[expected] == {"kind": EXPORT_SCHEMA[expected]["kind"],
                                      "labels": sorted(EXPORT_SCHEMA[expected]["labels"])}
