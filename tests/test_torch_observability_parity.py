"""The port's runtime telemetry against the JAX package's, on the CPU.

The same call sequences, on the same numpy inputs, run through both packages
with telemetry (and, where it matters, tracing) on. Every counter key and
value must match, except the ``latency_*`` families (host timings) and the
value of ``trace_seconds`` (a jit's trace and compile against a step's
first run; both are positive). The span trees of a metric and of a
collection carry the same names and parents; the export schema and the
frozen manifest are the JAX package's; the same counters render the same
Prometheus and OpenMetrics text; the latency detector raises the same
``perf_regression`` events on the same sequence; the same SLOs over the same
signals give the same health report; a flight dump of an
``auto_path_disabled`` event has the same keys.

Divergences by design (ROADMAP §C), each asserted where it shows:

- an ``auto_path_disabled`` event carries ``data["seam"]`` in the port, so a
  flight dump of it names ``metric.update``; the JAX event has no data and
  its dump's seam falls back to the kind;
- on the CPU both packages count a compiled update under
  ``update_calls|path=auto_compiled``: the port runs the step eagerly there
  (a divergence of its compiled path), and counts it as the JAX package
  counts a replay.
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu._observability as JO
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch._observability as PO
from torchmetrics_tpu._observability import export as jax_export
from torchmetrics_tpu._observability import manifest as jax_manifest
from torchmetrics_tpu_torch._observability import export as port_export
from torchmetrics_tpu_torch._observability import manifest as port_manifest

def _reset(obs):
    obs.set_telemetry_enabled(False)
    obs.set_tracing_enabled(False)
    obs.set_profiling_enabled(False)
    obs.set_telemetry_sampling(16)
    obs.REGISTRY.reset()
    obs.BUS.clear()
    obs.TRACER.clear()
    obs.reset_ledger()
    obs.disarm_flight_recorder()
    obs.set_ceilings(None)
    obs.set_slos(None)


@pytest.fixture()
def both():
    """Telemetry on in both packages, sampling every call; everything back to off after."""
    for obs in (JO, PO):
        _reset(obs)
        obs.set_telemetry_enabled(True)
        obs.set_telemetry_sampling(1)
    yield
    for obs in (JO, PO):
        _reset(obs)


def counters(report):
    return {key: value for key, value in report.counters.items() if not key.startswith("latency_")}


def assert_counters_match(port_report, jax_report):
    got, want = counters(port_report), counters(jax_report)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        if key == "trace_seconds":
            assert got[key] > 0 and want[key] > 0
        else:
            assert got[key] == want[key], (key, got[key], want[key])


def data(seed, n=16, c=5):
    rng = np.random.default_rng(seed)
    return rng.random((n, c)).astype(np.float32), rng.integers(0, c, n), rng.standard_normal((4, n)).astype(np.float32)


def j(x):
    return jnp.asarray(x)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------- counter parity
def test_multiclass_accuracy_counters_match(both):
    """Four updates, two computes, one forward: the counts the JAX package gives on the CPU."""
    p, target, _ = data(0)
    runs = {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        m = pkg.classification.MulticlassAccuracy(num_classes=5, **kw)
        for _ in range(4):
            m.update(conv(p), conv(target))
        m.compute()
        m.compute()
        m(conv(p), conv(target))
        runs[name] = m.telemetry_report()
    assert counters(runs["jax"]) == {**counters(runs["jax"]), **{
        "compiles|kind=auto_forward": 1, "compiles|kind=auto_update": 1, "compute_calls|outcome=computed": 2,
        "compute_calls|outcome=cache_hit": 1, "fingerprint|outcome=check": 1, "update_calls|path=auto_compiled": 4,
        "update_calls|path=eager": 1}}
    assert_counters_match(runs["port"], runs["jax"])
    assert runs["port"].path_counts == runs["jax"].path_counts == {"eager": 1, "auto_compiled": 4}


def test_mean_squared_error_counters_match_with_the_certified_fingerprint_skip(both):
    _, _, reg = data(1)
    runs = {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        m = pkg.MeanSquaredError(**kw)
        for _ in range(4):
            m.update(conv(reg[0]), conv(reg[1]))
        m.compute()
        m(conv(reg[2]), conv(reg[3]))
        m(conv(reg[2]), conv(reg[3]))
        m.compute()
        runs[name] = m.telemetry_report()
    # both analyzers certified MeanSquaredError R1-clean, so both skip the fingerprint
    for run in runs.values():
        assert run.counter("fingerprint|outcome=skip") == 1 and run.counter("fingerprint|outcome=check") == 0
    assert_counters_match(runs["port"], runs["jax"])
    assert runs["port"].counter("update_calls|path=forward_compiled") == 1


def test_collection_with_compute_groups_counters_match(both):
    p, target, _ = data(2)
    reports, groups = {}, {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        mc = pkg.MetricCollection([pkg.classification.MulticlassAccuracy(num_classes=5, **kw),
                                   pkg.classification.MulticlassPrecision(num_classes=5, **kw),
                                   pkg.classification.MulticlassConfusionMatrix(num_classes=5, **kw)])
        for _ in range(3):
            mc.update(conv(p), conv(target))
        mc.compute()
        mc(conv(p), conv(target))
        reports[name] = mc.telemetry_report()
        groups[name] = mc.compute_groups
        reports[name + "_merged"] = mc.telemetry_report(aggregate=True)
    assert groups["port"] == groups["jax"] == {0: ["MulticlassAccuracy", "MulticlassPrecision"],
                                               1: ["MulticlassConfusionMatrix"]}
    assert set(reports["port"]) == set(reports["jax"])
    for member in reports["jax"]:
        assert_counters_match(reports["port"][member], reports["jax"][member])
    assert_counters_match(reports["port_merged"], reports["jax_merged"])
    assert reports["port_merged"].metric == reports["jax_merged"].metric == "MetricCollection"


def test_compositional_metric_counters_match(both):
    """A composition's update is a wrapped update of its own (eager, never compiled); its children count theirs."""
    _, _, reg = data(7)
    runs = {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        mse, mae = pkg.MeanSquaredError(**kw), pkg.MeanAbsoluteError(**kw)
        comp = mse + mae
        for _ in range(3):
            comp.update(conv(reg[0]), conv(reg[1]))
        comp.compute()
        comp(conv(reg[2]), conv(reg[3]))
        runs[name] = [m.telemetry_report() for m in (comp, mse, mae)]
    for got, want in zip(runs["port"], runs["jax"]):
        assert_counters_match(got, want)
    assert runs["port"][0].path_counts == {"eager": 3}


def test_deferred_violation_counters_match(both):
    x = np.arange(1.0, 9.0, dtype=np.float32)
    bad = x.copy()
    bad[1] = np.nan
    runs = {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        m = pkg.aggregation.MeanMetric(nan_strategy="warn", **kw)
        m.update(conv(x))
        m.update(conv(x))
        m.update(conv(bad))  # the warn flag rides the compiled step
        with pytest.warns(UserWarning, match="surfaced asynchronously"):
            m.compute()
        runs[name] = m.telemetry_report()
    assert runs["port"].counter("deferred_violations|severity=warn") == 1
    assert_counters_match(runs["port"], runs["jax"])


def test_jit_scan_and_precompile_counters_match(both):
    _, _, reg = data(3)
    runs, precompiled = {}, {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        m = pkg.MeanSquaredError(**kw)
        m.jit_update(conv(reg[0]), conv(reg[1]))
        m.jit_update(conv(reg[0]), conv(reg[1]))
        m.scan_update(conv(reg[:2]), conv(reg[2:]))
        precompiled[name] = m.precompile(conv(reg[0]), conv(reg[1]))
        runs[name] = m.telemetry_report()
    assert precompiled["port"] == precompiled["jax"] == {"engaged": True, "reason": None}
    assert runs["port"].counter("scan_steps") == 2 and runs["port"].path_counts == {"jit": 2, "scan": 1, "auto_compiled": 1}
    assert_counters_match(runs["port"], runs["jax"])


def test_precompile_reports_point_at_the_telemetry_events(both):
    """A class that cannot compile gives the JAX package's report, which names the telemetry's events."""
    reports = {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        m = pkg.classification.BinaryAUROC(**kw)  # list states: host bound
        reports[name] = m.precompile(conv(np.linspace(0, 1, 8, dtype=np.float32)), conv(np.arange(8) % 2))
    assert reports["port"] == reports["jax"]


def test_signature_overflow_counters_match(both):
    runs = {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        m = pkg.MeanSquaredError(**kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for n in range(1, m._AUTO_MAX_SIGNATURES + 4):
                for _ in range(2):
                    m.update(conv(np.ones(n, np.float32)), conv(np.zeros(n, np.float32)))
        runs[name] = m.telemetry_report()
    rep = runs["port"]
    assert rep.counter("signature_overflow") == 6 and rep.counter("uncompiled_signatures|kind=auto_update") == 3
    assert rep.counter("compiles|kind=auto_update") == 8 and rep.churn["suppressed"] == 9
    assert_counters_match(runs["port"], runs["jax"])
    assert runs["port"].churn == runs["jax"].churn


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_churn_names_the_same_components(both, change):
    runs, events, messages = {}, {}, {}
    for name, pkg, conv, kw in (("port", P, t, {"device": "cpu"}), ("jax", J, j, {})):
        m = pkg.MeanSquaredError(**kw)
        first = (np.ones(4, np.float32), np.zeros(4, np.float32))
        second = (np.ones(6, np.float32), np.zeros(6, np.float32)) if change == "shape" else (
            np.ones(4, np.float32), np.zeros(4, np.float32))
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            m.update(conv(first[0]), conv(first[1]))
            if change == "dtype":
                a = torch.ones(4, dtype=torch.bfloat16) if name == "port" else jnp.ones(4, jnp.bfloat16)
                m.update(a, conv(second[1]))
            else:
                m.update(conv(second[0]), conv(second[1]))
        churn = [w for w in record if w.category.__name__ == "RecompileChurnWarning"]
        assert len(churn) == 1
        messages[name] = str(churn[0].message)
        runs[name] = m.telemetry_report()
        (event,) = (JO if name == "jax" else PO).BUS.events(kind="recompile_churn")
        events[name] = (event.source, event.detail, event.data)
    assert events["port"] == events["jax"]
    assert events["port"][2]["changed"] == (["shapes"] if change == "shape" else ["dtypes"])
    assert runs["port"].churn == runs["jax"].churn
    # the same diff; the advice after it names each package's compile
    assert messages["port"].split(". Every")[0] == messages["jax"].split(". Every")[0]
    assert_counters_match(runs["port"], runs["jax"])


# ----------------------------------------------------------------- span trees
def _shape(nodes):
    return [(n["name"], n["source"], n["attrs"].get("path"), _shape(n["children"])) for n in nodes]


def _trees(obs, root):
    return _shape(obs.span_tree(root.trace_id))


@pytest.fixture()
def tracing():
    for obs in (JO, PO):
        _reset(obs)
        obs.set_tracing_enabled(True)
    yield
    for obs in (JO, PO):
        _reset(obs)


def test_metric_span_tree_matches(tracing):
    p, target, _ = data(4)
    trees = {}
    for name, pkg, obs, conv, kw in (("port", P, PO, t, {"device": "cpu"}), ("jax", J, JO, j, {})):
        m = pkg.classification.MulticlassAccuracy(num_classes=5, **kw)
        with obs.trace_context("eval") as root:
            m.update(conv(p), conv(target))
            m.update(conv(p), conv(target))
            m(conv(p), conv(target))
            m(conv(p), conv(target))
            m.compute()
        trees[name] = _trees(obs, root)
    assert trees["port"] == trees["jax"]
    (eval_tree,) = trees["port"]
    assert [c[0] for c in eval_tree[3]] == ["update", "update", "forward", "forward", "compute"]


def test_collection_span_tree_matches(tracing):
    p, target, _ = data(5)
    trees = {}
    for name, pkg, obs, conv, kw in (("port", P, PO, t, {"device": "cpu"}), ("jax", J, JO, j, {})):
        mc = pkg.MetricCollection({"acc": pkg.classification.MulticlassAccuracy(num_classes=5, **kw),
                                   "cm": pkg.classification.MulticlassConfusionMatrix(num_classes=5, **kw),
                                   "f1": pkg.classification.MulticlassF1Score(num_classes=5, **kw)})
        with obs.trace_context("fanout") as root:
            for _ in range(2):
                mc.update(conv(p), conv(target))
            mc(conv(p), conv(target))
            mc.compute()
        trees[name] = _trees(obs, root)
    assert trees["port"] == trees["jax"]
    (fan,) = trees["port"]
    assert [(c[0], c[1]) for c in fan[3]] == [("update", "MetricCollection")] * 2 + [
        ("forward", "MetricCollection"), ("compute", "MetricCollection")]


# ------------------------------------------------------------ export surface
def test_public_surface_schema_and_manifest_match():
    assert PO.__all__ == JO.__all__ and len(PO.__all__) == 51
    assert port_export.EXPORT_SCHEMA == jax_export.EXPORT_SCHEMA and len(port_export.EXPORT_SCHEMA) == 66
    assert port_export._HELP == jax_export._HELP
    jax_file = jax_manifest.MANIFEST_PATH.read_text(encoding="utf-8")
    assert port_manifest.MANIFEST_PATH.read_text(encoding="utf-8") == jax_file
    assert port_manifest.check_schema(port_manifest.load_manifest()) == []
    assert port_manifest.schema_to_json() == jax_manifest.schema_to_json()


def _same_counters(obs):
    """Counters, gauges, latency samples, bus events and ledger rows, all fixed: no clock reaches the output."""

    class FrechetInceptionDistance:  # a stand-in owner: the registry names telemetry by class
        pass

    class MeanSquaredError:
        pass

    owners = [FrechetInceptionDistance(), MeanSquaredError(), MeanSquaredError()]
    for i, owner in enumerate(owners):
        telem = obs.telemetry_for(owner)
        telem.inc("update_calls|path=eager")
        telem.inc("update_calls|path=auto_compiled", 7 + i)
        telem.inc("compiles|kind=auto_update")
        telem.inc("degradations|kind=quote\"back\\slash")
        telem.inc("trace_seconds", 0.25 * (i + 1))
        telem.set_gauge("predicted_state_bytes|scope=replica", 1024.0 * (i + 1))
        for s in (0.0004, 0.003, 0.2, 3.0, 0.0004 * (i + 1)):
            telem.observe("update_compiled", s)
    obs.BUS.publish("degradation", "MeanSquaredError", "synthetic", data={"kind": "sync_degraded"})
    obs.BUS.publish("auto_path_disabled", "FrechetInceptionDistance", "synthetic")
    obs.set_ceilings(obs.Ceilings(peak_flops=1000.0, hbm_bytes_per_s=100.0, source="test"))
    obs.LEDGER.note_executable(owner="m.MeanSquaredError", kind="auto_update", digest="0123456789abcdef",
                               cost=obs.ExecutableCost(flops=50.0, bytes_accessed=10.0), compile_seconds=0.5)
    for s in (0.5, 0.25):
        obs.LEDGER.record_step("update_compiled", "MeanSquaredError", s)
    obs.LEDGER.record_step("update_jit", "MeanSquaredError", 0.125)
    return owners


def test_same_counters_render_the_same_text(both):
    keep = [_same_counters(obs) for obs in (JO, PO)]
    for obs in (JO, PO):
        obs.set_profiling_enabled(True)
    assert PO.REGISTRY.render_prometheus() == JO.REGISTRY.render_prometheus()
    assert PO.REGISTRY.render_openmetrics() == JO.REGISTRY.render_openmetrics()
    port_json, jax_json = PO.REGISTRY.to_json(), JO.REGISTRY.to_json()
    for blob in (port_json, jax_json):
        seqs = [event.pop("seq") for event in blob["events"]]  # process-wide: it counts earlier tests' events too
        assert seqs == sorted(seqs)
        for event in blob["events"]:
            event.pop("ts"), event.pop("mono")
    assert port_json == jax_json
    del keep


def test_the_detector_raises_the_same_regressions(both):
    """The EWMA+MAD baseline on one synthetic latency sequence: the same perf_regression events, in order."""
    rng = np.random.default_rng(7)
    base = 0.001 + 0.0001 * rng.random(120)
    sequence = list(base[:80]) + [0.05] * 3 + list(base[80:100]) + [0.02] * 12 + list(base[100:]) + [0.5] * 9
    out = {}
    for name, obs in (("port", PO), ("jax", JO)):
        ledger = obs.CostLedger()
        ledger.warmup, ledger.sustain, ledger.cooldown_seconds = 32, 4, 0.0
        for s in sequence:
            ledger.record_step("update_compiled", "MeanMetric", float(s))
        out[name] = ([(e.kind, e.source, e.detail, {k: v for k, v in e.data.items()}) for e in
                      obs.BUS.events(kind="perf_regression")], ledger.snapshot()["baselines"])
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) >= 2


def test_the_same_slos_give_the_same_health_report(both):
    slos = {}
    for name, obs in (("port", PO), ("jax", JO)):

        class MeanMetric:
            pass

        owner = MeanMetric()
        telem = obs.telemetry_for(owner)
        telem.inc("update_calls|path=auto_compiled", 95)
        telem.inc("update_calls|path=eager", 5)
        telem.inc("degradations|kind=sync_degraded", 3)
        telem.inc("sync_calls|mode=guarded", 10)
        for s in (0.001, 0.002, 0.004, 0.08, 0.3):
            telem.observe("update_compiled", s)
        tracker = obs.SloTracker([
            obs.SLO(name="update_p99", op="update_compiled", threshold_ms=50.0, objective=0.9),
            obs.SLO(name="tight", op="update_compiled", threshold_ms=1.5, objective=0.99),
            obs.SLO(name="degradation_budget", bad=("degradations",), total=("sync_calls", "update_calls"),
                    objective=0.999),
            obs.SLO(name="idle", op="never_recorded", threshold_ms=1.0),
        ])
        report = tracker.health_report().to_json()
        for key in ("generated_at", "generated_mono"):
            report.pop(key)
        for status in report["slos"]:
            status["observed"].pop("window_s", None)
        slos[name] = report
        del owner
    assert slos["port"] == slos["jax"]
    assert slos["port"]["healthy"] is False


# ----------------------------------------------------------------- flight dump
def _mutating(pkg, kw):
    class Counting(pkg.Metric):
        """Its update counts calls in a plain attribute: a compiled replay would freeze the count."""

        full_state_update = False

        def __init__(self):
            super().__init__(**kw)
            zeros = torch.zeros(()) if pkg is P else jnp.zeros(())
            self.add_state("total", zeros, dist_reduce_fx="sum")
            self.calls = 0

        def update(self, x):
            self.total = self.total + x.sum()
            self.calls += 1

        def compute(self):
            return self.total

    return Counting()


def test_flight_dump_of_an_auto_path_disabled_event_has_the_same_keys(both, tmp_path):
    dumps = {}
    for name, pkg, obs, conv, kw in (("port", P, PO, t, {"device": "cpu"}), ("jax", J, JO, j, {})):
        obs.set_tracing_enabled(True)
        recorder = obs.arm_flight_recorder(directory=str(tmp_path / name))
        m = _mutating(pkg, kw)
        with obs.trace_context("request"):
            m.update(conv(np.ones(4, np.float32)))
        (event,) = obs.BUS.events(kind="auto_path_disabled")
        assert recorder.dump_count == 0  # not a trigger kind in either package
        dumps[name] = recorder.dump(event)
        (path,) = os.listdir(tmp_path / name)
        assert json.loads((tmp_path / name / path).read_text(encoding="utf-8")) == dumps[name]
        assert m.telemetry_report().counter("auto_path_disabled") == 1
    port, jax = dumps["port"], dumps["jax"]
    assert sorted(port) == sorted(jax) and sorted(port["trigger"]) == sorted(jax["trigger"])
    for key in ("kind", "source", "detail"):
        assert port["trigger"][key] == jax["trigger"][key]
    assert port["trace_attribution"] == jax["trace_attribution"] == "last_completed"
    assert [(r["type"], r.get("name"), r.get("kind")) for r in port["timeline"]] == [
        (r["type"], r.get("name"), r.get("kind")) for r in jax["timeline"]]
    # the divergence by design: the port's event names its seam
    assert port["trigger"]["data"] == {"seam": "metric.update"} and jax["trigger"]["data"] == {}
    assert port["seam"] == "metric.update" and jax["seam"] == "auto_path_disabled"


# --------------------------------------------------------------- switches off
def test_switches_off_make_no_telemetry_and_no_span():
    _reset(PO)
    p, target, reg = data(6)
    mc = P.MetricCollection({"acc": P.classification.MulticlassAccuracy(num_classes=5, device="cpu"),
                             "cm": P.classification.MulticlassConfusionMatrix(num_classes=5, device="cpu")})
    mse = P.MeanSquaredError(device="cpu")
    for _ in range(4):
        mc.update(t(p), t(target))
        mse.update(t(reg[0]), t(reg[1]))
    mc(t(p), t(target))
    mse.jit_update(t(reg[0]), t(reg[1]))
    mc.compute()
    with PO.trace_context("request") as sp:
        mse.compute()
    assert sp is PO.tracing.NULL_SPAN
    members = [m for _, m in mc.items(keep_base=True)] + [mse]
    assert not any("_telem" in m.__dict__ or "_obs_seen_sigs" in m.__dict__ for m in members)
    assert PO.REGISTRY.telemetries() == [] and PO.REGISTRY.aggregate() == {}
    assert PO.TRACER.recorded == 0 and len(PO.BUS) == 0
    assert PO.LEDGER.snapshot()["seams"] == [] and PO.LEDGER.snapshot()["executables"] == {}
    assert mse.telemetry_report().counters == {} and not mse.telemetry_report().enabled
