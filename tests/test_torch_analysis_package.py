"""The port's own tree under its lint: zero un-baselined findings, manifests in sync, and parity with the JAX
package's manifests.

The whole of ``torchmetrics_tpu_torch/`` is scanned once for this module
(``_scan``); every test reads a facet of that one result. Any new finding
fails here with the rendered violation: fix the hazard, suppress the line
with ``# lint-ok: <rule> <reason>``, or re-baseline with a justification
(``python -m torchmetrics_tpu_torch._analysis torchmetrics_tpu_torch/
--write-baseline``). The manifests regenerate with ``--write-manifest`` and
``--write-thread-safety``.
"""

import json
import time
from pathlib import Path

import pytest

import torchmetrics_tpu_torch._analysis as port_analysis
from torchmetrics_tpu_torch._analysis import (
    MANIFEST_PATH,
    THREAD_SAFETY_PATH,
    analyze_paths,
    is_runtime_path,
    load_baseline,
    load_manifest,
    split_baselined,
    thread_safety_to_json,
)
from torchmetrics_tpu_torch._analysis.__main__ import DEFAULT_BASELINE as BASELINE
from torchmetrics_tpu_torch._analysis.__main__ import main as lint_main

REPO_ROOT = Path(__file__).resolve().parents[1]
PACKAGE = REPO_ROOT / "torchmetrics_tpu_torch"
JAX_ANALYSIS = REPO_ROOT / "torchmetrics_tpu" / "_analysis"

# CPU seconds (`time.process_time`) of the one shared scan: it measured 5.3-6.6 s on one core of the
# development machine, and wall time under `-n 6` swings with the other workers, so the gate reads the
# scan's own CPU time against three times its measured cost
SCAN_CPU_BUDGET_SECONDS = 20.0

# classes the port certifies R1-clean and the JAX package does not, each with its reason
CERTIFIED_ONLY_IN_THE_PORT = {
    **{
        f"torchmetrics_tpu.classification.{mod}.{cls}": (
            "the JAX package sets `thresholds` in `register_threshold_state`, a method outside `__init__` that its"
            " certifier cannot prove; the port sets it in `__init__`"
        )
        for mod, cls in (
            ("auroc", "BinaryAUROC"),
            ("average_precision", "BinaryAveragePrecision"),
            ("precision_recall_curve", "BinaryPrecisionRecallCurve"),
            ("recall_fixed_precision", "BinaryPrecisionAtFixedRecall"),
            ("recall_fixed_precision", "BinaryRecallAtFixedPrecision"),
            ("roc", "BinaryROC"),
            ("specificity_sensitivity", "BinarySensitivityAtSpecificity"),
            ("specificity_sensitivity", "BinarySpecificityAtSensitivity"),
        )
    },
    "torchmetrics_tpu.classification.calibration_error._AbstractCalibrationError": (
        "a base class of the port's two calibration metrics; the JAX package has no such class"
    ),
}
# classes the JAX package certifies and the port does not: none
CERTIFIED_ONLY_IN_THE_JAX_PACKAGE = {}

# guard-map entries ((module path below the package, class or <global>, field) -> guards) one package has and
# the other lacks, each with its reason
GUARDS_ONLY_IN_THE_PORT = {
    ("_observability/profiling.py", "CostLedger", "_pending"): (
        "CUDA event pairs recorded on the card and not yet resolved: the port times a replay on the card, the JAX"
        " package with perf_counter"
    ),
    ("_aot/cache.py", "<global>", "_CACHES"): (
        "the same table under the same lock in both; the pass reads module globals only in a module that imports"
        " `threading`, which the port's does (for the temporary file's thread id) and the JAX package's does not"
    ),
    ("_compile.py", "<global>", "_STATS"): (
        "the graph counters of the port's compiled path (C11); the JAX package's compiled path has no such module"
    ),
}
GUARDS_ONLY_IN_THE_JAX_PACKAGE = {}

_SCAN_CACHE = None


def _scan():
    """The one full scan of the port's tree, and its CPU seconds."""
    global _SCAN_CACHE
    if _SCAN_CACHE is None:
        t0 = time.process_time()
        result = analyze_paths([str(PACKAGE)])
        _SCAN_CACHE = (result, time.process_time() - t0)
    return _SCAN_CACHE


def _split():
    result, _ = _scan()
    return split_baselined(result.violations, load_baseline(BASELINE), scanned_paths=result.scanned_paths)


def test_package_has_zero_unbaselined_violations():
    result, _ = _scan()
    assert not result.parse_errors, f"analyzer failed to parse: {result.parse_errors}"
    new, _suppressed, stale = _split()
    rendered = "\n".join(v.render() for v in new)
    assert not new, f"{len(new)} un-baselined violations (fix, `# lint-ok:`, or re-baseline):\n{rendered}"
    stale_rendered = "\n".join(f"{e.path} {e.rule} [{e.scope}] {e.snippet}" for e in stale)
    assert not stale, f"{len(stale)} stale baseline entries (prune with --write-baseline):\n{stale_rendered}"


def test_scan_meets_its_cpu_time_budget():
    result, seconds = _scan()
    assert result.files_scanned > 300
    assert seconds < SCAN_CPU_BUDGET_SECONDS, f"full scan took {seconds:.2f} CPU s (budget {SCAN_CPU_BUDGET_SECONDS})"


def test_every_baseline_entry_is_justified():
    entries = load_baseline(BASELINE).values()
    assert entries
    for entry in entries:
        assert entry.justification and "TODO" not in entry.justification, entry
        assert entry.path.startswith("torchmetrics_tpu_torch/"), entry
    # the baseline holds the compiled-path and concurrency rules only
    assert {e.rule for e in entries} <= {"R1", "R2", "R3", "R4", "R7", "R8", "R9"}


def test_the_cli_exits_zero_on_the_ports_tree(monkeypatch, capsys):
    """``python -m torchmetrics_tpu_torch._analysis`` on the whole tree, over this module's one scan."""
    result, _ = _scan()
    monkeypatch.setattr(port_analysis, "analyze_paths", lambda paths: result)
    assert lint_main([]) == 0
    out = capsys.readouterr().out
    assert "0 violations" in out and "0 stale baseline entries" in out
    assert lint_main(["--no-baseline"]) == 1


def test_checked_in_manifest_matches_code():
    result, _ = _scan()
    manifest, current = load_manifest(MANIFEST_PATH), frozenset(result.certified)
    assert manifest == current, (
        "certified.json is out of sync with the analyzer — regenerate with `--write-manifest`."
        f" newly certified: {sorted(current - manifest)[:10]}; no longer certified: {sorted(manifest - current)[:10]}"
    )


def test_manifest_is_nontrivial_and_scoped():
    manifest = load_manifest(MANIFEST_PATH)
    assert len(manifest) >= 150
    assert all(q.startswith("torchmetrics_tpu_torch.") for q in manifest)
    for uncertifiable in (
        "torchmetrics_tpu_torch.wrappers.classwise.ClasswiseWrapper",
        "torchmetrics_tpu_torch.wrappers.running.Running",
        "torchmetrics_tpu_torch.wrappers.minmax.MinMaxMetric",
        "torchmetrics_tpu_torch.metric.CompositionalMetric",
    ):
        assert uncertifiable not in manifest, f"{uncertifiable} has R1 findings and must not be certified"


def test_certificate_parity_with_the_jax_package():
    port = {q.replace("torchmetrics_tpu_torch.", "torchmetrics_tpu.", 1) for q in load_manifest(MANIFEST_PATH)}
    jax = set(json.loads((JAX_ANALYSIS / "certified.json").read_text())["classes"])
    assert port - jax == set(CERTIFIED_ONLY_IN_THE_PORT)
    assert jax - port == set(CERTIFIED_ONLY_IN_THE_JAX_PACKAGE)


def _guards(path, package):
    out = {}
    for mod_path, entry in json.loads(Path(path).read_text())["modules"].items():
        mod = mod_path[len(package) + 1:]
        for cls, cls_entry in (entry.get("classes") or {}).items():
            for field, f in (cls_entry.get("fields") or {}).items():
                out[(mod, cls, field)] = (tuple(f["guards"]), f["verdict"])
        for name, g in (entry.get("globals") or {}).items():
            out[(mod, "<global>", name)] = (tuple(g["guards"]), g["verdict"])
    return out


def test_guard_map_parity_with_the_jax_package():
    """Where both guard maps hold a field, the guards and verdicts agree; the differences are named."""
    port = _guards(THREAD_SAFETY_PATH, "torchmetrics_tpu_torch")
    jax = _guards(JAX_ANALYSIS / "thread_safety.json", "torchmetrics_tpu")
    assert {k: port[k] for k in port.keys() & jax.keys() if port[k] != jax[k]} == {}
    assert set(port) - set(jax) == set(GUARDS_ONLY_IN_THE_PORT)
    assert set(jax) - set(port) == set(GUARDS_ONLY_IN_THE_JAX_PACKAGE)


def test_checked_in_thread_safety_matches_code():
    result, _ = _scan()
    current = thread_safety_to_json(result.thread_safety.values())
    checked_in = json.loads(THREAD_SAFETY_PATH.read_text(encoding="utf-8"))
    changed = sorted(m for m in set(current["modules"]) & set(checked_in["modules"])
                     if current["modules"][m] != checked_in["modules"][m])
    assert current == checked_in, (
        "thread_safety.json is out of sync with the concurrency pass — regenerate with `--write-thread-safety`."
        f" added: {sorted(set(current['modules']) - set(checked_in['modules']))[:5]};"
        f" removed: {sorted(set(checked_in['modules']) - set(current['modules']))[:5]}; changed: {changed[:5]}"
    )


def test_runtime_packages_scan_clean_of_concurrency_rules():
    new, suppressed, _stale = _split()
    conc_new = [v for v in new if v.rule in ("R7", "R8", "R9")]
    assert not conc_new, "un-baselined concurrency findings:\n" + "\n".join(v.render() for v in conc_new)
    # the guard-worker abandonment and the single-writer telemetry contract are baselined, as in the JAX package
    assert any(v.rule == "R9" for v in suppressed) and any(v.rule == "R7" for v in suppressed)


def test_thread_safety_spot_checks():
    modules = json.loads(THREAD_SAFETY_PATH.read_text(encoding="utf-8"))["modules"]
    labeler = modules["torchmetrics_tpu_torch/_streams/telemetry.py"]
    assert labeler["verdict"] == "guarded"
    assert labeler["classes"]["StreamLabeler"]["fields"]["volumes"]["guards"] == ["_lock"]
    guard = modules["torchmetrics_tpu_torch/_resilience/guard.py"]
    assert guard["verdict"] == "baselined_hazards"
    assert guard["globals"]["_workers"]["guards"] == ["_worker_lock"]
    workers = [t for t in guard["threads"] if t["scope"] == "_Worker.__init__"]
    assert workers and workers[0]["daemon"] is True and workers[0]["joined"] is False
    stats = modules["torchmetrics_tpu_torch/_compile.py"]["globals"]["_STATS"]
    assert stats == {"guards": ["_STATS_LOCK"], "verdict": "guarded"}  # C11
    assert all(is_runtime_path(p) for p in modules)


# module families the JAX package's gate holds to zero findings and zero baseline entries, with the guards
# its spot checks pin
_CLEAN_FAMILIES = {
    "tracing_flight_slo": (
        ("_observability/tracing.py", "_observability/flight.py", "_observability/slo.py"), {}),
    "aot": (("_aot/",), {("_aot/cache.py", "AotCache", "_stats"): ["_lock"]}),
    "profiling": (
        ("_observability/profiling.py", "_observability/costs.py", "_observability/manifest.py"),
        {("_observability/profiling.py", "CostLedger", f): ["_lock"]
         for f in ("_costs", "_executables", "_buckets", "_baselines", "_pending")}),
    "serving": (
        ("_serving/",),
        {**{("_serving/runtime.py", "MetricServer", f): ["_pool_lock"]
            for f in ("_warm_outcomes", "batches", "rows_applied", "recoveries")},
         ("_serving/controller.py", "BatchController", "_decisions"): ["_lock"]}),
    "fleet": (
        ("_fleet/",),
        {("_fleet/node.py", "AggregationNode", f): ["_pub_lock"]
         for f in ("_ledger", "_pending_sources", "_pending_epochs", "publish_failures")}),
    "analysis": (("_analysis/",), {}),
}


@pytest.mark.parametrize("family", sorted(_CLEAN_FAMILIES))
def test_module_family_scans_clean_with_no_baseline_entry(family):
    prefixes, pinned = _CLEAN_FAMILIES[family]
    prefixes = tuple(f"torchmetrics_tpu_torch/{p}" for p in prefixes)
    result, _ = _scan()
    assert not [v.render() for v in result.violations if v.path.startswith(prefixes)]
    assert not [e for e in load_baseline(BASELINE).values() if e.path.startswith(prefixes)]
    guards = _guards(THREAD_SAFETY_PATH, "torchmetrics_tpu_torch")
    for key, want in pinned.items():
        assert list(guards[key][0]) == want and guards[key][1] == "guarded", (key, guards.get(key))
    modules = json.loads(THREAD_SAFETY_PATH.read_text(encoding="utf-8"))["modules"]
    for path, entry in modules.items():
        if path.startswith(prefixes):
            assert entry["verdict"] in ("guarded", "no_concurrency"), (path, entry["verdict"])


def test_the_serving_ingest_worker_is_non_daemon_and_joined():
    modules = json.loads(THREAD_SAFETY_PATH.read_text(encoding="utf-8"))["modules"]
    threads = [t for t in modules["torchmetrics_tpu_torch/_serving/runtime.py"]["threads"]
               if t["scope"] == "MetricServer.start"]
    assert threads and threads[0]["daemon"] is False and threads[0]["joined"] is True, threads
