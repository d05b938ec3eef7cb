"""The port's lint baseline, partial scans and manifests: round trips, staleness, and the CLI's refusals.

Counterparts of the JAX package's ``tests/unittests/analysis/test_baseline.py``
and ``test_partial_scan.py``, over the torch fixtures and a throwaway
package, so no test here pays a scan of the whole port.
"""

import json
import textwrap

import pytest

from torchmetrics_tpu_torch._analysis import (
    analyze_paths,
    analyze_source,
    load_baseline,
    load_manifest,
    split_baselined,
    write_baseline,
    write_manifest,
)
from torchmetrics_tpu_torch._analysis import manifest as manifest_mod
from torchmetrics_tpu_torch._analysis.__main__ import main as lint_main
from tests.test_torch_analysis_rules import FIXTURES


def test_baseline_roundtrip_suppresses_everything(tmp_path):
    result = analyze_paths([str(FIXTURES / "viol_r1.py")])
    assert result.violations
    bl_path = tmp_path / "baseline.json"
    assert write_baseline(result.violations, bl_path, existing={}) == len(result.violations)
    new, suppressed, stale = split_baselined(result.violations, load_baseline(bl_path))
    assert new == [] and len(suppressed) == len(result.violations) and stale == []


def test_edited_line_invalidates_baseline_entry(tmp_path):
    result = analyze_paths([str(FIXTURES / "viol_r1.py")])
    bl_path = tmp_path / "baseline.json"
    write_baseline(result.violations, bl_path, existing={})
    # simulate an edit to one offending line: its snippet no longer matches
    data = json.loads(bl_path.read_text())
    data["entries"][0]["snippet"] = "self.seen_batches = 2  # edited"
    bl_path.write_text(json.dumps(data))
    new, _suppressed, stale = split_baselined(result.violations, load_baseline(bl_path))
    assert len(new) == 1  # the edited line resurfaces as un-baselined
    assert len(stale) == 1  # and its old entry reports stale


def test_write_baseline_preserves_existing_justifications(tmp_path):
    result = analyze_paths([str(FIXTURES / "viol_r1.py")])
    bl_path = tmp_path / "baseline.json"
    write_baseline(result.violations, bl_path, existing={})
    baseline = load_baseline(bl_path)
    fp = next(iter(baseline))
    entry = baseline[fp]
    patched = {**baseline, fp: type(entry)(path=entry.path, rule=entry.rule, scope=entry.scope,
                                           snippet=entry.snippet, justification="reviewed: intentional")}
    write_baseline(result.violations, bl_path, existing=patched)
    assert load_baseline(bl_path)[fp].justification == "reviewed: intentional"


def test_manifest_roundtrip(tmp_path):
    path = tmp_path / "certified.json"
    write_manifest(["pkg.mod.B", "pkg.mod.A", "pkg.mod.A"], path)
    assert load_manifest(path) == frozenset({"pkg.mod.A", "pkg.mod.B"})


@pytest.fixture()
def _clean_manifest_caches():
    yield
    manifest_mod.invalidate_cache()
    manifest_mod.set_fingerprint_skip_enabled(True)


def test_fingerprint_skip_requires_whole_chain(_clean_manifest_caches):
    from torchmetrics_tpu_torch.regression import MeanAbsoluteError

    assert manifest_mod.fingerprint_skip_allowed(MeanAbsoluteError)

    class UserSubclass(MeanAbsoluteError):  # not in the manifest
        pass

    assert not manifest_mod.fingerprint_skip_allowed(UserSubclass)


def test_fingerprint_skip_toggle(_clean_manifest_caches):
    from torchmetrics_tpu_torch.regression import MeanAbsoluteError

    manifest_mod.set_fingerprint_skip_enabled(False)
    assert not manifest_mod.fingerprint_skip_allowed(MeanAbsoluteError)
    manifest_mod.set_fingerprint_skip_enabled(True)
    assert manifest_mod.fingerprint_skip_allowed(MeanAbsoluteError)


# ------------------------------------------------------------------ partial scans
_BASE = '''
import torch
from torchmetrics_tpu_torch.metric import Metric


class Base(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds) -> None:
        self.total = self.total + preds.sum()

    def compute(self):
        return self.total
'''

_CHILD = '''
from pkg_under_test.base import Base


class Child(Base):
    def update(self, preds) -> None:
        self.total = self.total + preds.sum()
        self.leaked_counter = 1  # R1: never registered via add_state

    def compute(self):
        return self.total
'''

_CLEAN_CHILD = '''
from pkg_under_test.base import Base


class CleanChild(Base):
    def update(self, preds) -> None:
        self.total = self.total + preds.sum()

    def compute(self):
        return self.total
'''


def _make_pkg(tmp_path):
    pkg = tmp_path / "pkg_under_test"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "base.py").write_text(textwrap.dedent(_BASE))
    (pkg / "child.py").write_text(textwrap.dedent(_CHILD))
    return pkg


def test_single_file_scan_runs_class_rules(tmp_path):
    """Scanning only child.py resolves Base from the unscanned sibling (context indexing)."""
    pkg = _make_pkg(tmp_path)
    result = analyze_paths([str(pkg / "child.py")])
    assert result.files_scanned == 1  # context siblings are indexed, not scanned
    assert ("R1", "Child.update") in [(v.rule, v.scope) for v in result.violations]
    assert "pkg_under_test.child.Child" not in result.certified


def test_single_file_scan_certifies_clean_cross_module_class(tmp_path):
    pkg = _make_pkg(tmp_path)
    (pkg / "clean_child.py").write_text(textwrap.dedent(_CLEAN_CHILD))
    result = analyze_paths([str(pkg / "clean_child.py")])
    assert result.violations == []
    assert "pkg_under_test.clean_child.CleanChild" in result.certified


def test_subpackage_scan_matches_full_scan_class_findings(tmp_path):
    pkg = _make_pkg(tmp_path)
    sub = {(v.rule, v.scope, v.path) for v in analyze_paths([str(pkg)]).violations}
    single = {(v.rule, v.scope, v.path) for v in analyze_paths([str(pkg / "child.py")]).violations}
    assert single <= sub
    assert all(path.startswith("pkg_under_test/") for _, _, path in sub)


def test_partial_scan_does_not_stale_unscanned_baseline_entries(tmp_path):
    pkg = _make_pkg(tmp_path)
    (pkg / "other.py").write_text(textwrap.dedent(_CHILD).replace("Child", "Other"))
    bl_path = tmp_path / "baseline.json"
    write_baseline(analyze_paths([str(pkg)]).violations, bl_path, existing={})
    result = analyze_paths([str(pkg / "child.py")])
    assert result.scanned_paths == ["pkg_under_test/child.py"]
    _new, suppressed, stale = split_baselined(result.violations, load_baseline(bl_path),
                                              scanned_paths=result.scanned_paths)
    assert suppressed and stale == []


def test_relative_scan_root_inside_package_terminates(tmp_path, monkeypatch):
    pkg = _make_pkg(tmp_path)
    monkeypatch.chdir(pkg)
    result = analyze_paths(["."])
    assert result.files_scanned == 3
    assert ("R1", "Child.update") in [(v.rule, v.scope) for v in result.violations]


_GETATTR_LITERAL = '''
import torch
from torchmetrics_tpu_torch.metric import Metric


class GetattrMutator(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.bag = []

    def update(self, preds) -> None:
        self.total = self.total + preds.sum()
        getattr(self, "bag").append(preds)

    def compute(self):
        return self.total
'''


def test_getattr_literal_receiver_reports_and_uncertifies():
    result = analyze_source(textwrap.dedent(_GETATTR_LITERAL), path="getattr_literal.py")
    r1 = [v for v in result.violations if v.rule == "R1"]
    assert [v.scope for v in r1] == ["GetattrMutator.update"] and "`.append()` on" in r1[0].message
    assert not any(c.endswith("GetattrMutator") for c in result.certified)


def test_getattr_dynamic_receiver_reports_and_uncertifies():
    src = textwrap.dedent(_GETATTR_LITERAL).replace('getattr(self, "bag")', 'getattr(self, "b" + str(preds.ndim))')
    result = analyze_source(src, path="getattr_dynamic.py")
    assert any("dynamic `getattr" in v.message for v in result.violations if v.rule == "R1")
    assert not any(c.endswith("GetattrMutator") for c in result.certified)


def test_registered_state_getattr_receiver_stays_clean():
    clean = textwrap.dedent(_GETATTR_LITERAL).replace("        self.bag = []\n", "").replace(
        'dist_reduce_fx="sum")\n', 'dist_reduce_fx="sum")\n        self.add_state("bag", default=[], dist_reduce_fx="cat")\n', 1
    )
    result = analyze_source(clean, path="getattr_clean.py")
    assert [v for v in result.violations if v.rule == "R1"] == []
    assert any(c.endswith("GetattrMutator") for c in result.certified)


# ------------------------------------------------------------- the CLI's refusals
def test_cli_write_baseline_refuses_partial_scan(tmp_path, capsys):
    pkg = _make_pkg(tmp_path)
    (pkg / "other.py").write_text(textwrap.dedent(_CHILD).replace("Child", "Other"))
    bl_path = tmp_path / "baseline.json"
    assert lint_main([str(pkg), "--baseline", str(bl_path), "--write-baseline"]) == 0
    before = bl_path.read_text()
    assert lint_main([str(pkg / "child.py"), "--baseline", str(bl_path), "--write-baseline"]) == 2
    assert "refusing --write-baseline" in capsys.readouterr().out
    assert bl_path.read_text() == before


def test_cli_write_manifest_refuses_partial_scan(tmp_path, capsys):
    pkg = _make_pkg(tmp_path)
    (pkg / "clean_child.py").write_text(textwrap.dedent(_CLEAN_CHILD))
    out = tmp_path / "certified.json"
    assert lint_main([str(pkg), "--manifest", str(out), "--write-manifest"]) == 0
    assert "pkg_under_test.clean_child.CleanChild" in load_manifest(out)
    assert lint_main([str(pkg / "child.py"), "--manifest", str(out), "--write-manifest"]) == 2
    assert "refusing --write-manifest" in capsys.readouterr().out


def test_cli_exit_status_and_json_report(tmp_path, capsys):
    pkg = _make_pkg(tmp_path)
    bl_path = tmp_path / "baseline.json"
    assert lint_main([str(pkg), "--baseline", str(bl_path)]) == 1  # the R1 in child.py, un-baselined
    capsys.readouterr()
    assert lint_main([str(pkg), "--baseline", str(bl_path), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["rule_counts"]["R1"] == {"new": 1, "baselined": 0}
    assert sorted(report["rule_counts"]) == ["R1", "R2", "R3", "R4", "R7", "R8", "R9"]
    lint_main([str(pkg), "--baseline", str(bl_path), "--write-baseline"])
    assert lint_main([str(pkg), "--baseline", str(bl_path)]) == 0
