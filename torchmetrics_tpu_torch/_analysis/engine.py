"""Scan driver: walks source trees, builds the registry, runs every rule.

Pure-AST by design — the scan never imports or executes the modules it
checks, so the whole ~300-file package lints in a few seconds with no
import side effects (and without torch). This slice runs R1-R4 and R7-R9;
``eligibility`` and ``memory`` stay empty until the eligibility (R5/R6) and
memory (R10/R11) passes are ported.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from torchmetrics_tpu_torch._analysis import concurrency, hostsync, structural
from torchmetrics_tpu_torch._analysis.model import SourceInfo, Violation
from torchmetrics_tpu_torch._analysis.registry import Registry

# Metric methods whose bodies a compiled step replays (auto-compile / vmap / pool)
TRACED_CLASS_METHODS = ("update", "compute", "_metric", "_traced_value_flags")

# module-level functions in functional/ treated as compiled kernels
_KERNEL_NAME_RE = re.compile(r"(^|_)(update|compute)(_|$)|^_compute_")

_SKIP_DIR_PARTS = {"__pycache__", ".git"}


@dataclass
class AnalysisResult:
    violations: List[Violation] = field(default_factory=list)
    certified: List[str] = field(default_factory=list)  # R1-clean class qualnames
    # compile-eligibility verdicts (qualname -> verdict) for every metric
    # class in a scanned module; empty until the eligibility pass is ported
    eligibility: Dict[str, object] = field(default_factory=dict)
    # concurrency-safety reports (path -> ModuleConcurrency) for every
    # rule-checked module — the thread_safety.json manifest writer and the
    # locksan guard-map loader both read from here
    thread_safety: Dict[str, "concurrency.ModuleConcurrency"] = field(default_factory=dict)
    # memory cost model (qualname -> formula) for every metric class in a
    # scanned module; empty until the memory pass is ported
    memory: Dict[str, object] = field(default_factory=dict)
    # display paths of rule-checked files (context siblings excluded):
    # baseline staleness is only decidable for files that were scanned
    scanned_paths: List[str] = field(default_factory=list)
    files_scanned: int = 0
    classes_seen: int = 0
    parse_errors: List[str] = field(default_factory=list)

    def by_rule(self) -> Dict[str, List[Violation]]:
        out: Dict[str, List[Violation]] = {}
        for v in self.violations:
            out.setdefault(v.rule, []).append(v)
        return out


def iter_py_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_file() and p.suffix == ".py":
            files.append(p)
        elif p.is_dir():
            files.extend(
                f for f in sorted(p.rglob("*.py")) if not (_SKIP_DIR_PARTS & set(f.parts))
            )
    return files


def _package_top(directory: Path) -> Optional[Path]:
    """Topmost package directory containing ``directory`` (walking the
    ``__init__.py`` chain upward), or None when ``directory`` is not a
    package at all."""
    directory = directory.resolve()
    if not (directory / "__init__.py").exists():
        return None
    top = directory
    while top.parent != top and (top.parent / "__init__.py").exists():
        top = top.parent
    return top


def _anchor_parts(directory: Path) -> List[str]:
    """Dotted-prefix parts for a directory: the package chain from the
    topmost ``__init__.py`` ancestor down to ``directory`` (empty for a
    non-package directory)."""
    top = _package_top(directory)
    if top is None:
        return []
    return list(directory.resolve().parts[len(top.resolve().parts) - 1 :])


def module_name_for(path: Path, roots: Sequence[Path]) -> str:
    """Dotted module name for ``path``, anchored at its true package root.

    ``torchmetrics_tpu_torch/regression/mae.py`` maps to
    ``torchmetrics_tpu_torch.regression.mae`` regardless of cwd, of whether the
    scan root is the package, a subpackage, or the file itself: the anchor
    walks the ``__init__.py`` chain up from the file to the topmost package
    directory. Without that fallback, single-file and subpackage scans named
    modules by bare stem, absolute imports between scanned modules failed to
    resolve, and the class rules silently skipped every class whose base
    lives in another module.
    """
    resolved = path.resolve()
    for root in roots:
        try:
            rel = resolved.relative_to(root.resolve())
        except ValueError:
            continue
        parts = list(rel.parts)
        anchor = _anchor_parts(root) if root.is_dir() else []
        if parts[-1] == "__init__.py":
            parts = parts[:-1]
        else:
            parts[-1] = parts[-1][:-3]
        dotted = ".".join(anchor + parts)
        return dotted or (anchor[-1] if anchor else path.stem)
    # no scan root holds the file (single-file scans): anchor on the file's
    # own package chain
    anchor = _anchor_parts(resolved.parent)
    if anchor:
        stem = [] if resolved.name == "__init__.py" else [resolved.stem]
        return ".".join(anchor + stem)
    return path.stem


def _display_path(path: Path, roots: Sequence[Path] = ()) -> str:
    """Stable repo-relative posix path for baseline keys.

    Anchored on the scanned file's topmost package directory first
    (`torchmetrics_tpu_torch/...` no matter where the CLI runs from or which
    subpackage was scanned — baseline fingerprints must match across full,
    subpackage, and single-file scans), then the scan root, then cwd.
    """
    resolved = path.resolve()
    top = _package_top(resolved.parent)
    if top is not None:
        return (Path(top.name) / resolved.relative_to(top)).as_posix()
    for root in roots:
        root_resolved = root.resolve()
        try:
            return (Path(root_resolved.name) / resolved.relative_to(root_resolved)).as_posix()
        except ValueError:
            continue
    for base in (Path.cwd(), *Path.cwd().parents):
        try:
            return resolved.relative_to(base).as_posix()
        except ValueError:
            continue
    return resolved.as_posix()


def _context_files(file_list: Sequence[Path]) -> List[Path]:
    """Package siblings of the scanned files, for registry indexing only.

    A partial scan (single file, subpackage) still needs the *whole* package
    in the registry so base classes defined in unscanned modules resolve —
    otherwise every class whose chain crosses a module boundary fails
    ``is_metric_subclass`` and the class rules silently skip it. Context
    files are parsed and indexed (pass 1) but no rules run on them.
    """
    requested = {p.resolve() for p in file_list}
    tops = {top for p in file_list if (top := _package_top(p.resolve().parent)) is not None}
    out: List[Path] = []
    for top in sorted(tops):
        out.extend(
            f
            for f in sorted(top.rglob("*.py"))
            if not (_SKIP_DIR_PARTS & set(f.parts)) and f.resolve() not in requested
        )
    return out


def analyze_paths(paths: Sequence[str]) -> AnalysisResult:
    result = AnalysisResult()
    registry = Registry()
    sources: Dict[str, SourceInfo] = {}
    modules: List[Tuple[str, Path]] = []

    roots = [Path(p) for p in paths if Path(p).is_dir()]
    file_list = iter_py_files(paths)

    # pass 1: parse + index everything (cross-module base resolution needs
    # the full registry before any rule runs); context files — unscanned
    # package siblings of a partial scan — are indexed but never rule-checked
    for is_context, path in [(False, p) for p in file_list] + [(True, p) for p in _context_files(file_list)]:
        display = _display_path(path, roots)
        try:
            text = path.read_text(encoding="utf-8")
            tree = ast.parse(text)
        except (SyntaxError, UnicodeDecodeError, OSError) as err:
            if not is_context:
                result.parse_errors.append(f"{display}: {err}")
            continue
        module = module_name_for(path, roots)
        source = SourceInfo.from_source(display, text)
        registry.add_module(module, display, tree, source)
        if is_context:
            continue
        sources[module] = source
        modules.append((module, path))
        result.scanned_paths.append(display)
        result.files_scanned += 1

    # pass 2: rules
    for module, path in modules:
        mod = registry.modules[module]
        source = sources[module]
        scan_kernels = ".functional" in f".{module}" or "/functional/" in source.path
        _run_rules_for_module(registry, mod, source, result, scan_kernels=scan_kernels)

    result.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    result.certified.sort()
    return result


def _run_rules_for_module(registry, mod, source, result, scan_kernels: bool) -> None:
    """Rule dispatch for one indexed module — the single copy both
    :func:`analyze_paths` and :func:`analyze_source` drive."""
    # concurrency rules run on every scanned module: they are inert where no
    # threads/locks/shared markers exist, and the per-module report feeds the
    # thread_safety.json manifest for the serving-runtime subset
    conc_violations, conc_report = concurrency.check_module(mod, source)
    result.violations.extend(conc_violations)
    result.thread_safety[mod.path] = conc_report
    for cls in mod.classes.values():
        result.classes_seen += 1
        if registry.is_metric_subclass(cls):
            result.violations.extend(structural.check_r1(cls, registry, source))
            states, _ = registry.registered_states(cls)
            for method_name in TRACED_CLASS_METHODS:
                func = cls.methods.get(method_name)
                if func is None:
                    continue
                result.violations.extend(
                    hostsync.check_traced_function(
                        func, source, f"{cls.name}.{method_name}", states, is_method=True
                    )
                )
            if structural.r1_certifiable(cls, registry):
                result.certified.append(cls.qualname)
    if scan_kernels:
        for name, func in mod.functions.items():
            if _KERNEL_NAME_RE.search(name):
                result.violations.extend(
                    hostsync.check_traced_function(func, source, name, set(), is_method=False)
                )


def analyze_source(text: str, path: str = "<string>", module: Optional[str] = None) -> AnalysisResult:
    """Analyze a single in-memory source blob (test/fixture convenience)."""
    result = AnalysisResult()
    registry = Registry()
    try:
        tree = ast.parse(text)
    except SyntaxError as err:
        result.parse_errors.append(f"{path}: {err}")
        return result
    source = SourceInfo.from_source(path, text)
    mod_name = module or Path(path).stem
    mod = registry.add_module(mod_name, path, tree, source)
    result.scanned_paths.append(path)
    result.files_scanned = 1
    # kernels always scanned here: single-blob callers (tests, fixtures) have
    # no package layout to gate on
    _run_rules_for_module(registry, mod, source, result, scan_kernels=True)
    result.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    result.certified.sort()
    return result
