"""Trace-safety and concurrency static analyzer for torchmetrics_tpu_torch.

Lints every module of the port for compiled-path hazards (R1-R4: a step is
captured into a CUDA graph and replayed) and for thread-safety hazards of
the serving runtime (R7-R9), maintains a baseline of accepted pre-existing
violations, certifies R1-clean classes into a manifest the runtime uses to
skip the per-``update()`` fingerprint guard, and writes the guard map the
``locksan`` runtime sanitizer verifies.

The analyzer parses source with ``ast`` only — scanned modules are never
imported or executed, and this package imports the standard library alone.
Run it as ``python -m torchmetrics_tpu_torch._analysis torchmetrics_tpu_torch/``.
"""

from torchmetrics_tpu_torch._analysis.baseline import (
    BaselineEntry,
    load_baseline,
    split_baselined,
    write_baseline,
)
from torchmetrics_tpu_torch._analysis.concurrency import (
    ModuleConcurrency,
    ThreadSite,
    is_runtime_path,
    thread_safety_to_json,
)
from torchmetrics_tpu_torch._analysis.engine import AnalysisResult, analyze_paths, analyze_source
from torchmetrics_tpu_torch._analysis.manifest import (
    MANIFEST_PATH,
    THREAD_SAFETY_PATH,
    fingerprint_skip_allowed,
    load_manifest,
    load_thread_safety,
    set_fingerprint_skip_enabled,
    write_manifest,
    write_thread_safety,
)
from torchmetrics_tpu_torch._analysis.model import Violation
from torchmetrics_tpu_torch._analysis.rules import RULES, Rule, rule

__all__ = [
    "AnalysisResult",
    "BaselineEntry",
    "MANIFEST_PATH",
    "ModuleConcurrency",
    "RULES",
    "Rule",
    "THREAD_SAFETY_PATH",
    "ThreadSite",
    "Violation",
    "analyze_paths",
    "analyze_source",
    "fingerprint_skip_allowed",
    "is_runtime_path",
    "load_baseline",
    "load_manifest",
    "load_thread_safety",
    "rule",
    "thread_safety_to_json",
    "write_thread_safety",
    "set_fingerprint_skip_enabled",
    "split_baselined",
    "write_baseline",
    "write_manifest",
]
