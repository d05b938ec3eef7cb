"""Certified-clean and thread-safety manifests: the analyzer's feedback loop
into the runtime.

``python -m torchmetrics_tpu_torch._analysis --write-manifest`` records every
class the analyzer proves R1-clean (no unregistered-attribute mutation
anywhere along its static MRO) into ``certified.json``. At runtime,
``Metric._update_impl`` consults :func:`fingerprint_skip_allowed` and skips
the per-``update()`` ``_host_attr_snapshot`` fingerprint for instances whose
entire class chain is certified — the static pass pays for itself as an
eager-path speedup.

The check is deliberately conservative: every class on ``type(self).__mro__``
below the trusted ``Metric`` base must appear in the manifest, so any user
subclass (whose source the analyzer never saw) keeps the runtime guard.

``--write-thread-safety`` records the concurrency pass's per-module verdicts
and guard maps into ``thread_safety.json``; :func:`guard_map` is the flat
view the ``locksan`` runtime sanitizer asserts against.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, Optional

MANIFEST_PATH = Path(__file__).parent / "certified.json"
MANIFEST_VERSION = 1

THREAD_SAFETY_PATH = Path(__file__).parent / "thread_safety.json"

# the trusted base every certified chain bottoms out at
_METRIC_MODULE = "torchmetrics_tpu_torch.metric"

_manifest_cache: Optional[FrozenSet[str]] = None
_class_cache: Dict[type, bool] = {}
# runtime toggle (benchmarks flip it to measure the guard's cost); the env
# var gives operators a kill switch without code changes
_enabled = os.environ.get("TM_TPU_DISABLE_FP_SKIP", "") != "1"

_thread_safety_cache: Optional[Dict[str, object]] = None
_guard_map_cache: Optional[Dict[str, tuple]] = None


def write_manifest(certified: Iterable[str], path: Optional[Path] = None) -> int:
    classes = sorted(set(certified))
    payload = {"version": MANIFEST_VERSION, "rule": "R1", "classes": classes}
    (path or MANIFEST_PATH).write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")
    return len(classes)


def load_manifest(path: Optional[Path] = None) -> FrozenSet[str]:
    global _manifest_cache
    if path is None and _manifest_cache is not None:
        return _manifest_cache
    p = path or MANIFEST_PATH
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
        classes = frozenset(data.get("classes", ()))
    except (OSError, ValueError):
        classes = frozenset()
    if path is None:
        _manifest_cache = classes
    return classes


def set_fingerprint_skip_enabled(flag: bool) -> None:
    """Benchmark/diagnostic toggle; clears the per-class decision cache."""
    global _enabled
    _enabled = bool(flag)
    _class_cache.clear()


def fingerprint_skip_enabled() -> bool:
    return _enabled


def invalidate_cache() -> None:
    global _manifest_cache, _thread_safety_cache, _guard_map_cache
    _manifest_cache = None
    _class_cache.clear()
    _thread_safety_cache = None
    _guard_map_cache = None


def fingerprint_skip_allowed(cls: type) -> bool:
    """True when every class below ``Metric`` on ``cls.__mro__`` is certified
    R1-clean, so ``update()`` provably cannot mutate unregistered attributes
    and the eager fingerprint guard is redundant."""
    if not _enabled:
        return False
    cached = _class_cache.get(cls)
    if cached is not None:
        return cached
    manifest = load_manifest()
    allowed = False
    if manifest:
        allowed = None  # becomes False unless we actually reach Metric
        for c in cls.__mro__:
            if c.__module__ == _METRIC_MODULE and c.__name__ == "Metric":
                allowed = True
                break
            if c.__module__ in ("builtins", "abc", "typing"):
                continue
            if f"{c.__module__}.{c.__qualname__}" not in manifest:
                allowed = False
                break
        allowed = bool(allowed)
    _class_cache[cls] = allowed
    return allowed


def write_thread_safety(payload: Dict[str, object], path: Optional[Path] = None) -> int:
    """Write the concurrency guard-map manifest (see ``concurrency.py``)."""
    (path or THREAD_SAFETY_PATH).write_text(
        json.dumps(payload, indent=2, sort_keys=True) + "\n", encoding="utf-8"
    )
    modules = payload.get("modules", {})
    return len(modules) if isinstance(modules, dict) else 0


def load_thread_safety(path: Optional[Path] = None) -> Dict[str, object]:
    """Raw per-module verdicts + guard maps from the checked-in manifest."""
    global _thread_safety_cache
    if path is None and _thread_safety_cache is not None:
        return _thread_safety_cache
    p = path or THREAD_SAFETY_PATH
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
        modules = data.get("modules", {})
        if not isinstance(modules, dict):
            modules = {}
    except (OSError, ValueError, AttributeError):
        modules = {}
    if path is None:
        _thread_safety_cache = modules
    return modules


def guard_map() -> Dict[str, tuple]:
    """``"ClassName.field" -> (lock attr names...)`` from the manifest.

    The flat view the ``locksan`` runtime sanitizer asserts against: a
    declared-guarded field accessed without its lock held is a discipline
    violation. Keys use bare class names — the serving-runtime classes the
    manifest covers are unique by name, and the sanitizer looks instances
    up by ``type(obj).__name__``.
    """
    global _guard_map_cache
    if _guard_map_cache is not None:
        return _guard_map_cache
    flat: Dict[str, tuple] = {}
    for entry in load_thread_safety().values():
        if not isinstance(entry, dict):
            continue
        for cls_name, cls_entry in (entry.get("classes") or {}).items():
            for fname, fentry in (cls_entry.get("fields") or {}).items():
                guards = tuple(fentry.get("guards") or ())
                if guards and fentry.get("verdict") == "guarded":
                    flat[f"{cls_name}.{fname}"] = guards
    _guard_map_cache = flat
    return flat
