"""Golden perf manifest: the frozen telemetry export schema.

The runtime's Prometheus/OpenMetrics exposition is an API: dashboards,
alert rules, and the CI perf report all key on family names and label
schemas. :data:`export.EXPORT_SCHEMA` declares that surface in code; this
module freezes it into ``perf_manifest.json`` beside it and diffs the two:
an accidental rename, a dropped family, or a new unbounded label dimension
fails the tests until the manifest is regenerated on purpose
(:func:`write_manifest`).

The file is the port's own copy of the JAX package's
``torchmetrics_tpu/_analysis/perf_manifest.json`` and equals it, so both
packages export one surface; the port reads nothing of the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

from torchmetrics_tpu_torch._observability.export import EXPORT_SCHEMA

__all__ = [
    "MANIFEST_PATH",
    "MANIFEST_VERSION",
    "schema_to_json",
    "load_manifest",
    "write_manifest",
    "check_schema",
]

MANIFEST_PATH = Path(__file__).resolve().with_name("perf_manifest.json")
MANIFEST_VERSION = 1


def schema_to_json() -> Dict[str, Dict[str, Any]]:
    """EXPORT_SCHEMA in the manifest's canonical (sorted, listified) form."""
    return {
        family: {"kind": spec["kind"], "labels": sorted(spec["labels"])}
        for family, spec in sorted(EXPORT_SCHEMA.items())
    }


def load_manifest(path: Path = MANIFEST_PATH) -> Dict[str, Dict[str, Any]]:
    """The checked-in manifest's families; {} when absent/foreign version."""
    try:
        blob = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return {}
    if not isinstance(blob, dict) or blob.get("version") != MANIFEST_VERSION:
        return {}
    families = blob.get("families")
    return families if isinstance(families, dict) else {}


def write_manifest(path: Path = MANIFEST_PATH) -> Dict[str, Any]:
    blob = {"version": MANIFEST_VERSION, "families": schema_to_json()}
    path.write_text(json.dumps(blob, indent=1, sort_keys=True) + "\n", encoding="utf-8")
    return blob


def check_schema(manifest: Dict[str, Dict[str, Any]]) -> List[str]:
    """Problem strings where EXPORT_SCHEMA and the manifest diverge; [] = clean."""
    problems: List[str] = []
    if not manifest:
        return [f"manifest missing or unreadable at {MANIFEST_PATH}"]
    current = schema_to_json()
    for family in sorted(set(current) - set(manifest)):
        problems.append(
            f"family `{family}` is exported but absent from the manifest (new family?)"
        )
    for family in sorted(set(manifest) - set(current)):
        problems.append(
            f"family `{family}` is in the manifest but no longer exported (renamed/removed?)"
        )
    for family in sorted(set(current) & set(manifest)):
        cur, pinned = current[family], manifest[family]
        if cur.get("kind") != pinned.get("kind"):
            problems.append(
                f"family `{family}` kind changed: {pinned.get('kind')!r} -> {cur.get('kind')!r}"
            )
        if list(cur.get("labels", [])) != list(pinned.get("labels", [])):
            problems.append(
                f"family `{family}` label schema changed:"
                f" {pinned.get('labels')!r} -> {cur.get('labels')!r}"
            )
    return problems
