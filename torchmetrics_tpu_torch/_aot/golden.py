"""Golden compile-key manifest for the certified default path (JAX ``_aot/golden.py``).

``torchmetrics_tpu_torch/_compile_golden.json`` pins the exact set of
compiled-step keys the certified default-path sweep (``default_path.py``)
may produce on the CPU. The recompile gate (``tests/test_torch_recompile_gate.py``)
fails any change whose sweep builds a key beyond it, with the differing
component(s) named by the diff the churn warning uses at runtime
(:func:`~torchmetrics_tpu_torch._observability.telemetry.diff_components`).
The keys carry the port's ``devices`` and ``layouts`` components beside the
JAX package's five, so the manifest is the CPU sweep's; it sits beside
``_eligibility.json`` and ``_memory.json``.

Regenerate after an intentional compile-surface change with::

    python -m torchmetrics_tpu_torch._aot golden --write
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["GOLDEN_PATH", "load_golden", "observed_to_json", "write_golden", "check_observed"]

GOLDEN_PATH = Path(__file__).resolve().parents[1] / "_compile_golden.json"
_VERSION = 1
_REGENERATE = "regenerate with `python -m torchmetrics_tpu_torch._aot golden --write`"

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _keyset(entries: List[Dict[str, Any]]) -> Dict[_Key, Dict[str, str]]:
    out: Dict[_Key, Dict[str, str]] = {}
    for entry in entries:
        components = {str(k): str(v) for k, v in entry["components"].items()}
        out[(entry["kind"], tuple(sorted(components.items())))] = components
    return out


def load_golden(path: Optional[Path] = None) -> Dict[str, List[Dict[str, Any]]]:
    blob = json.loads((path or GOLDEN_PATH).read_text(encoding="utf-8"))
    if blob.get("version") != _VERSION:
        raise ValueError(f"unsupported _compile_golden.json version {blob.get('version')}")
    return blob["classes"]


def observed_to_json(observed: Dict[str, List[Dict[str, Any]]]) -> Dict[str, Any]:
    return {
        "version": _VERSION,
        "classes": {
            name: sorted(entries, key=lambda e: (e["kind"], sorted(e["components"].items())))
            for name, entries in sorted(observed.items())
        },
    }


def write_golden(path: Optional[Path] = None) -> Dict[str, Any]:
    """Drive the sweep on the CPU and write the manifest."""
    from torchmetrics_tpu_torch._aot.default_path import drive_default_path

    blob = observed_to_json(drive_default_path(device="cpu"))
    target = path or GOLDEN_PATH
    target.write_text(json.dumps(blob, indent=1, sort_keys=True) + "\n", encoding="utf-8")
    return blob


def check_observed(
    observed: Dict[str, List[Dict[str, Any]]],
    golden: Dict[str, List[Dict[str, Any]]],
) -> List[str]:
    """Compare a sweep against the golden manifest; return the gate's failures.

    A key beyond the manifest is a recompile regression, reported with the
    churn detector naming which component(s) moved relative to the nearest
    golden key of the same kind. A golden key the sweep no longer produces
    (or a class gone) means the manifest is stale and must be regenerated.
    """
    from torchmetrics_tpu_torch._observability.telemetry import diff_components

    problems: List[str] = []
    for name in sorted(set(observed) | set(golden)):
        if name not in golden:
            problems.append(f"{name}: not in the golden manifest — new certified default-path class; {_REGENERATE}")
            continue
        if name not in observed:
            problems.append(
                f"{name}: golden manifest lists it but the sweep no longer drives it — stale manifest; {_REGENERATE}"
            )
            continue
        got = _keyset(observed[name])
        want = _keyset(golden[name])
        for key, components in got.items():
            if key in want:
                continue
            kind = key[0]
            same_kind = [c for (k, _), c in want.items() if k == kind]
            if same_kind:
                changed, diff = diff_components(same_kind[0], components)
                problems.append(
                    f"{name}: NEW `{kind}` compile beyond the golden manifest — changed"
                    f" cache-key component(s): {', '.join(changed) or '?'} ({diff})"
                )
            else:
                problems.append(
                    f"{name}: NEW executable kind `{kind}` on the certified default path (components: {components})"
                )
        for key in want:
            if key not in got:
                problems.append(
                    f"{name}: golden `{key[0]}` key no longer produced by the sweep — stale manifest; {_REGENERATE}"
                )
    return problems
