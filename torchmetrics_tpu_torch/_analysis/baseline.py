"""Baseline suppression file: pre-existing violations that don't block CI.

Entries are keyed by ``(path, rule, scope, snippet)`` — the violation's
fingerprint — so they survive line-number churn but go stale the moment the
offending line is edited (at which point the edit must either fix the hazard
or re-baseline it with a fresh justification). Every entry carries a
one-line human justification; ``--write-baseline`` seeds them with TODOs
that a reviewer is expected to replace.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from torchmetrics_tpu_torch._analysis.model import Violation

BASELINE_VERSION = 1
Fingerprint = Tuple[str, str, str, str]


@dataclass(frozen=True)
class BaselineEntry:
    path: str
    rule: str
    scope: str
    snippet: str
    justification: str

    @property
    def fingerprint(self) -> Fingerprint:
        return (self.path, self.rule, self.scope, self.snippet)


def load_baseline(path: Path) -> Dict[Fingerprint, BaselineEntry]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    entries = {}
    for raw in data.get("entries", []):
        entry = BaselineEntry(
            path=raw["path"],
            rule=raw["rule"],
            scope=raw["scope"],
            snippet=raw["snippet"],
            justification=raw.get("justification", ""),
        )
        entries[entry.fingerprint] = entry
    return entries


def split_baselined(
    violations: Iterable[Violation],
    baseline: Dict[Fingerprint, BaselineEntry],
    scanned_paths: Optional[Iterable[str]] = None,
) -> Tuple[List[Violation], List[Violation], List[BaselineEntry]]:
    """Partition into (new, suppressed) and report stale baseline entries
    whose violation no longer exists (fixed code keeps the file honest).

    ``scanned_paths`` limits staleness to entries whose file was actually
    rule-checked: on a partial (single-file / subpackage) scan, an entry for
    an unscanned file is simply undecided — reporting it stale would invite
    pruning suppressions that are still live.
    """
    new: List[Violation] = []
    suppressed: List[Violation] = []
    hit: set = set()
    for v in violations:
        if v.fingerprint in baseline:
            suppressed.append(v)
            hit.add(v.fingerprint)
        else:
            new.append(v)
    decided = None if scanned_paths is None else set(scanned_paths)
    stale = [
        entry
        for fp, entry in baseline.items()
        if fp not in hit and (decided is None or entry.path in decided)
    ]
    return new, suppressed, stale


def write_baseline(
    violations: Iterable[Violation],
    path: Path,
    existing: Dict[Fingerprint, BaselineEntry],
    default_justification: str = "TODO: justify or fix",
) -> int:
    """(Re)write the baseline to exactly the current violation set, keeping
    justifications already recorded for fingerprints that still exist."""
    seen: set = set()
    entries: List[Dict[str, str]] = []
    for v in sorted(violations, key=lambda v: v.fingerprint):
        if v.fingerprint in seen:
            continue
        seen.add(v.fingerprint)
        prior = existing.get(v.fingerprint)
        entries.append(
            {
                "path": v.path,
                "rule": v.rule,
                "scope": v.scope,
                "snippet": v.snippet,
                "justification": prior.justification if prior else default_justification,
            }
        )
    payload = {"version": BASELINE_VERSION, "entries": entries}
    path.write_text(json.dumps(payload, indent=2, sort_keys=False) + "\n", encoding="utf-8")
    return len(entries)
