"""Core data model shared by the analyzer's rule checkers.

``Violation`` is the unit every checker emits; its ``fingerprint`` (path,
rule, scope, normalized source line) is the stable key used by both the
baseline suppression file and inline ``# lint-ok:`` comments, so baselines
survive unrelated line-number churn.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass(frozen=True)
class Violation:
    """One rule hit at one source location."""

    rule: str  # "R1".."R9"
    path: str  # repo-relative posix path
    line: int  # 1-indexed
    scope: str  # "ClassName.method" or module-level function name
    message: str
    snippet: str  # stripped source line (baseline matching key)

    @property
    def fingerprint(self) -> Tuple[str, str, str, str]:
        return (self.path, self.rule, self.scope, self.snippet)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.scope}] {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "scope": self.scope,
            "message": self.message,
            "snippet": self.snippet,
        }


# `# lint-ok: R2, R4 reason...` suppresses the named rules on that line;
# `# lint: eager-helper` on a `def` line exempts the whole function from the
# compiled-path rules (R2/R3/R4) — it declares the body host-eager by design.
# The rule list is matched explicitly (`R<digits>` / `ALL`, comma-separated)
# so a freeform reason can follow without swallowing trailing rule ids.
_LINT_OK_RE = re.compile(r"#\s*lint-ok:\s*((?:R\d+|ALL)(?:\s*,\s*(?:R\d+|ALL))*)")
_EAGER_HELPER_RE = re.compile(r"#\s*lint:\s*eager-helper\b")


@dataclass
class SourceInfo:
    """Per-file source text plus the suppression comments parsed out of it."""

    path: str
    lines: List[str] = field(default_factory=list)
    lint_ok: Dict[int, Set[str]] = field(default_factory=dict)  # line -> rule ids
    eager_helper_lines: Set[int] = field(default_factory=set)

    @classmethod
    def from_source(cls, path: str, source: str) -> "SourceInfo":
        info = cls(path=path, lines=source.splitlines())
        for i, raw in enumerate(info.lines, start=1):
            if "#" not in raw:
                continue
            m = _LINT_OK_RE.search(raw)
            if m:
                info.lint_ok[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
            if _EAGER_HELPER_RE.search(raw):
                info.eager_helper_lines.add(i)
        return info

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, lineno: int, rule_id: str) -> bool:
        rules = self.lint_ok.get(lineno)
        return bool(rules) and (rule_id in rules or "ALL" in rules)

    def is_eager_helper(self, def_lineno: int) -> bool:
        """True when the `def` line (or the line above it) carries the marker."""
        return def_lineno in self.eager_helper_lines or (def_lineno - 1) in self.eager_helper_lines

    def violation(self, rule_id: str, lineno: int, scope: str, message: str) -> Optional[Violation]:
        if self.suppressed(lineno, rule_id):
            return None
        return Violation(
            rule=rule_id,
            path=self.path,
            line=lineno,
            scope=scope,
            message=message,
            snippet=self.line_text(lineno),
        )
